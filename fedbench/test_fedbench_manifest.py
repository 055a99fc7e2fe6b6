"""``BENCHMARK.json`` against the benchmark's contract (names, units, keys,
bounds, the run length's budget), every piece it names found by name, a
new piece placed beside the real ones found without an edit, and the
plain reference importing nothing of the program."""
import ast
import json
import os
import re

import pytest

from fedbench import HERE, ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|_dim$|_rank$|experts_per_tok)")


@pytest.fixture(scope="module")
def manifest():
    return spec.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units(manifest):
    assert set(manifest) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = manifest[group]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), group
        for e in entries:
            extra = set(e) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                        "per_layer")
                             else set()), (group, extra)
            assert KEYS[group] <= set(e), (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher"), e["name"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)
    for c in manifest["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in manifest["per_layer"]:
        assert _line(m["layer"])
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_command_paths_and_run_length(manifest):
    paths, cmd = manifest["paths"], manifest["command"]
    assert 1 <= len(paths) <= 16 and 1 <= len(cmd) <= 32
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    for word in cmd:
        assert _line(word) and not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p.rstrip("/") + "/") for p in paths)
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the check's 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_metrics_move_end_to_end_metrics_their_cells_report(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells, (m["name"], cell)
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert any(m["name"] != "setup_s" for m in
                   spec.reported(manifest, cell, False))
        assert spec.reported(manifest, cell, True)


def test_every_named_piece_is_found(manifest):
    cat = spec.Catalog()
    for c in manifest["configs"]:
        cfg = cat.config(c["name"])
        assert c["file"] == f"fedbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"], key
            assert not WIDTH.search(key) or key.endswith("_eps"), key
    for w in manifest["workloads"]:
        cat.traffic(w["traffic"])
        cell = cat.cell(w["name"])
        assert cell["limits"]
    for m in manifest["per_layer"]:
        assert callable(cat.metric(m["name"]).read)


def test_new_pieces_beside_the_real_ones_load_by_name(tmp_path):
    for sub in ("configs", "traffic", "cells", "metrics"):
        (tmp_path / sub).mkdir()
    with open(os.path.join(HERE, "configs", "vit_tiny.json")) as f:
        cfg = dict(json.load(f), name="vit_small")
    (tmp_path / "configs" / "vit_small.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "fedavg.c10.json").write_text(
        json.dumps({"algorithm": "fedavg"}))
    (tmp_path / "cells" / "vit_small.fedavg.c10.json").write_text(
        json.dumps({"limits": {"loss.r1": 1e-6}}))
    (tmp_path / "metrics" / "flush_ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    cat = spec.Catalog([HERE, str(tmp_path)])
    assert cat.config("vit_small")["hidden_size"] == 192
    assert cat.traffic("fedavg.c10")["algorithm"] == "fedavg"
    assert cat.cell("vit_small.fedavg.c10")["limits"] == {"loss.r1": 1e-6}
    assert cat.metric("flush_ms").read(None) == 1.5
    assert cat.config("vit_tiny")["name"] == "vit_tiny"   # the real ones
    assert callable(cat.metric("round_mfu").read)
    with pytest.raises(FileNotFoundError):
        cat.config("vit_huge")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for fname in sorted(os.listdir(ref)):
        if fname.endswith(".py"):
            for mod in _imports(os.path.join(ref, fname)):
                top = mod.split(".")[0]
                assert top in ("__future__", "math", "numpy", "torch",
                               "fedbench"), \
                    (fname, mod)
                if top == "fedbench":
                    assert mod.startswith("fedbench.reference"), (fname, mod)


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(HERE):
        for fname in files:
            if fname.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, fname)):
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                     "repro"), (fname, mod)
