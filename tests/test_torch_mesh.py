"""The port's mesh layer (``repro_torch.sharding``, ``launch.{mesh,specs,
dryrun}``, the multi-rank cohort executors, ``models.param_axes`` and
the MoE's shape-only route) against the JAX package's.

The spec resolvers read only a mesh's axis names and sizes, so the
reference's and the port's take the same stub (a ``shape`` mapping) and
must return the same spec on hypothesis-drawn shapes, logical axes and
mesh sizes.  What needs a process group runs in a subprocess, so that no
test leaves one behind in a pytest worker: the dry-run on a fake 2x4
mesh (the reference test's four combinations, reduced, held to its
intent: four records, collective bytes on the train step, FLOPs
everywhere), its counter on a hand-built product with known bytes, and
2-rank gloo rounds of the ``shard_map`` and ``sharded`` executors against
the one-process ``vmap`` round, and the replicated QR of SOAP's refresh on
2-rank DTensors against the QR of the full tensor.

Tolerances: specs, axes, placements, offsets and counts exact, the QR
FLOPs of SOAP's refresh exactly the stated formula; the 2-rank rounds'
losses bitwise, params within 1e-6 and Theta within 1e-6 relative (a
vmap over 2 clients and one over 4 may block the CPU products otherwise:
tests/test_torch_population.py); the replicated QR bitwise on a gathered
shard and within 1e-5 on a partial product (its all-reduce sums in
another order than the full product).
"""
import json
import math
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jax_configs
from repro.models import model as jax_model
from repro.sharding import partitioning as jax_part
from repro_torch import configs, optim
from repro_torch.launch import dryrun
from repro_torch.models import model, moe
from repro_torch.sharding import partitioning as part

ROOT = pathlib.Path(__file__).resolve().parents[1]
RULES = {"train": "TRAIN_RULES", "serve": "SERVE_RULES",
         "serve_fsdp": "SERVE_FSDP_RULES"}
LOGICAL = ["batch", "client", "embed", "ffn", "qkv", "heads", "kv_heads",
           "head_dim", "vocab", "expert", "seq", "kv_lora", "conv",
           "state", "codebook", "layers", None]


class StubMesh:
    """Axis names and sizes only, as both packages' resolvers read a
    mesh (``mesh.shape``)."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


meshes = st.lists(st.tuples(st.sampled_from(["pod", "data", "model"]),
                            st.sampled_from([1, 2, 4, 16])),
                  min_size=1, max_size=3, unique_by=lambda t: t[0])


# ------------------------------------------------------------ resolvers

@given(dims=st.lists(st.sampled_from([1, 2, 5, 15, 16, 24, 64, 128, 960,
                                      2560]), min_size=1, max_size=4),
       names=st.lists(st.sampled_from(LOGICAL), min_size=4, max_size=4),
       sizes=meshes, rules=st.sampled_from(sorted(RULES)))
@settings(max_examples=80, deadline=None)
def test_resolve_spec_matches_reference(dims, names, sizes, rules):
    mesh = StubMesh(sizes)
    axes = names[:len(dims)]
    want = jax_part.resolve_spec(dims, axes, mesh,
                                 getattr(jax_part, RULES[rules]))
    got = part.resolve_spec(dims, axes, mesh, getattr(part, RULES[rules]))
    assert got == tuple(want)


@given(dims=st.lists(st.sampled_from([1, 2, 3, 16, 32, 64, 960]),
                     min_size=0, max_size=4), sizes=meshes)
@settings(max_examples=60, deadline=None)
def test_greedy_and_client_axis_specs_match_reference(dims, sizes):
    mesh = StubMesh(sizes)
    assert part.greedy_spec(dims, mesh) == tuple(
        jax_part.greedy_spec(dims, mesh))
    for preferred in (("pod", "data"), ("data",), ("expert",)):
        try:
            want = jax_part.client_axis_spec(mesh, preferred)
        except ValueError:
            with pytest.raises(ValueError):
                part.client_axis_spec(mesh, preferred)
            continue
        axes, spec = part.client_axis_spec(mesh, preferred)
        assert (axes, spec) == (want[0], tuple(want[1]))


def test_rules_match_reference():
    for name in RULES.values():
        assert dict(getattr(part, name).rules) == dict(
            getattr(jax_part, name).rules)


@pytest.mark.parametrize("arch", jax_configs.ASSIGNED
                         + ["llama-60m", "llama-130m", "llama-350m"])
def test_param_axes_match_reference(arch):
    """``param_axes`` leaf for leaf on every table (reduced), and the
    params spec tree the two packages resolve from it on a 2x4 mesh."""
    jcfg, cfg = jax_configs.get_reduced(arch), configs.get_reduced(arch)
    want = jax_model.param_axes(jcfg)
    got = model.param_axes(cfg)
    assert got == want
    mesh = StubMesh({"data": 2, "model": 4})
    jspecs = jax_part.shard_params_spec(jax_model.param_shapes(jcfg), want,
                                        mesh, jax_part.TRAIN_RULES)
    specs = part.shard_params_spec(model.param_shapes(cfg), got, mesh,
                                   part.TRAIN_RULES)
    jflat = jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(x) for x in jflat] == list(tree_leaves_specs(specs))


def tree_leaves_specs(tree):
    """Spec tuples in reference leaf order (a spec is itself a tuple)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_specs(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from tree_leaves_specs(v)
    else:
        yield tree


def test_init_boxed_carries_the_axes_and_the_weights():
    cfg = configs.get_reduced("deepseek-v2-236b")
    boxed = model.init_boxed(cfg, torch.Generator().manual_seed(3))
    plain = model.init_params(cfg, torch.Generator().manual_seed(3))
    from repro_torch.models.layers import axes_of, unbox
    from repro_torch.utils.tree import tree_leaves
    assert axes_of(boxed) == model.param_axes(cfg)
    for a, b in zip(tree_leaves(unbox(boxed)), tree_leaves(plain)):
        assert torch.equal(a, b)


class Names:
    def __init__(self, *names):
        self.mesh_dim_names = names


def test_spec_to_placements_keeps_pod_major_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Names("pod", "data", "model")
    assert part.spec_to_placements((("pod", "data"), None, "model"),
                                   mesh) == (Shard(0), Shard(0), Shard(2))
    assert part.spec_to_placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert part.spec_to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        part.spec_to_placements((("data", "pod"),), mesh)
    # DTensor's offsets of the four (pod, data) shards of an 8-row dim:
    # pod-major, as the reference's P(("pod", "data"))
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset as local_and_offset)
    pl = part.spec_to_placements((("pod", "data"),), mesh)
    assert [local_and_offset((8,), (2, 2, 2), [p, d, 0], pl)[1][0]
            for p in range(2) for d in range(2)] == [0, 2, 4, 6]


# ------------------------------------------------------------ the MoE route

def test_moe_shape_only_route_only_for_fake_tensors(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_reduced("mixtral-8x22b").replace(dtype="float32")
    p = model.init_params(cfg, torch.Generator().manual_seed(0))
    mp = p["blocks"][0]["moe"]
    layer = {k: v[0] for k, v in mp.items()}
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    calls = []
    even = moe._even_sizes
    monkeypatch.setattr(moe, "_even_sizes",
                        lambda *a: calls.append(a) or even(*a))
    moe.moe_forward(layer, x, cfg)
    assert calls == []                     # a real tensor reads its routing
    with FakeTensorMode(allow_non_fake_inputs=True):
        y, _ = moe.moe_forward(layer, torch.empty(2, 5, cfg.d_model), cfg)
    assert y.shape == (2, 5, cfg.d_model)
    t_k = 2 * 5 * cfg.moe.top_k
    assert calls == [(t_k, cfg.moe.num_experts)]
    sizes = even(t_k, cfg.moe.num_experts)
    assert int(sizes.sum()) == t_k and int(sizes.max() - sizes.min()) <= 1


# ------------------------------------------------------------ SOAP state dtype

def test_soap_state_dtype_keeps_factors_in_it():
    opt = optim.make("soap", state_dtype=torch.bfloat16)
    p = {"w": torch.randn(12, 10), "b": torch.randn(10)}
    st = opt.init(p)
    assert {k: v.dtype for k, v in st["mat"]["w"].items()} == {
        "L": torch.bfloat16, "QL": torch.bfloat16, "R": torch.bfloat16,
        "QR": torch.bfloat16, "M": torch.float32, "V": torch.float32}
    assert st["am"]["b"].dtype == torch.float32
    theta = opt.get_precond(st)
    assert theta["LR"]["w"]["L"].dtype == torch.bfloat16
    st2 = opt.set_precond(st, {"LR": {"w": {
        "L": torch.eye(12), "R": torch.eye(10)}, "b": None}})
    assert st2["mat"]["w"]["L"].dtype == torch.bfloat16
    d, st3 = opt.update({"w": torch.randn(12, 10), "b": torch.randn(10)}, st2,
                        p, 0)
    assert st3["mat"]["w"]["QL"].dtype == torch.bfloat16
    assert d["w"].dtype == torch.float32 and torch.all(torch.isfinite(d["w"]))


# ------------------------------------------------------------ dry-run

def test_collective_parser_matches_reference():
    from repro.launch.dryrun import collective_bytes_from_hlo as want_fn
    hlo = """
      %ag = bf16[2,64]{1,0} all-gather(%x), replica_groups={}
      %ar = f32[128]{0} all-reduce(%y), to_apply=%sum
      %rs = f32[4,8]{1,0} reduce-scatter-start(%z)
      %noise = f32[4]{0} add(%a, %b)
    """
    total, per = dryrun.collective_bytes_from_hlo(hlo)
    assert (total, per) == want_fn(hlo)
    assert per["all-gather"] == 2 * 64 * 2
    assert total == 2 * 64 * 2 + 128 * 4 + 4 * 8 * 4


def _run(script, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(script)], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):]), proc.stdout


DRYRUN = """
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import InputShape
    from repro_torch import optim
    from repro_torch.utils.tree import tree_flatten_with_path

    out = {}
    with dryrun.fake_process_group(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        for arch, shape_name, kind in [
            ("smollm-360m", "train_4k", "train"),
            ("mixtral-8x22b", "decode_32k", "decode"),
            ("falcon-mamba-7b", "long_500k", "decode"),
            ("qwen2-vl-7b", "prefill_32k", "prefill"),
        ]:
            cfg = configs.get_reduced(arch)
            shape = InputShape(shape_name, 64, 8, kind)
            _, _, low = dryrun.build_lowering(
                arch, shape_name, mesh, cfg=cfg, shape_override=shape)
            rec = dryrun.analyze(arch, shape_name, "pod", low, cfg, shape)
            out[f"{arch}:{shape_name}"] = {
                k: rec[k] for k in ("hlo_flops", "rank_flops",
                                    "collective_bytes", "collective_per_op",
                                    "dominant")}
        # the counter on a product with known bytes: a (64,1024) batch-
        # sharded activation @ a (1024,4096) 2-D sharded weight
        fm = FakeTensorMode()
        with fm:
            a = specs._sds((64, 1024), torch.float32, mesh, ("data",))
            b = specs._sds((1024, 4096), torch.float32, mesh,
                           ("data", "model"))
            c = specs._sds((1024, 4096), torch.float32, mesh, ())
        low = dryrun.Lowering(lambda a, b: a @ b, (a, b), fm, mesh)
        _, mode = low.run()
        out["matmul"] = {"collective": mode.collective,
                         "counts": sum(mode.get_comm_counts().values()),
                         "flops": mode.flops.get_total_flops(),
                         "whole": low.run_whole().flops.get_total_flops()}
        # the same product with the weight replicated: every rank runs
        # its batch shard against the whole weight
        low = dryrun.Lowering(lambda a, c: a @ c, (a, c), fm, mesh)
        out["replicated"] = {
            "flops": low.run()[1].flops.get_total_flops(),
            "whole": low.run_whole().flops.get_total_flops()}
        # the federated round at the reference's defaults (8 clients x 2
        # steps; SOAP at bf16 state, its step-0 refresh through the
        # replicated QR), its clients in a loop on the DTensors
        cfg = configs.get_reduced("smollm-360m")
        shape = InputShape("train_4k", 64, 32, "train")
        _, _, low = dryrun.build_lowering(
            "smollm-360m", "train_4k", mesh, cfg=cfg, shape_override=shape,
            step_kind="fed_round", opt_name="soap")
        rec = dryrun.analyze("smollm-360m", "train_4k", "pod", low, cfg,
                             shape)
        out["fed_round"] = {k: rec[k] for k in (
            "hlo_flops", "rank_flops", "collective_bytes", "dominant")}
        # SOAP's train step at step 0 (the record's: the refresh) and 1
        _, _, low = dryrun.build_lowering(
            "smollm-360m", "train_4k", mesh, cfg=cfg, shape_override=shape,
            opt_name="soap")
        flops = {}
        for step in (0, 1):
            low.args = (*low.args[:4], step)
            flops[step] = low.run_whole().flops.get_total_flops()
        state = optim.make("soap").init(specs._meta(low.args[0]))["mat"]
        sides = [tuple(x.shape) for path, x in
                 tree_flatten_with_path(state) if path[-1] in ("L", "R")]
        out["soap_refresh"] = {"flops": flops, "sides": sides,
                               "qr": [dryrun.qr_flops(s) for s in sides]}
    with dryrun.fake_process_group(256):
        mesh = make_production_mesh()
        out["production"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
    out["skip_rc"] = dryrun.main(["--arch", "smollm-360m", "--shape",
                                  "long_500k", "--lower-only"])
    # the CLI's fed_round on the reduced table, at 2 clients x 1 step for
    # time (the defaults' round runs on the 2x4 mesh above)
    import functools, tempfile
    full = configs.get_config
    configs.get_config = lambda name: configs.reduced(full(name))
    specs.INPUT_SHAPES["train_4k"] = InputShape("train_4k", 64, 256,
                                                "train")
    dryrun.build_lowering = functools.partial(
        dryrun.build_lowering, fed_clients=2, fed_local_steps=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/fed.jsonl"
        out["fed_rc"] = dryrun.main(["--arch", "smollm-360m", "--shape",
                                     "train_4k", "--step", "fed_round",
                                     "--out", path])
        with open(path) as f:
            out["fed_records"] = [json.loads(x) for x in f]
    out["initialised_after"] = dist.is_initialized()
    print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def dryrun_result():
    return _run(DRYRUN)


def test_fake_mesh_dryrun_all_small_combos(dryrun_result):
    res, _ = dryrun_result
    recs = {k: v for k, v in res.items() if ":" in k}
    assert len(recs) == 4
    assert recs["smollm-360m:train_4k"]["collective_bytes"] > 0
    for k, v in recs.items():
        assert v["hlo_flops"] > 0, k
        assert v["dominant"] in ("compute", "memory", "collective"), k


def test_dryrun_counter_on_a_known_product(dryrun_result):
    """DTensor gathers the (64,1024) f32 activation once (moving its
    shard to the weight's row split), then each of the 8 ranks multiplies
    (64,512)@(512,1024): 2*64*512*1024 FLOPs a rank, which times 8 is the
    whole product's 2*64*1024*4096."""
    m = dryrun_result[0]["matmul"]
    assert m["counts"] == 1
    assert m["collective"]["all-gather"] == 64 * 1024 * 4
    assert sum(m["collective"].values()) == 64 * 1024 * 4
    assert m["flops"] * 8 == 2 * 64 * 1024 * 4096
    assert m["whole"] == 2 * 64 * 1024 * 4096


def test_dryrun_counts_replicated_work_once(dryrun_result):
    """The record's FLOPs count each op of the whole program once.  With
    the weight replicated, the batch's 2-way split leaves each of the 8
    ranks a (32,1024)@(1024,4096) product: the 4 ranks of a model row
    repeat the same one, so rank 0's FLOPs times 8 are 4x the product's
    while ``hlo_flops`` is the product's.  On the reduced tables the
    sharded run's ranks together execute at least the whole program."""
    res = dryrun_result[0]
    r = res["replicated"]
    assert r["whole"] == 2 * 64 * 1024 * 4096
    assert r["flops"] * 8 == 4 * r["whole"]
    for k, v in res.items():
        if ":" in k:
            assert v["rank_flops"] * 8 >= v["hlo_flops"] > 0, k


def test_dryrun_meshes_cli_and_cleanup(dryrun_result):
    res, stdout = dryrun_result
    assert res["production"] == [[16, 16], ["data", "model"]]
    assert res["skip_rc"] == 0
    assert "SKIP smollm-360m x long_500k" in stdout
    assert res["fed_rc"] == 0
    assert "OK smollm-360m x train_4k x pod" in stdout
    rec, = res["fed_records"]
    assert (rec["step"], rec["opt"], rec["arch"]) == (
        "fed_round", "muon", "smollm-360m")
    assert rec["collective_bytes"] > 0
    assert rec["rank_flops"] * 256 >= rec["hlo_flops"] > 0
    assert res["initialised_after"] is False


def test_dryrun_fed_round_on_the_fake_mesh(dryrun_result):
    """The round's clients in a loop on the 2x4 mesh's DTensors: its
    collectives counted, its FLOPs at most what the 8 ranks run."""
    rec = dryrun_result[0]["fed_round"]
    assert rec["collective_bytes"] > 0
    assert rec["rank_flops"] * 8 >= rec["hlo_flops"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_dryrun_soap_train_step_counts_its_refresh(dryrun_result):
    """SOAP's train step at step 0 (the record's) holds the eigenbasis
    refresh: exactly its power-iteration products (2 b n^3 a side) and
    QRs (4 n^3 / 3 a matrix: ``qr_flops``) more than at step 1."""
    r = dryrun_result[0]["soap_refresh"]
    flops = {int(k): v for k, v in r["flops"].items()}
    want = sum(2 * math.prod(s[:-2]) * s[-1] ** 3 for s in r["sides"]) \
        + sum(r["qr"])
    assert r["sides"] and all(s[-1] == s[-2] for s in r["sides"])
    assert sum(r["qr"]) == sum(math.prod(s[:-2]) * 4 * s[-1] ** 3 // 3
                               for s in r["sides"])
    assert flops[0] - flops[1] == want > 0


# ------------------------------------------------------------ 2-rank executors

TWO_RANKS = """
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, port, path):
        import numpy as np
        from repro_torch import configs, optim
        from repro_torch.core.engine import ExecutorConfig
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import model
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        try:
            mesh = make_host_mesh()            # ("data", "model") (2, 1)
            cfg = configs.get_reduced("llama-60m")
            p = model.init_params(cfg, torch.Generator().manual_seed(0))
            r = np.random.default_rng(1)
            tok = torch.from_numpy(r.integers(0, cfg.vocab_size, (16, 17)))
            batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
            from repro_torch.utils.tree import tree_leaves, tree_map
            gg = tree_map(lambda x: torch.zeros_like(x), p)

            def spd(x):   # a full-rank SPD L/R: a well-posed first QR
                n = x.shape[-1]
                a = torch.randn(x.shape, generator=torch.Generator()
                                .manual_seed(n))
                return a @ a.transpose(-1, -2) / n + 0.5 * torch.eye(n)
            out = {}
            for remat in (False, True):    # remat: the per-layer checkpoint
                for name, ex in [
                        ("vmap", None),
                        ("shard_map", ExecutorConfig("shard_map", mesh=mesh)),
                        ("sharded", ExecutorConfig("sharded", chunk_size=1,
                                                   mesh=mesh))]:
                    opt = optim.make("soap", eps=1e-3)
                    fn = steps.make_fed_round_step(
                        cfg, opt, lr=1e-2, clients=4, local_steps=2,
                        algorithm="fedpac_soap", executor=ex, remat=remat)
                    theta = tree_map(spd, opt.get_precond(opt.init(p)))
                    out[name, remat] = fn(p, theta, gg, batch)

            def diffs(a, b):
                return {
                    "loss_equal": bool(torch.equal(a[3], b[3])),
                    "max_param_diff": max(
                        float((x - y).abs().max()) for x, y in zip(
                            tree_leaves(a[0]), tree_leaves(b[0]))),
                    "max_theta_rel_diff": max(
                        float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(tree_leaves(a[1]),
                                        tree_leaves(b[1])))}
            res = {}
            for name in ("shard_map", "sharded"):
                for remat in (False, True):
                    res[f"{name}{'_remat' if remat else ''}"] = diffs(
                        out[name, remat], out["vmap", remat])
            res["vmap_remat_vs_none"] = diffs(out["vmap", True],
                                              out["vmap", False])
            # SOAP's refresh QR on DTensors: gathered, run whole,
            # put back in the operand's placements (a partial product as
            # replicated); bitwise the QR of the full tensor
            from torch.distributed.tensor import (
                Replicate, Shard, distribute_tensor)
            from repro_torch.sharding.ops import qr_q
            a = torch.randn((3, 6, 6), generator=torch.Generator()
                            .manual_seed(9))
            b = torch.randn((3, 6, 6), generator=torch.Generator()
                            .manual_seed(10))
            qr_res = {}
            for name, x, want, placements in [
                    ("shard1", distribute_tensor(a, mesh, [Shard(1),
                                                           Replicate()]),
                     a, [Shard(1), Replicate()]),
                    ("partial", distribute_tensor(a, mesh, [Shard(2),
                                                            Replicate()])
                     @ distribute_tensor(b, mesh, [Shard(1), Replicate()]),
                     a @ b, [Replicate(), Replicate()])]:
                q = qr_q(x)
                qr_res[name] = {
                    "partial_in": any(p.is_partial() for p in x.placements),
                    "placements": list(q.placements) == placements,
                    "max_diff": float((q.full_tensor()
                                       - torch.linalg.qr(want)[0]).abs()
                                      .max())}
            res["qr"] = qr_res
            try:
                from repro_torch.core.engine import make_cohort_executor
                make_cohort_executor(ExecutorConfig("shard_map", mesh=mesh))(
                    torch.sin, torch.ones(3))
                res["odd"] = "no error"
            except ValueError as e:
                res["odd"] = str(e)
            with open(f"{path}.{rank}", "w") as f:
                json.dump(res, f)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        port, path = int(sys.argv[1]), sys.argv[2]
        mp.start_processes(rank_main, args=(port, path), nprocs=2,
                           start_method="spawn")
        res = [json.load(open(f"{path}.{r}")) for r in range(2)]
        print("RESULT " + json.dumps(res))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_shard_map_and_sharded_equal_the_vmap_round(tmp_path):
    script = tmp_path / "two_ranks.py"
    script.write_text(textwrap.dedent(TWO_RANKS))
    proc = subprocess.run(
        [sys.executable, str(script), str(_free_port()),
         str(tmp_path / "out")], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    ranks = json.loads(line[-1][len("RESULT "):])
    assert ranks[0] == ranks[1]           # every rank holds the cohort
    for name in ("shard_map", "sharded", "shard_map_remat",
                 "sharded_remat", "vmap_remat_vs_none"):
        r = ranks[0][name]
        assert r["loss_equal"], name
        assert r["max_param_diff"] <= 1e-6, (name, r)
        assert r["max_theta_rel_diff"] <= 1e-6, (name, r)
    assert "not divisible" in ranks[0]["odd"]
    qr = ranks[0]["qr"]
    assert qr["partial"]["partial_in"] and not qr["shard1"]["partial_in"]
    for name, r in qr.items():
        assert r["placements"], name
    # the gathered shard is the full tensor: bitwise its QR; the partial
    # product is summed in another order, a few f32 ulps of its Q apart
    assert qr["shard1"]["max_diff"] == 0.0
    assert qr["partial"]["max_diff"] <= 1e-5
