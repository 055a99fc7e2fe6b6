"""Import guard: the port (``src/repro_torch``) and the scripts that run
it on a GPU host (``chip_smoke.py``, the port's example and profiling
tool, the CUDA kernel tests) import nothing of JAX and nothing of the JAX
package ``repro`` — not even its numpy-only modules — and
``chip_smoke.py`` fails (without printing a result) on a host without
CUDA.  And every public name of a reference module is in its port
counterpart, but for the TPU/JAX-only names and those still queued, both
spelled out below, so that no slice drops a name unnoticed.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "examples" / "torch_quickstart.py",
           ROOT / "tools" / "profile_torch_round.py",
           ROOT / "tools" / "time_svd_drivers.py",
           ROOT / "tools" / "gpu_cpu_gap.py",
           ROOT / "tests" / "test_torch_kernels_cuda.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + SCRIPTS,
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == [], f"{path.name} imports {bad}"


def _run(code, cwd=ROOT, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                          **env})


def test_importing_every_port_module_loads_no_jax():
    mods = list(_modules())
    assert "repro_torch.optim.soap" in mods and "repro_torch.api" in mods
    assert {"repro_torch.fed.traffic", "repro_torch.configs",
            "repro_torch.scenarios.lm"} | {
        f"repro_torch.models.{m}" for m in (
            "config", "layers", "rope", "attention", "transformer",
            "model", "moe", "ssm", "rglru")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok', len(sys.modules))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    hide_gpu = {"CUDA_VISIBLE_DEVICES": ""}
    code = "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')"
    proc = _run(code, **hide_gpu)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory: no repository to build from
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ------------------------------------------------- the reference's names

REFERENCE = ROOT / "src" / "repro"
# names that mean something only on a TPU or under JAX, and stay out
TPU_OR_JAX_ONLY = {
    "kernels/qblock/kernel.py": {"INT8_SUBLANES"},
    "kernels/fused_agg/kernel.py": {"INT8_SUBLANES"},
    "kernels/soap_rotate/kernel.py": {"LANES", "SUBLANES"},
    "kernels/sophia_update/kernel.py": {"LANES", "SUBLANES"},
    # the *_pallas entry points; the port's wrappers dispatch by device
    "kernels/ns_ortho/ops.py": {"newton_schulz_pallas",
                                "ns_iteration_pallas"},
    # the use_pallas switch between Pallas and ref.py
    "kernels/fused_agg/ops.py": {"dequant_accumulate"},
    "utils/hw.py": {"on_tpu", "default_use_pallas", "default_interpret",
                    "resolve_use_pallas", "resolve_interpret"},
    "models/config.py": {"ModelConfig.jnp_dtype"},     # torch_dtype here
    "fed/rounds.py": {"FedConfig.use_pallas"},
    "core/transport/base.py": {"TransportConfig.use_pallas",
                               "TransportConfig.interpret",
                               "WireMsg.treedef"},      # a jax treedef
    "core/transport/qblock.py": {"QBlock.use_pallas", "QBlock.interpret"},
    # the TPU v5e's inter-chip link bandwidth; the port's roofline takes
    # the H100's NVLink per-link bandwidth under NVLINK_BW
    "launch/mesh.py": {"ICI_BW"},
}
# names still queued in ROADMAP queue 1, by item: none since every
# module of the reference has its counterpart
QUEUED = {}
# reference modules with no port counterpart: what stands in for each
MODULES_LEFT = {
    "models/param.py": "models/layers.py::{Initializer,Box}",
    # the Pallas packages' references and use_pallas switches: each
    # kernel's plain version sits in its kernel.py
    "kernels/fused_agg/ref.py": "kernel.py", "kernels/ns_ortho/ref.py":
    "kernel.py", "kernels/qblock/ops.py": "kernel.py",
    "kernels/qblock/ref.py": "kernel.py", "kernels/soap_rotate/ref.py":
    "kernel.py", "kernels/sophia_update/ops.py": "kernel.py",
    "kernels/sophia_update/ref.py": "kernel.py",
}


def _reference_names(path):
    """Public top-level names of a reference module (and, for a package's
    ``__init__``, the names it re-exports), then ``Class.field`` for each
    field and public method of its dataclasses and each public method or
    property of its other classes."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        dataclass = any("dataclass" in ast.unparse(d)
                        for d in node.decorator_list)
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                names.add(f"{node.name}.{item.name}")
            elif dataclass and isinstance(item, ast.AnnAssign) and \
                    isinstance(item.target, ast.Name):
                names.add(f"{node.name}.{item.target.id}")
    return {n for n in names
            if not any(part.startswith("_") for part in n.split("."))}


def _provides(module, name):
    """``module`` has ``name``; a ``Class.attr`` counts as a class
    attribute, a dataclass field or a parameter of ``__init__`` (the port
    keeps some frozen dataclasses as plain classes)."""
    import dataclasses
    import inspect
    owner, _, attr = name.rpartition(".")
    if not owner:
        return hasattr(module, name)
    cls = getattr(module, owner, None)
    if cls is None:
        return False
    if hasattr(cls, attr):
        return True
    if dataclasses.is_dataclass(cls) and attr in {
            f.name for f in dataclasses.fields(cls)}:
        return True
    return attr in inspect.signature(cls.__init__).parameters


def test_port_modules_provide_the_reference_public_names():
    """Each reference module with a port counterpart at the same relative
    path: every public name the reference's source defines (read by AST,
    importing no JAX) exists in the port module, but for the TPU/JAX-only
    names and those queued in ROADMAP queue 1 (above); and the reference
    modules with no counterpart are those of ``MODULES_LEFT``."""
    import importlib
    sys.path.insert(0, str(ROOT / "src"))
    pairs, missing, unported = 0, [], set()
    for ref in sorted(REFERENCE.rglob("*.py")):
        rel = ref.relative_to(REFERENCE).as_posix()
        port = PORT / rel
        if not port.exists():
            unported.add(rel)
            continue
        pairs += 1
        parts = ("repro_torch",) + tuple(rel[:-3].split("/"))
        if parts[-1] == "__init__":
            parts = parts[:-1]
        module = importlib.import_module(".".join(parts))
        skip = TPU_OR_JAX_ONLY.get(rel, set()) | set(QUEUED.get(rel, {}))
        for name in sorted(_reference_names(ref) - skip):
            if not _provides(module, name):
                missing.append(f"{rel}: {name}")
        for name in sorted(skip):
            if _provides(module, name):
                missing.append(f"{rel}: {name} is listed as left out but "
                               "is provided; drop it from the lists")
    assert pairs >= 90, pairs
    assert unported == set(MODULES_LEFT), unported ^ set(MODULES_LEFT)
    assert missing == [], "\n".join(missing)
