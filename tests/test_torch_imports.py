"""Import guard: the port (``src/repro_torch``) and the scripts that run
it on a GPU host (``chip_smoke.py``, the port's example and profiling
tool, the CUDA kernel tests) import nothing of JAX and nothing of the JAX
package ``repro`` — not even its numpy-only modules — and
``chip_smoke.py`` fails (without printing a result) on a host without
CUDA.
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
            "model")} <= set(mods)
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
