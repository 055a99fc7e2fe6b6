"""Finding a cell's pieces by name: the manifest (``BENCHMARK.json``), the
configuration (``configs/<name>.json``), the traffic mix
(``traffic/<name>.json``), the cell's limits (``cells/<workload>.json``)
and each per-layer metric's reader (``metrics/<name>.py``, a module with
``read(ctx)``).  A ``Catalog`` looks in its roots in order, so a piece
added beside the others is found without a change to any file."""
from __future__ import annotations

import importlib.util
import json
import os

from fedbench import HERE, ROOT


def load_manifest(path=None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the manifest (have "
                   f"{[w['name'] for w in manifest['workloads']]})")


def reported(manifest: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer metrics."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


class Catalog:
    def __init__(self, roots=(HERE,)):
        self.roots = tuple(roots)

    def path(self, kind: str, name: str, ext: str) -> str:
        for root in self.roots:
            p = os.path.join(root, kind, name + ext)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{list(self.roots)}")

    def _json(self, kind, name):
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def cell(self, name: str) -> dict:
        return self._json("cells", name)

    def metric(self, name: str):
        """The reader module of per-layer metric ``name``."""
        p = self.path("metrics", name, ".py")
        spec = importlib.util.spec_from_file_location(
            "fedbench_metric_" + name.replace(".", "_"), p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if not callable(getattr(mod, "read", None)):
            raise TypeError(f"{p} defines no read(ctx)")
        return mod
