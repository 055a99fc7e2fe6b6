"""Checkpointing: tensor trees <-> .npz with path-keyed entries
(counterpart of ``repro/checkpoint/store.py``, in its on-disk format).

A checkpoint is ``step_XXXXXXXX/{params,g_global,theta}.npz`` plus
``meta.json``.  Leaves are stored under '/'-joined tree paths (dict keys,
sequence indices), the reference's key strings for the same tree, with
dtypes and shapes preserved and an atomic rename on write; None leaves
(SOAP's Theta has them) are listed in the file's meta.  npz has no
bfloat16 or float8, so such leaves are stored as their raw bits
(``uint16``/``uint8``) with the dtype's name in the meta, as the reference
stores them — without ``ml_dtypes``: the bits are reinterpreted through
``Tensor.view``.  So either package reads the other's checkpoints.  The
server state covers params, Theta, g_G, the round counter,
``theta_version`` and the ``GeometryController``; ``meta.json`` also
carries the tracer's identity (``Tracer.state()``), so a restored run
continues its trace's numbering.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import GeometryController
from repro_torch.core.server import ServerState
from repro_torch.utils.tree import tree_leaves

# dtypes npz cannot hold: stored as raw bits of the same width
_BITS = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
         torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
         torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_BY_NAME = {name: dtype for dtype, (name, _, _) in _BITS.items()}


def _geom_to_meta(geom) -> Optional[dict]:
    if geom is None:
        return None
    return {"beta": float(geom.beta), "drift_ema": float(geom.drift_ema),
            "beta_max": float(geom.beta_max), "adaptive": bool(geom.adaptive),
            "ema": float(geom.ema)}


def _geom_from_meta(meta: Optional[dict], device):
    if meta is None:
        return None
    return GeometryController(
        torch.tensor(meta["beta"], dtype=torch.float32, device=device),
        torch.tensor(meta["drift_ema"], dtype=torch.float32, device=device),
        beta_max=meta["beta_max"], adaptive=meta["adaptive"],
        ema=meta["ema"])


def _entries(tree, path=()):
    """[(path, leaf)] in the reference's order, None leaves included."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _entries(tree[k],
                                                          path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [e for i, x in enumerate(tree) for e in _entries(x,
                                                                path + (i,))]
    return [(path, tree)]


def _key(path) -> str:
    return "/".join(str(k) for k in path) or "__root__"


def _flatten(tree) -> dict:
    return {_key(path): leaf for path, leaf in _entries(tree)}


def _rebuild(template, values: dict, path=()):
    """``template``'s structure with ``values[key]`` at every leaf."""
    if isinstance(template, dict):
        return {k: _rebuild(v, values, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, values, path + (i,))
                              for i, x in enumerate(template))
    return values[_key(path)]


def save_pytree(tree, path: str):
    """Atomic save. None leaves are preserved (masked optimizer states)."""
    entries = _flatten(tree)
    arrays = {}
    meta = {"none_keys": [], "order": list(entries), "dtypes": {}}
    for k, v in entries.items():
        if v is None:
            meta["none_keys"].append(k)
            continue
        t = torch.as_tensor(v).detach().cpu()
        if t.dtype in _BITS:
            name, np_bits, torch_bits = _BITS[t.dtype]
            meta["dtypes"][k] = name
            arrays[k] = t.view(torch_bits).numpy().view(np_bits)
        else:
            arrays[k] = t.numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(template, path: str):
    """Load into the structure of ``template``; shapes are validated and
    each tensor lands on its template leaf's device, in its dtype."""
    values = {}
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        none_keys = set(meta["none_keys"])
        for k, tmpl in _flatten(template).items():
            if k in none_keys:
                values[k] = None
                continue
            arr = z[k]
            name = meta.get("dtypes", {}).get(k)
            if name is not None:
                dtype = _BY_NAME[name]
                t = torch.from_numpy(arr.view(
                    np.int16 if arr.itemsize == 2 else np.uint8)).view(dtype)
            else:
                t = torch.from_numpy(arr)
            if isinstance(tmpl, torch.Tensor):
                if tuple(t.shape) != tuple(tmpl.shape):
                    raise ValueError(f"{path}: {k} has shape "
                                     f"{tuple(t.shape)}, the template "
                                     f"{tuple(tmpl.shape)}")
                t = t.to(device=tmpl.device, dtype=tmpl.dtype)
            values[k] = t
    return _rebuild(template, values)


def save_server_state(server: ServerState, directory: str, step: int,
                      telemetry: Optional[dict] = None):
    """``telemetry`` is the tracer's persistent identity
    (``repro_torch.obs.Tracer.state()``: run_id + cumulative round/span/
    seq counters), so a restored run appends to the same trace."""
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    save_pytree(server.params, os.path.join(d, "params.npz"))
    save_pytree(server.g_global, os.path.join(d, "g_global.npz"))
    if server.theta is not None:
        save_pytree(server.theta, os.path.join(d, "theta.npz"))
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"round": server.round,
                   "theta_version": server.theta_version,
                   "has_theta": server.theta is not None,
                   "geom": _geom_to_meta(server.geom),
                   "telemetry": telemetry}, f)


def load_meta(directory: str, step: Optional[int] = None) -> dict:
    """The raw checkpoint meta dict (round, theta_version, geom, and the
    tracer identity under ``"telemetry"`` for ``Tracer.from_state``)."""
    step = latest_step(directory) if step is None else step
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        return json.load(f)


def load_server_state(template: ServerState, directory: str,
                      step: Optional[int] = None) -> ServerState:
    """The checkpoint at ``step`` (default: the latest) in ``template``'s
    structure, on its devices."""
    step = latest_step(directory) if step is None else step
    d = os.path.join(directory, f"step_{step:08d}")
    meta = load_meta(directory, step)
    params = load_pytree(template.params, os.path.join(d, "params.npz"))
    gg = load_pytree(template.g_global, os.path.join(d, "g_global.npz"))
    theta = None
    if meta["has_theta"] and template.theta is not None:
        theta = load_pytree(template.theta, os.path.join(d, "theta.npz"))
    geom = _geom_from_meta(meta.get("geom"),
                           tree_leaves(template.params)[0].device)
    if geom is None:
        # a checkpoint without a controller keeps the experiment's
        geom = template.geom
    return ServerState(params, theta, gg, meta["round"],
                       meta.get("theta_version", meta["round"]), geom)


def latest_step(directory: str) -> int:
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_")]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return max(steps)


class CheckpointManager:
    """Keep-last-N rotation for federated round checkpoints."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, server: ServerState, telemetry: Optional[dict] = None):
        save_server_state(server, self.directory, server.round,
                          telemetry=telemetry)
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.directory)
                       if n.startswith("step_"))
        for s in steps[: -self.keep]:
            d = os.path.join(self.directory, f"step_{s:08d}")
            for fn in os.listdir(d):
                os.unlink(os.path.join(d, fn))
            os.rmdir(d)

    def restore(self, template: ServerState) -> ServerState:
        return load_server_state(template, self.directory)

    def restore_meta(self) -> dict:
        """Latest checkpoint's meta (incl. the ``telemetry`` trace state)."""
        return load_meta(self.directory)
