"""Measure how far a CNN path's history on the card lands from the CPU
path's, and what the gap comes from.

    python3 tools/gpu_cpu_gap.py [--paths fedpm_soap fedpac_muon_light]
                                 [--seeds 0 1]

``chip_smoke.py`` holds each ``cifar_like_cnn`` path's 3-round history on
the card against the CPU path's.  For each path and seed this runs the
CPU reference once per configuration and the card in the variants below,
and prints each metric's largest gap over the rounds as a multiple of the
tolerance ``chip_smoke.py`` holds that path to (SOAP's CNN tolerances for
``fedpm_soap``, the first-order ones for ``fedpac_muon_light``).

``fedpm_soap`` (SOAP at eps 1e-3, as ``chip_smoke.py`` runs it):

  qr, qr again       SOAP's QR refresh (the default), twice
  qr_on_host         the QR refresh done by LAPACK on the host, the rest
                     on the card
  ns                 both sides with ``eig_method="ns"`` (no QR)
  <cfg> fault_uniform, <cfg> fault_adam_1e-2, <cfg> fault_adam_1e-3
                     planted faults on the card: uniform mixing weights,
                     or ``adam_moments``'s direction scaled by 1 + 1e-2
                     or 1 + 1e-3

``fedpac_muon_light`` (qblock delta, ``lowrank_svd+qblock`` Theta, bf16
wire, error feedback, rank 4, as ``chip_smoke.py`` runs it):

  chain, chain again the path, twice
  svd_on_host        the codec's SVD done by LAPACK on the host
  f32_wire           the same codecs on the f32 wire (no bf16 rounding)
  lowrank_only       Theta as ``lowrank_svd`` alone (no int8 stage)

The last line is a JSON object of every ratio.  Needs a CUDA device;
imports nothing of JAX.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ROUNDS = 3


@contextlib.contextmanager
def on_host(name):
    """Every ``torch.linalg.<name>`` of a CUDA matrix runs on the host."""
    orig = getattr(torch.linalg, name)

    def host(a, *args, **kw):
        if a.device.type != "cuda":
            return orig(a, *args, **kw)
        return tuple(t.to(a.device) for t in orig(a.cpu(), *args, **kw))

    setattr(torch.linalg, name, host)
    try:
        yield
    finally:
        setattr(torch.linalg, name, orig)


@contextlib.contextmanager
def adam_fault(scale):
    """SOAP's ``adam_moments`` returns its direction scaled by ``scale``."""
    from repro_torch.optim import soap
    orig = soap.adam_moments

    def wrong(*args, **kw):
        n, m, v = orig(*args, **kw)
        return n * scale, m, v

    soap.adam_moments = wrong
    try:
        yield
    finally:
        soap.adam_moments = orig


def uniform_mixing(spec):
    from repro_torch.core.engine.aggregation import precond_mixing_weights
    return dataclasses.replace(spec, mixing=lambda deltas, thetas: (
        torch.ones_like(precond_mixing_weights(deltas, thetas))))


def ratios(want, got, tol, rel_tol):
    """Each metric's largest gap over the rounds, over its tolerance."""
    out = {}
    for k, t in {**tol, **rel_tol}.items():
        out[k] = max(abs(w[k] - g[k]) / max(
            t * abs(w[k]) if k in rel_tol else t, 1e-30)
            for w, g in zip(want, got))
    return out


def variants(path, cs):
    """(tolerances, {config: (algorithm, kwargs)} run on both sides,
    [(variant, config, algorithm override or None, context)])."""
    from repro_torch.api import resolve
    none = contextlib.nullcontext
    if path == "fedpm_soap":
        qr = {"opt_kwargs": {"eps": cs.CNN_EPS}}
        ns = {"opt_kwargs": {"eps": cs.CNN_EPS, "eig_method": "ns"}}
        fedpm = resolve("fedpm_soap")
        runs = [("qr", "qr", None, none), ("qr again", "qr", None, none),
                ("qr_on_host", "qr", None, lambda: on_host("qr")),
                ("ns", "ns", None, none)]
        for cfg in ("qr", "ns"):
            runs += [(f"{cfg} fault_uniform", cfg, uniform_mixing(fedpm),
                      none),
                     (f"{cfg} fault_adam_1e-2", cfg, None,
                      lambda: adam_fault(1 + 1e-2)),
                     (f"{cfg} fault_adam_1e-3", cfg, None,
                      lambda: adam_fault(1 + 1e-3))]
        return ((cs.CNN_TOL, cs.CNN_REL_TOL),
                {"qr": (fedpm, qr), "ns": (fedpm, ns)}, runs)
    chain = dict(cs.MUON_LIGHT)
    f32 = dict(chain, wire_dtype="f32")
    lowrank = dict(chain, theta_codec="lowrank_svd")
    runs = [("chain", "chain", None, none),
            ("chain again", "chain", None, none),
            ("svd_on_host", "chain", None, lambda: on_host("svd")),
            ("f32_wire", "f32", None, none),
            ("lowrank_only", "lowrank", None, none)]
    return ((cs.FIRST_ORDER_TOL, cs.FIRST_ORDER_REL_TOL),
            {"chain": (path, chain), "f32": (path, f32),
             "lowrank": (path, lowrank)}, runs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", nargs="+",
                    default=["fedpm_soap", "fedpac_muon_light"],
                    choices=["fedpm_soap", "fedpac_muon_light"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gpu_cpu_gap: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    report = {}
    for seed in args.seeds:
        gpu = materialize("cifar_like_cnn", seed=seed, device="cuda")
        cpu = dataclasses.replace(
            materialize("cifar_like_cnn", seed=seed, device="cpu"),
            params=params_from_numpy(params_to_numpy(gpu.params), "cpu"))

        def history(algo, scn, kw, ctx=contextlib.nullcontext, **more):
            exp = build_experiment(algo, scenario=scn, rounds=ROUNDS,
                                   seed=seed, **kw, **more)
            with ctx():
                for _ in range(ROUNDS):
                    exp.run_round()
            return exp.history

        for path in args.paths:
            tol, configs, runs = variants(path, cs)
            ref = {cfg: history(algo, cpu, kw, device="cpu")
                   for cfg, (algo, kw) in configs.items()}
            for name, cfg, algo, ctx in runs:
                spec, kw = configs[cfg]
                got = history(algo or spec, gpu, kw, ctx)
                r = ratios(ref[cfg], got, *tol)
                report[f"{path} seed {seed} {name}"] = r
                worst = max(r, key=r.get)
                print(f"{path} seed {seed} {name:18s} worst {worst} "
                      f"{r[worst]:.3f} x its tolerance; " + ", ".join(
                          f"{k} {v:.3f}" for k, v in r.items()), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
