"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's Hopper kernels from this checkout's sources, holds each
against its plain PyTorch version on the card at the main path's shapes
(and times kernel, plain version, a PyTorch library yardstick and the
card's bound), then drives the main path — the sync ``local_soap`` and
``fedpac_soap`` rounds at ViT-Tiny width, and ``fedpac_soap`` on the
registered ``cifar_like_cnn`` — through ``repro_torch.api
.build_experiment``, checking that every kernel was launched there.  The
CNN run is repeated on the CPU (plain versions) from the same weights and
the two histories must agree.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
on a host without CUDA, and outside a checkout of the repository.
Imports nothing of JAX.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
S_VIT = 5                   # 10 clients x participation 0.5
ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM FP32 (non-tensor-core), published
VIT_TINY = dict(patch=4, d_model=192, layers=12, heads=3)   # DeiT-Ti
VIT_LEAVES = [(192, 576), (192, 192), (192, 768), (768, 192)]  # one block
CNN_LEAVES = [(27, 8), (8, 16), (16, 32)]   # stem, block0/skip, block1/skip
U = 2.0 ** -24
# CNN GPU-vs-CPU agreement, as tests/test_torch_round.py holds the port
# to the JAX package (eps=1e-3 damps the first refresh's roundoff)
CNN_EPS = 1e-3
CNN_TOL = {"loss": 5e-3, "test_loss": 2e-2, "test_acc": 6 / 768}
CNN_REL_TOL = {"drift": 0.05, "norm_drift": 0.05}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def timed(fn, reps=5, rounds=3):
    """Median over ``rounds`` of the mean ms of ``reps`` calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return sorted(samples)[len(samples) // 2]


def device_ms(fn):
    """Summed device time (ms) of the CUDA kernels one call of ``fn``
    runs, from a ``torch.profiler`` trace: the work's cost on the card
    without the host's launch cost, which ``timed`` includes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    us = sum(getattr(e, attr) for e in events
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3


# ------------------------------------------------------------------ build

def build_kernels(dev):
    from repro_torch.kernels import build
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    t0 = time.perf_counter()
    path, compiler_log = build.build("matmul_fused.cu")
    nvcc_s = time.perf_counter() - t0
    log(f"built {os.path.relpath(path, HERE)} with nvcc in {nvcc_s:.2f} s")
    for line in compiler_log.splitlines():
        if "ptxas" in line:
            log("  " + line.strip())
    t0 = time.perf_counter()
    x = torch.ones(8, device=dev)
    adam_moments(x, x, x)
    torch.cuda.synchronize()
    log(f"compiled adam_moments with Triton in "
        f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------ kernel checks

def leaf_inputs(m, n, s, dev, gen):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    g = randn(s, m, n)
    ql, _ = torch.linalg.qr(randn(s, m, m))
    qr, _ = torch.linalg.qr(randn(s, n, n))
    lf = torch.bmm(g, g.transpose(1, 2)) / n
    rf = torch.bmm(g.transpose(1, 2), g) / m
    return dict(g=g, ql=ql, qr=qr, L=lf, R=rf, M=randn(s, m, n),
                V=torch.rand((s, m, n), generator=gen, device=dev))


def gemm_forms(x, b2=0.95):
    """The six products one SOAP step makes per matrix leaf:
    (name, lhs, rhs, aux, alpha, beta)."""
    g, gt = x["g"], x["g"].transpose(1, 2)
    return [
        ("L_ema", g, gt, x["L"], 1 - b2, b2),
        ("R_ema", gt, g, x["R"], 1 - b2, b2),
        ("QlT_G", x["ql"].transpose(1, 2), g, None, 1.0, 0.0),
        ("G_Qr", g, x["qr"], None, 1.0, 0.0),
        ("Ql_N", x["ql"], x["M"], None, 1.0, 0.0),
        ("N_QrT", x["M"], x["qr"].transpose(1, 2), None, 1.0, 0.0),
    ]


def check_matmul_fused(leaves):
    """Kernel vs plain on every form; elementwise bound 2 (k+2) u
    (|alpha| |A||B| + |beta| |aux|): two f32 sums in different orders."""
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_plain,
    )
    worst_err, worst_ratio = 0.0, 0.0
    for (m, n, s), x in leaves:
        for name, a, b, aux, alpha, beta in gemm_forms(x):
            got = matmul_fused(a, b, aux, alpha=alpha, beta=beta)
            want = matmul_fused_plain(a, b, aux, alpha=alpha, beta=beta)
            mag = abs(alpha) * torch.matmul(a.abs(), b.abs())
            if aux is not None:
                mag = mag + abs(beta) * aux.abs()
            bound = 2 * (a.shape[-1] + 2) * U * mag + 1e-30
            err = (got - want).abs()
            ratio = float((err / bound).max())
            worst_err = max(worst_err, float(err.max()))
            worst_ratio = max(worst_ratio, ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"matmul_fused {name} at (S={s}, m={m}, n={n}) exceeds "
                    f"its bound: max err {float(err.max()):.3e}, "
                    f"err/bound {ratio:.3f}")
    log(f"matmul_fused vs plain: max |err| {worst_err:.3e}, max err/bound "
        f"{worst_ratio:.3f} (bound 2(k+2)u sum|a||b|)")
    return worst_err


def check_adam_moments(leaves):
    """Kernel vs plain: m', v' within 1e-6 max(1, |x|) (one FMA apart), n
    within 1e-5 max(1, |n|) (a division and a square root, each rounded
    or approximated differently)."""
    from repro_torch.kernels.soap_rotate.kernel import (
        adam_moments, adam_moments_plain,
    )
    worst = 0.0
    for (m, n, s), x in leaves:
        for step in (None, 0, 7):
            got = adam_moments(x["g"], x["M"], x["V"], step=step)
            want = adam_moments_plain(x["g"], x["M"], x["V"], step=step)
            for name, gv, wv, rel in zip(("n", "m", "v"), got, want,
                                         (1e-5, 1e-6, 1e-6)):
                err = (gv - wv).abs()
                worst = max(worst, float(err.max()))
                if bool((err > rel * wv.abs().clamp(min=1.0)).any()):
                    raise AssertionError(
                        f"adam_moments {name} at (S={s}, m={m}, n={n}, "
                        f"step={step}): max err {float(err.max()):.3e}")
    log(f"adam_moments vs plain: max |err| {worst:.3e} (bounds 1e-5 rel on "
        "n, 1e-6 rel on m', v')")
    return worst


def check_soap_rotated_update(leaves):
    """The composition, two-sided and one-sided, against the same
    composition of plain versions; directions within 1e-4 max(1, |d|)."""
    from repro_torch.kernels.ns_ortho.kernel import matmul_fused_plain
    from repro_torch.kernels.soap_rotate.kernel import adam_moments_plain
    from repro_torch.kernels.soap_rotate.ops import soap_rotated_update

    def plain(g, ql, qr, m, v):
        if ql is not None:
            g = matmul_fused_plain(ql.transpose(1, 2), g)
        if qr is not None:
            g = matmul_fused_plain(g, qr)
        n, m2, v2 = adam_moments_plain(g, m, v, step=3)
        if ql is not None:
            n = matmul_fused_plain(ql, n)
        if qr is not None:
            n = matmul_fused_plain(n, qr.transpose(1, 2))
        return n, m2, v2

    worst = 0.0
    for (m, n, s), x in leaves:
        for ql, qr in ((x["ql"], x["qr"]), (None, x["qr"]), (x["ql"], None)):
            got = soap_rotated_update(x["g"], ql, qr, x["M"], x["V"], step=3)
            want = plain(x["g"], ql, qr, x["M"], x["V"])
            for gv, wv in zip(got, want):
                err = (gv - wv).abs()
                worst = max(worst, float(err.max()))
                if bool((err > 1e-4 * wv.abs().clamp(min=1.0)).any()):
                    raise AssertionError(
                        f"soap_rotated_update at (S={s}, m={m}, n={n}): "
                        f"max err {float(err.max()):.3e}")
    log(f"soap_rotated_update vs plain composition: max |err| {worst:.3e} "
        "(bound 1e-4 rel), two- and one-sided")


# ----------------------------------------------------------------- timing

def time_kernels(dev, gen):
    """One local SOAP step's worth of each kernel's work on ViT-Tiny at
    S=5 (12 blocks x 4 matrix leaves, refresh excluded), timed for the
    kernel, the plain version and a PyTorch library call, beside the
    card's bound for the same work.  ``ms`` (CUDA events around the
    loop of launches) includes the host's launch rate; ``device_ms`` and
    its plain and library counterparts are the device time alone."""
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_plain,
    )
    from repro_torch.kernels.soap_rotate.kernel import (
        adam_moments, adam_moments_plain,
    )
    leaves = [leaf_inputs(m, n, S_VIT, dev, gen)
              for _ in range(VIT_TINY["layers"]) for m, n in VIT_LEAVES]
    forms = [f for x in leaves for f in gemm_forms(x)]

    def gemm(fn):
        def run():
            for _, a, b, aux, alpha, beta in forms:
                fn(a, b, aux, alpha=alpha, beta=beta)
        return run

    def library(a, b, aux, alpha, beta):
        if aux is None:
            return torch.bmm(a, b)
        return torch.baddbmm(aux, a, b, beta=beta, alpha=alpha)

    flops = bytes_ = 0
    for _, a, b, aux, alpha, beta in forms:
        s, m, k = a.shape
        n = b.shape[-1]
        flops += 2 * s * m * n * k + (3 if aux is not None else 1) * s * m * n
        ins = {a.data_ptr(): a.numel(), b.data_ptr(): b.numel()}
        if aux is not None:
            ins[aux.data_ptr()] = aux.numel()
        bytes_ += 4 * (sum(ins.values()) + s * m * n)
    gemm_bound = max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    gemm_by = "bytes" if bytes_ / HBM_BYTES_PER_S > flops / FP32_FLOPS \
        else "operations"

    def adam(fn):
        def run():
            for x in leaves:
                fn(x["g"], x["M"], x["V"], step=3)
        return run

    elems = sum(x["g"].numel() for x in leaves)
    adam_bytes, adam_flops = 24 * elems, 12 * elems
    adam_bound = max(adam_bytes / HBM_BYTES_PER_S,
                     adam_flops / FP32_FLOPS) * 1e3

    out = {}
    t, d = {}, {}
    for key, fn in (("k", gemm(matmul_fused)), ("p", gemm(matmul_fused_plain)),
                    ("l", gemm(library))):
        t[key], d[key] = timed(fn), device_ms(fn)
    out["matmul_fused"] = dict(
        ms=t["k"], plain_ms=t["p"], library_ms=t["l"], bound_ms=gemm_bound,
        bound_by=gemm_by, device_ms=d["k"], plain_device_ms=d["p"],
        library_device_ms=d["l"])
    log(f"matmul_fused, one local step of ViT-Tiny (S={S_VIT}, "
        f"{len(forms)} launches, {flops / 1e9:.1f} GFLOP, "
        f"{bytes_ / 1e6:.1f} MB): kernel {t['k']:.3f} ms, plain "
        f"{t['p']:.3f} ms, torch.bmm/baddbmm {t['l']:.3f} ms; device time "
        f"{d['k']:.3f} / {d['p']:.3f} / {d['l']:.3f} ms; bound "
        f"{gemm_bound:.3f} ms ({gemm_by})")
    t, d = {}, {}
    for key, fn in (("k", adam(adam_moments)),
                    ("p", adam(adam_moments_plain))):
        t[key], d[key] = timed(fn), device_ms(fn)
    out["adam_moments"] = dict(
        ms=t["k"], plain_ms=t["p"], library_ms=None, bound_ms=adam_bound,
        bound_by="bytes", device_ms=d["k"], plain_device_ms=d["p"],
        library_device_ms=None)
    log(f"adam_moments, one local step of ViT-Tiny (S={S_VIT}, "
        f"{len(leaves)} launches, {elems / 1e6:.2f} M elements, "
        f"{adam_bytes / 1e6:.1f} MB): kernel {t['k']:.3f} ms, plain "
        f"{t['p']:.3f} ms; device time {d['k']:.3f} / {d['p']:.3f} ms; "
        f"bound {adam_bound:.3f} ms (bytes)")
    return out


# -------------------------------------------------------------- main path

def vit_tiny_spec():
    from repro_torch.api import resolve_scenario
    base = resolve_scenario("cifar_like_vit")
    return dataclasses.replace(
        base, name="cifar_like_vit_tiny",
        source_kwargs=dict(base.source_kwargs, image_size=32, n_classes=100),
        model_kwargs=VIT_TINY)


def run_experiment(label, exp):
    from repro_torch.kernels.ns_ortho.kernel import matmul_fused
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    before = (matmul_fused.launches, adam_moments.launches)
    for _ in range(exp.fed.rounds):
        t0 = time.perf_counter()
        rec = exp.run_round()   # ends in host reads of the metrics
        dt = time.perf_counter() - t0
        log(f"{label} round {rec['round']}: {dt:.2f} s "
            + json.dumps({k: rec[k] for k in sorted(rec)}))
        for k in ("loss", "test_loss", "drift", "norm_drift"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{label}: non-finite {k} {rec[k]}")
    launches = (matmul_fused.launches - before[0],
                adam_moments.launches - before[1])
    log(f"{label}: matmul_fused launches {launches[0]}, adam_moments "
        f"launches {launches[1]}")
    return exp.history


def compare_histories(want, got):
    for r, (w, g) in enumerate(zip(want, got)):
        for k, tol in CNN_TOL.items():
            if abs(w[k] - g[k]) > tol:
                raise AssertionError(f"CNN GPU vs CPU round {r + 1} {k}: "
                                     f"{g[k]} vs {w[k]} (tol {tol})")
        for k, tol in CNN_REL_TOL.items():
            if abs(w[k] - g[k]) > tol * abs(w[k]):
                raise AssertionError(f"CNN GPU vs CPU round {r + 1} {k}: "
                                     f"{g[k]} vs {w[k]} (rel tol {tol})")


def main_path():
    """Returns the launch counts of the main path's run."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.kernels.ns_ortho.kernel import matmul_fused
    from repro_torch.kernels.soap_rotate.kernel import adam_moments

    spec = vit_tiny_spec()
    vit = materialize(spec, seed=0, n_clients=spec.n_clients, device="cuda")
    cnn = materialize("cifar_like_cnn", seed=0, device="cuda")
    cpu_params = params_from_numpy(params_to_numpy(cnn.params), "cpu")

    matmul_fused.launches = 0
    adam_moments.launches = 0
    for algo in ("local_soap", "fedpac_soap"):
        run_experiment(f"vit_tiny {algo}", build_experiment(
            algo, scenario=vit, participation=0.5, rounds=ROUNDS))
    cnn_gpu = run_experiment("cifar_like_cnn fedpac_soap", build_experiment(
        "fedpac_soap", scenario=cnn, rounds=ROUNDS,
        opt_kwargs={"eps": CNN_EPS}))
    launches = {"matmul_fused": matmul_fused.launches,
                "adam_moments": adam_moments.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")

    cnn_cpu = materialize("cifar_like_cnn", seed=0, device="cpu")
    cnn_cpu = dataclasses.replace(cnn_cpu, params=cpu_params)
    ref = run_experiment("cifar_like_cnn fedpac_soap (cpu reference)",
                         build_experiment("fedpac_soap", scenario=cnn_cpu,
                                          rounds=ROUNDS, device="cpu",
                                          opt_kwargs={"eps": CNN_EPS}))
    compare_histories(ref, cnn_gpu)
    log("cifar_like_cnn GPU history agrees with the CPU plain path")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    build_kernels(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = ([((m, n, S_VIT), leaf_inputs(m, n, S_VIT, dev, gen))
               for m, n in VIT_LEAVES]
              + [((m, n, 2), leaf_inputs(m, n, 2, dev, gen))
                 for m, n in CNN_LEAVES])
    errs = {"matmul_fused": check_matmul_fused(leaves),
            "adam_moments": check_adam_moments(leaves)}
    check_soap_rotated_update(leaves)
    del leaves
    timings = time_kernels(dev, gen)
    launches = main_path()

    meta = {
        "matmul_fused": dict(
            route="cuda", source="src/repro_torch/kernels/csrc/matmul_fused.cu",
            replaces="src/repro/kernels/ns_ortho/kernel.py:61"),
        "adam_moments": dict(
            route="triton",
            source="src/repro_torch/kernels/soap_rotate/kernel.py",
            replaces="src/repro/kernels/soap_rotate/kernel.py:34"),
    }
    kernels = [dict(name=name, **meta[name], launches=launches[name],
                    max_abs_err=errs[name], **timings[name])
               for name in ("adam_moments", "matmul_fused")]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
