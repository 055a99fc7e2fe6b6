"""Smoke test of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's Hopper kernels from this checkout's sources (one
``nvcc`` per CUDA source, all started together, and Triton's), holds each
against its plain PyTorch version on the card at the main path's shapes
(and times kernel, plain version, a PyTorch library yardstick where one
exists, and the card's bound; the grouped kernels also one leaf or
product a launch), then drives the port's paths through
``repro_torch.api.build_experiment``, each with the launch counters set
to 0 just before it and read just after:

  * SOAP: ``local_soap`` and ``fedpac_soap`` at ViT-Tiny width, and
    ``fedpac_soap`` on the registered ``cifar_like_cnn``;
  * Sophia: ``local_sophia``, ``fedpac_sophia`` and ``fedpac_sophia`` with
    the qblock int8 wire on both channels and error feedback, at ViT-Tiny
    width, and that last one on ``cifar_like_cnn``;
  * Muon: ``local_muon`` and ``fedpac_muon`` at ViT-Tiny width (default lr
    3e-2), ``fedpac_soap`` with the Newton–Schulz refresh
    (``eig_method="ns"``) at ViT-Tiny width, and ``fedpac_muon`` on
    ``cifar_like_cnn``;
  * the SGD baselines ``fedavg`` and ``fedcm`` on ``cifar_like_cnn``, whose
    round metrics must all live on the card;
  * the low-rank wire: ``fedpac_soap_light`` (rank-4 SVD Theta upload,
    Table 6's rank) and ``fedpac_muon_light`` with the qblock delta, the
    ``lowrank_svd+qblock`` Theta chain on the bf16 wire and error
    feedback (bf16 factors into the CUDA ``quantize``), at ViT-Tiny
    width; ``scaffold``, ``fedpm_soap`` and ``fedpac_soap`` with the
    ``power_sketch`` Theta upload on ``cifar_like_cnn``, whose round
    metrics must all live on the card.

Each path fails if one of its kernels was never launched, and unless
SOAP's step is 5 ``matmul_fused`` launches (plus 15 a Newton–Schulz
refresh), Muon's step 15 (three grouped products a Newton–Schulz step),
Sophia's step one ``sophia_update`` launch and a qblock round 2
``quantize`` launches (the delta and theta encodes) and 3
``dequant_accumulate`` launches (the delta flush and theta's two; 1 with
the ``lowrank_svd+qblock`` Theta chain, whose flush peels to the
low-rank merged GEMM).  On the paths added with the low-rank wire the
round's ``upload_bytes`` must equal ``comm_bytes_per_round()``.  The
CNN runs are repeated on the CPU (plain versions) from the same weights
(and, for Sophia, the same Hutchinson probes), and the histories must
agree.  The Newton–Schulz composition is checked product by product
against ``matmul_fused``'s plain version and as a whole against its own.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero on any failure,
on a host without CUDA, and outside a checkout of the repository.
Imports nothing of JAX.
"""
import collections
import concurrent.futures
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
# Sophia paths: the repo's vision Sophia lr (benchmarks/common.py) and the
# qblock wire with error feedback.  CNN GPU-vs-CPU agreement: ten times
# the tolerances tests/test_torch_sophia.py holds the port to against the
# JAX package (cuDNN and CPU convolutions sum in other orders, and a
# roundoff-level change of a delta can move its int8 code by one quantum)
SOPHIA_LR = 2e-2
QBLOCK = dict(delta_codec="qblock", theta_codec="qblock",
              error_feedback=True)
SOPHIA_TOL = {"loss": 1e-3, "test_loss": 1e-3, "test_acc": 2 / 768}
SOPHIA_REL_TOL = {"drift": 1e-2, "norm_drift": 1e-2}
# Muon, fedavg and fedcm on the CNN, GPU vs CPU: the same ten-fold margin
# over the tolerances tests/test_torch_{muon,baselines}.py hold the port
# to against the JAX package
FIRST_ORDER_TOL, FIRST_ORDER_REL_TOL = SOPHIA_TOL, SOPHIA_REL_TOL
# fedpm_soap on the CNN runs SOAP's "ns" refresh: with the QR refresh its
# GPU-vs-CPU gap sits at SOAP's tolerances (1.09x in loss at seed 0), and
# a planted 1% fault in adam_moments lands barely above it; with "ns" the
# gap is 0.03x and the fault 1.1-1.4x (tools/gpu_cpu_gap.py, PERF.md §6)
FEDPM_OPT = {"eps": CNN_EPS, "eig_method": "ns"}
# the low-rank wire: Table 6's rank; the Muon path's codecs (on the CNN's
# Muon momentum, in the chain's quantize check, rank 4 compresses the two
# skip matrices and passes the 3 x 8 stem through dense).  SOAP's CNN
# factors (8 to 32 wide, square) take rank 8, where the 8 x 8 ones pass
# through dense and the rest compress
LIGHT_RANK = 4
CNN_SOAP_RANK = 8
MUON_LIGHT = dict(delta_codec="qblock", theta_codec="lowrank_svd+qblock",
                  wire_dtype="bf16", error_feedback=True, svd_rank=LIGHT_RANK)
# Newton–Schulz output vs its plain version: f32 against f64 of the same
# composition differs by <= 8.4e-7 at the ViT-Tiny shapes (CPU), entries
# are <= 0.3; the quintic map can grow a roundoff by up to 3.4445 a step
NS_TOL = 1e-4
CUDA_SOURCES = ("matmul_fused.cu", "sophia_update.cu", "qblock.cu",
                "fused_agg.cu")


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


def device_ms(fn, traces=3):
    """Summed device time (ms) of the CUDA kernels one call of ``fn``
    runs, from a ``torch.profiler`` trace: the work's cost on the card
    without the host's launch cost, which ``timed`` includes.  A trace
    that comes back without the device's activity (seen once on a loaded
    host) is taken again, up to ``traces`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(traces):
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
        if us > 0:
            return us / 1e3
        log("torch.profiler recorded no device time; tracing again")
    raise AssertionError(f"torch.profiler recorded no device time in "
                         f"{traces} traces")


# ------------------------------------------------------------------ build

def build_kernels(dev):
    """Every CUDA source built by its own nvcc, all started together, then
    the Triton kernel compiled by a first launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_agg import kernel as fused_agg
    from repro_torch.kernels.qblock import kernel as qblock
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    from repro_torch.kernels.sophia_update import kernel as sophia

    def one(source):
        t0 = time.perf_counter()
        path, compiler_log = build.build(source)
        return path, compiler_log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        built = list(pool.map(one, CUDA_SOURCES))
    log(f"built {len(built)} CUDA sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for path, compiler_log, secs in built:
        log(f"  {os.path.relpath(path, HERE)} with nvcc in {secs:.2f} s")
        for line in compiler_log.splitlines():
            if "ptxas" in line or "spill" in line:   # registers, smem, spills
                log("    " + line.strip())
    from repro_torch.kernels.ns_ortho.kernel import kernel_library
    lib = kernel_library()
    bm, bn, bk, stages, threads, max_p, _, table, smem = lib.config
    log(f"matmul_fused: {bm}x{bn} tiles, BK {bk}, {stages}-stage cp.async "
        f"ring ({smem} B dynamic shared memory), {threads} threads, "
        f"{lib.resident_blocks()} persistent blocks on the card, "
        f"<= {max_p} problems per launch ({table} B table)")
    lib = sophia.kernel_library()
    threads, chunk, max_l, _, table = lib.config
    log(f"sophia_update: {lib.resident_blocks()} persistent blocks of "
        f"{threads} threads, {chunk}-element chunks, <= {max_l} leaves per "
        f"launch ({table} B table)")
    lib = qblock.kernel_library()
    threads, slice_, max_l, _, table = lib.config
    log(f"quantize: {lib.resident_blocks()} persistent blocks of {threads} "
        f"threads ({slice_}-element slices of a quant block), <= "
        f"{max_l} leaves per launch ({table} B table)")
    lib = fused_agg.kernel_library()
    threads, elems, max_l, _, table = lib.config
    log(f"dequant_accumulate: {lib.resident_blocks()} persistent blocks of "
        f"{threads} threads, {elems} outputs a thread, <= {max_l} leaves "
        f"per launch ({table} B table)")
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


def step_groups(forms):
    """The products of ``gemm_forms`` over many leaves as SOAP's step
    groups them: the L/R EMAs in one group, then one group per rotation
    (5 groups of (lhs, rhs, aux, alpha, beta))."""
    phases = {"L_ema": 0, "R_ema": 0, "QlT_G": 1, "G_Qr": 2, "Ql_N": 3,
              "N_QrT": 4}
    groups = [[] for _ in range(5)]
    for name, *problem in forms:
        groups[phases[name]].append(tuple(problem))
    return groups


def gemm_error(got, a, b, aux, alpha, beta, want):
    """(max |err|, max err / bound) for the bound 2 (k+2) u (|alpha|
    |A||B| + |beta| |aux|): two f32 sums in different orders."""
    mag = abs(alpha) * torch.matmul(a.abs(), b.abs())
    if aux is not None:
        mag = mag + abs(beta) * aux.abs()
    bound = 2 * (a.shape[-1] + 2) * U * mag + 1e-30
    err = (got - want).abs()
    return float(err.max()), float((err / bound).max())


def check_matmul_fused(leaves):
    """Kernel vs plain on every form, one product per launch and as one
    grouped launch over every form of every leaf; elementwise bound 2 (k+2)
    u (|alpha| |A||B| + |beta| |aux|)."""
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_group, matmul_fused_group_plain,
    )
    worst_err, worst_ratio = 0.0, 0.0
    forms = []
    for (m, n, s), x in leaves:
        for name, a, b, aux, alpha, beta in gemm_forms(x):
            forms.append((f"{name} at (S={s}, m={m}, n={n})",
                          (a, b, aux, alpha, beta)))
    problems = [p for _, p in forms]
    before = matmul_fused.launches
    grouped = matmul_fused_group(problems)
    if matmul_fused.launches != before + 1:
        raise AssertionError(f"one group of {len(problems)} problems took "
                             f"{matmul_fused.launches - before} launches")
    for (what, p), got_g, want in zip(forms, grouped,
                                      matmul_fused_group_plain(problems)):
        got = matmul_fused(*p[:3], alpha=p[3], beta=p[4])
        for form, out in (("single", got), ("grouped", got_g)):
            err, ratio = gemm_error(out, *p, want)
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio,
                                                              ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"matmul_fused ({form}) {what} exceeds its bound: max "
                    f"err {err:.3e}, err/bound {ratio:.3f}")
    log(f"matmul_fused vs plain, single and one grouped launch of "
        f"{len(problems)} products: max |err| {worst_err:.3e}, max "
        f"err/bound {worst_ratio:.3f} (bound 2(k+2)u sum|a||b|)")
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


def model_leaf_shapes():
    """(ViT-Tiny leaf shapes, CNN leaf shapes): the per-client shapes of
    every leaf the Sophia paths update and encode."""
    from repro_torch.models.vision import init_cnn, init_vit
    from repro_torch.utils.tree import tree_leaves
    gen = torch.Generator().manual_seed(0)
    vit, _ = init_vit(gen, image_size=32, n_classes=100, device="cpu",
                      **VIT_TINY)
    cnn = init_cnn(gen, n_classes=8, width=8, blocks=2, device="cpu")
    return ([tuple(p.shape) for p in tree_leaves(vit)],
            [tuple(p.shape) for p in tree_leaves(cnn)])


def sophia_inputs(shape, dev, gen):
    """g, m normal; h with h = 0 on a third of the entries (the clip
    saturates on the sign of m') and small h on others."""
    g = torch.randn(shape, generator=gen, device=dev)
    m = torch.randn(shape, generator=gen, device=dev)
    h = torch.rand(shape, generator=gen, device=dev) * 50
    h.view(-1)[::3] = 0.0
    h.view(-1)[1::7] = 1e-3
    return g, m, h


def with_nonfinite(leaves):
    """Puts NaN and +-inf into h and g of the first leaves: h = NaN, +inf,
    -inf and g = NaN, +inf, -inf beside h = 0."""
    nonfinite = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for g, _, h in leaves[:4]:
        h.view(-1)[:3] = nonfinite
        g.view(-1)[3:6] = nonfinite
        h.view(-1)[3:6] = 0.0
    return leaves


def bits_differ(got, want):
    """Elements where got and want differ bitwise, NaN matching NaN."""
    nan = torch.isnan(want)
    same = torch.where(nan, torch.isnan(got),
                       got.view(torch.int32) == want.view(torch.int32))
    return int((~same).sum())


def check_sophia_update(stacked_shapes, dev, gen):
    """Kernel vs plain on every leaf, in one grouped launch and one leaf a
    launch: d and m' bitwise equal (the kernel rounds as the plain version
    does), NaN and +-inf in h and g included."""
    from repro_torch.kernels.sophia_update.kernel import (
        sophia_update, sophia_update_group, sophia_update_plain,
    )
    leaves = with_nonfinite([sophia_inputs(shape, dev, gen)
                             for shape in stacked_shapes])
    before = sophia_update.launches
    ds, mos = sophia_update_group(*zip(*leaves))
    if sophia_update.launches != before + 1:
        raise AssertionError(f"one group of {len(leaves)} leaves took "
                             f"{sophia_update.launches - before} launches")
    saturated = nan = 0
    for (g, m, h), d, mo in zip(leaves, ds, mos):
        want = sophia_update_plain(g, m, h)
        saturated += int((want[0].abs() == 0.05).sum())
        nan += int(torch.isnan(want[0]).sum())
        single = sophia_update(g, m, h)
        for form, got in (("grouped", (d, mo)), ("single", single)):
            for name, gv, wv in zip(("d", "m"), got, want):
                bad = bits_differ(gv, wv)
                if bad:
                    raise AssertionError(
                        f"sophia_update ({form}) {name} at {tuple(g.shape)}: "
                        f"{bad} values differ from the plain version")
    log(f"sophia_update vs plain on {len(leaves)} leaves, grouped (one "
        f"launch) and one leaf a launch: d and m' bitwise equal; "
        f"{saturated} clipped entries, {nan} NaN (NaN/inf in h and g)")
    return 0.0


def tied_rows(rows, n, dev, gen, block=128):
    """(rows, n) with exact k + 0.5 ties in the first block (scale 1/8),
    an all-zero second block where n allows, and a ragged tail whenever
    n % block != 0."""
    x = torch.randn((rows, n), generator=gen, device=dev) * 3
    b0 = min(block, n)
    k = torch.randint(-126, 126, (rows, b0), generator=gen, device=dev)
    x[:, :b0] = (k + 0.5) * 0.125
    x[:, 0] = 127 * 0.125
    if n > 2 * block:
        x[:, block:2 * block] = 0.0
    return x


def quantize_agrees(label, xs):
    """Kernel vs plain on the (rows, n) f32 leaves ``xs``, in one grouped
    launch and one leaf a launch: q and scale bitwise equal (the codes of
    a block whose scale is NaN or inf, a NaN cast to int8, are not
    compared).  Returns the number of such blocks."""
    from repro_torch.kernels.qblock.kernel import (
        quantize, quantize_group, quantize_plain,
    )
    before = quantize.launches
    grouped = quantize_group(xs)
    if quantize.launches != before + 1:
        raise AssertionError(f"{label}: one group of {len(xs)} leaves took "
                             f"{quantize.launches - before} launches")
    special = 0
    for x, got_g in zip(xs, grouped):
        wq, ws = quantize_plain(x)
        ok = torch.isfinite(ws)
        special += int((~ok).sum())
        ok_q = ok.repeat_interleave(128, dim=1)[:, :x.shape[1]]
        for form, (q, s) in (("grouped", got_g), ("single", quantize(x))):
            bad = int((q[ok_q] != wq[ok_q]).sum()) + bits_differ(s, ws)
            if bad:
                raise AssertionError(
                    f"{label}: quantize ({form}) at {tuple(x.shape)}: {bad} "
                    "values differ from the plain version")
    return special


def check_quantize(stacked_shapes, dev, gen):
    """Kernel vs plain on every leaf (rows = clients), in one grouped
    launch and one leaf a launch: q and scale bitwise equal.  The first
    leaves hold NaN and +-inf, whose blocks must get the plain version's
    NaN or inf scale."""
    xs = [tied_rows(shape[0], math.prod(shape[1:]), dev, gen)
          for shape in stacked_shapes]
    nonfinite = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for x in xs[:4]:
        x.view(-1)[-3:] = nonfinite
    ragged = sum(x.shape[1] % 128 != 0 for x in xs)
    special = quantize_agrees("model leaves", xs)
    log(f"quantize vs plain on {len(xs)} leaves, grouped (one launch) and "
        f"one leaf a launch: q and scale bitwise equal ({ragged} leaves "
        f"with a ragged tail, ties and zero blocks in each; {special} "
        "blocks with NaN or inf, scales equal)")
    return 0.0


def check_chain_quantize(dev, gen):
    """``quantize`` on what the ``lowrank_svd+qblock`` Theta chain of
    ``fedpac_muon_light`` hands it: Muon's momentum (normals) at
    ViT-Tiny (S=5; 48 matrices, all low-rank at rank 4) and on the CNN
    (S=2; its stem conv, 3 x 8 matrices, passes through dense), encoded
    by the chain's first stage (rank 4, bf16 wire), its bf16 payloads cast
    to f32 as ``QBlock`` casts them.  Kernel vs plain bitwise, grouped and
    one leaf a launch, then the chain's ``QBlock`` stage (one launch)
    against the plain version of the same rows."""
    from repro_torch.core.algorithms import resolve, zero_theta
    from repro_torch.core.transport import TransportConfig, resolve_codec
    from repro_torch.core.transport.chain import _payloads
    from repro_torch.core.transport.qblock import _rows
    from repro_torch.kernels.qblock.kernel import quantize, quantize_plain
    from repro_torch.models.vision import init_cnn, init_vit
    from repro_torch.utils.tree import tree_leaves, tree_map
    pgen = torch.Generator().manual_seed(0)
    vit, _ = init_vit(pgen, image_size=32, n_classes=100, device=dev,
                      **VIT_TINY)
    cnn = init_cnn(pgen, n_classes=8, width=8, blocks=2, device=dev)
    opt = resolve("fedpac_muon_light").make_optimizer()
    chain = resolve_codec(MUON_LIGHT["theta_codec"], TransportConfig(
        rank=LIGHT_RANK, wire_dtype=MUON_LIGHT["wire_dtype"]))
    kinds, n_rows = collections.Counter(), 0
    for label, params, s in (("ViT-Tiny", vit, S_VIT), ("CNN", cnn, 2)):
        theta = tree_map(
            lambda t: torch.randn((s, *t.shape), generator=gen, device=dev),
            zero_theta(opt, params))
        inner = chain.stages[0].encode(theta)
        kinds.update(m.kind for m in tree_leaves(inner.leaves))
        payloads = _payloads(inner.leaves)
        flat = tree_leaves(payloads)
        if {x.dtype for x in flat} != {torch.bfloat16}:
            raise AssertionError(f"{label} chain payloads: dtypes "
                                 f"{ {x.dtype for x in flat} }, want bf16")
        rows = [_rows(x) for x in flat]
        n_rows += len(rows)
        quantize_agrees(f"{label} chain payloads", rows)
        before = quantize.launches
        msg = chain.stages[1].encode(payloads)
        if quantize.launches != before + 1:
            raise AssertionError(f"{label}: the chain's qblock stage took "
                                 f"{quantize.launches - before} launches")
        for x, m in zip(rows, tree_leaves(msg.leaves)):
            wq, ws = quantize_plain(x)
            bad = int((m.parts["q"] != wq).sum()) + bits_differ(
                m.parts["scale"], ws)
            if bad:
                raise AssertionError(
                    f"{label} chain qblock stage at {tuple(x.shape)}: {bad} "
                    "values differ from the plain version")
    if set(kinds) != {"lowrank", "dense"}:
        raise AssertionError(f"chain leaf kinds {dict(kinds)}, want "
                             "lowrank and dense")
    log(f"quantize on the lowrank_svd+qblock chain's payloads (Muon "
        f"momentum at ViT-Tiny and the CNN, rank {LIGHT_RANK}, bf16 wire: "
        f"{kinds['lowrank']} low-rank and {kinds['dense']} dense leaves, "
        f"{n_rows} bf16 payloads as f32 rows): grouped, one leaf a launch "
        "and the chain's qblock stage bitwise equal to the plain version")


def check_dequant_accumulate(stacked_shapes, dev, gen):
    """Kernel vs plain on every leaf, in one grouped launch and one leaf a
    launch: within 4 B u sum_i |w_i s_i q_i|."""
    from repro_torch.kernels.fused_agg.kernel import (
        dequant_accumulate, dequant_accumulate_group,
        dequant_accumulate_plain,
    )
    from repro_torch.kernels.qblock.kernel import quantize
    worst, worst_ratio = 0.0, 0.0
    by_clients = {}
    for shape in stacked_shapes:
        b, n = shape[0], math.prod(shape[1:])
        by_clients.setdefault(b, []).append(
            quantize(torch.randn((b, n), generator=gen, device=dev)))
    for b, coded in by_clients.items():
        w = torch.rand(b, generator=gen, device=dev) + 0.2
        before = dequant_accumulate.launches
        grouped = dequant_accumulate_group(*zip(*coded), w)
        if dequant_accumulate.launches != before + 1:
            raise AssertionError(
                f"one group of {len(coded)} leaves took "
                f"{dequant_accumulate.launches - before} launches")
        for (q, s), got_g in zip(coded, grouped):
            n = q.shape[1]
            want = dequant_accumulate_plain(q, s, w)
            mag = ((w[:, None] * s).repeat_interleave(128, dim=1)[:, :n]
                   .abs() * q.float().abs()).sum(0)
            for form, got in (("grouped", got_g),
                              ("single", dequant_accumulate(q, s, w))):
                err = (got - want).abs()
                ratio = float((err / (4 * b * U * mag + 1e-30)).max())
                worst = max(worst, float(err.max()))
                worst_ratio = max(worst_ratio, ratio)
                if ratio > 1.0:
                    raise AssertionError(
                        f"dequant_accumulate ({form}) at (B={b}, n={n}): max "
                        f"err {float(err.max()):.3e}, err/bound {ratio:.3f}")
    log(f"dequant_accumulate vs plain on {len(stacked_shapes)} leaves, "
        f"grouped ({len(by_clients)} launches, one per cohort size) and one "
        f"leaf a launch: max |err| {worst:.3e}, max err/bound "
        f"{worst_ratio:.3f} (bound 4Bu sum|w s q|)")
    return worst


def vit_matrix_leaves(dev, gen):
    """Muon's 48 ViT-Tiny matrix leaves at S=5 (momentum-like normals)."""
    return [torch.randn((S_VIT, m, n), generator=gen, device=dev)
            for _ in range(VIT_TINY["layers"]) for m, n in VIT_LEAVES]


def check_newton_schulz(mats):
    """The composition on Muon's ViT-Tiny step: 15 ``matmul_fused``
    launches, each of its products (captured with the kernel's own inputs)
    within 2(k+2)u sum|a||b| of the plain ``matmul_fused``, and the output
    within ``NS_TOL`` of ``newton_schulz_group_plain``."""
    from repro_torch.kernels.ns_ortho import ops as ns_ops
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_group_plain,
    )
    captured = []
    real = ns_ops.matmul_fused_group

    def spy(problems):
        outs = real(problems)
        captured.append((problems, outs))
        return outs

    before = matmul_fused.launches
    ns_ops.matmul_fused_group = spy
    try:
        got = ns_ops.newton_schulz_group(mats)
    finally:
        ns_ops.matmul_fused_group = real
    made = matmul_fused.launches - before
    if made != 15 or len(captured) != 15:
        raise AssertionError(f"newton_schulz on {len(mats)} matrices: "
                             f"{made} launches in {len(captured)} group "
                             "calls, want 15")
    worst_ratio = 0.0
    for problems, outs in captured:
        for p, out, want in zip(problems, outs,
                                matmul_fused_group_plain(problems)):
            err, ratio = gemm_error(out, *p, want)
            worst_ratio = max(worst_ratio, ratio)
            if ratio > 1.0:
                raise AssertionError(
                    f"newton_schulz product {tuple(p[0].shape)} @ "
                    f"{tuple(p[1].shape)} exceeds its bound: max err "
                    f"{err:.3e}, err/bound {ratio:.3f}")
    worst = 0.0
    for g, x, want in zip(mats, got, ns_ops.newton_schulz_group_plain(mats)):
        if x.shape != g.shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"newton_schulz output {tuple(x.shape)} for "
                                 f"{tuple(g.shape)}: wrong shape or "
                                 "non-finite")
        worst = max(worst, float((x - want).abs().max()))
    if worst > NS_TOL:
        raise AssertionError(f"newton_schulz vs plain: max |err| "
                             f"{worst:.3e} > {NS_TOL}")
    log(f"newton_schulz on {len(mats)} ViT-Tiny matrices (S={S_VIT}): 15 "
        f"launches; each of {sum(len(p) for p, _ in captured)} products "
        f"within its bound (max err/bound {worst_ratio:.3f}, bound "
        f"2(k+2)u sum|a||b|); output vs plain max |err| {worst:.3e} "
        f"(tol {NS_TOL})")
    return worst


# ----------------------------------------------------------------- timing

def time_kernels(dev, gen):
    """One local SOAP step's worth of each kernel's work on ViT-Tiny at
    S=5 (12 blocks x 4 matrix leaves, refresh excluded), timed for the
    kernel, the plain version and a PyTorch library call, beside the
    card's bound for the same work.  ``ms`` (CUDA events around the
    loop of launches) includes the host's launch rate; ``device_ms`` and
    its plain and library counterparts are the device time alone.
    ``matmul_fused`` is timed as SOAP's step runs it (5 grouped launches:
    ``ms``, ``device_ms``) and one product per launch (288 launches:
    ``single_ms``, ``single_device_ms``); its library time is cuBLAS's
    ``bmm``/``baddbmm``, one call per product."""
    from repro_torch.kernels.ns_ortho.kernel import (
        matmul_fused, matmul_fused_group, matmul_fused_plain,
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

    groups = step_groups(forms)

    def grouped():
        for group in groups:
            matmul_fused_group(group)

    out = {}
    t, d = {}, {}
    for key, fn in (("g", grouped), ("k", gemm(matmul_fused)),
                    ("p", gemm(matmul_fused_plain)), ("l", gemm(library))):
        t[key], d[key] = timed(fn), device_ms(fn)
    out["matmul_fused"] = dict(
        ms=t["g"], plain_ms=t["p"], library_ms=t["l"], bound_ms=gemm_bound,
        bound_by=gemm_by, device_ms=d["g"], plain_device_ms=d["p"],
        library_device_ms=d["l"], single_ms=t["k"], single_device_ms=d["k"])
    log(f"matmul_fused, one local step of ViT-Tiny (S={S_VIT}, "
        f"{len(forms)} products, {flops / 1e9:.1f} GFLOP, "
        f"{bytes_ / 1e6:.1f} MB): grouped ({len(groups)} launches) "
        f"{t['g']:.3f} ms, single ({len(forms)} launches) {t['k']:.3f} ms, "
        f"plain {t['p']:.3f} ms, torch.bmm/baddbmm {t['l']:.3f} ms; device "
        f"time {d['g']:.3f} / {d['k']:.3f} / {d['p']:.3f} / {d['l']:.3f} "
        f"ms; bound {gemm_bound:.3f} ms ({gemm_by})")
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


def time_sophia_and_wire_kernels(vit_shapes, dev, gen):
    """The Sophia and qblock kernels' work on ViT-Tiny at S=5 (all 127
    leaves): ``sophia_update`` for one local step, ``quantize`` and
    ``dequant_accumulate`` for one upload channel of one round.  Timed
    as ``time_kernels`` times the SOAP kernels: each as the path runs it
    (one grouped launch: ``ms``, ``device_ms``) and one leaf a launch
    (127 launches: ``single_ms``, ``single_device_ms``).  No single
    PyTorch call computes any of the three functions, so there is no
    library time."""
    from repro_torch.kernels.fused_agg.kernel import (
        dequant_accumulate, dequant_accumulate_group,
        dequant_accumulate_plain,
    )
    from repro_torch.kernels.qblock.kernel import (
        n_blocks, quantize, quantize_group, quantize_plain,
    )
    from repro_torch.kernels.sophia_update.kernel import (
        sophia_update, sophia_update_group, sophia_update_plain,
    )
    shapes = [(S_VIT, *shp) for shp in vit_shapes]
    soph = [sophia_inputs(shp, dev, gen) for shp in shapes]
    soph_cols = tuple(zip(*soph))
    rows = [torch.randn((S_VIT, math.prod(shp)), generator=gen, device=dev)
            * 1e-3 for shp in vit_shapes]
    coded = [quantize(x) for x in rows]
    coded_cols = tuple(zip(*coded))
    w = torch.ones(S_VIT, device=dev)
    elems = sum(x.numel() for x in rows)
    scales = sum(S_VIT * n_blocks(x.shape[1], 128) for x in rows)
    n_out = elems // S_VIT
    work = {
        "sophia_update": dict(
            fns=[lambda: sophia_update_group(*soph_cols),
                 lambda: [sophia_update_plain(*x) for x in soph],
                 lambda: [sophia_update(*x) for x in soph]],
            bytes=20 * elems, flops=6 * elems,
            what=f"one local step, {len(soph)} leaves, "
                 f"{elems / 1e6:.2f} M elements"),
        "quantize": dict(
            fns=[lambda: quantize_group(rows),
                 lambda: [quantize_plain(x) for x in rows],
                 lambda: [quantize(x) for x in rows]],
            bytes=4 * elems + elems + 4 * scales, flops=5 * elems,
            what=f"one channel of one round, {len(rows)} leaves, "
                 f"{elems / 1e6:.2f} M elements"),
        "dequant_accumulate": dict(
            fns=[lambda: dequant_accumulate_group(*coded_cols, w),
                 lambda: [dequant_accumulate_plain(q, s, w)
                          for q, s in coded],
                 lambda: [dequant_accumulate(q, s, w) for q, s in coded]],
            bytes=elems + 4 * scales + 4 * S_VIT + 4 * n_out,
            flops=2 * elems + scales,
            what=f"one channel of one round, {len(coded)} leaves, "
                 f"{elems / 1e6:.2f} M int8 values from {S_VIT} clients"),
    }
    out = {}
    for name, x in work.items():
        t = [timed(fn) for fn in x["fns"]]
        d = [device_ms(fn) for fn in x["fns"]]
        by_bytes = x["bytes"] / HBM_BYTES_PER_S
        by_ops = x["flops"] / FP32_FLOPS
        bound = max(by_bytes, by_ops) * 1e3
        by = "bytes" if by_bytes >= by_ops else "operations"
        out[name] = dict(
            ms=t[0], plain_ms=t[1], library_ms=None, bound_ms=bound,
            bound_by=by, device_ms=d[0], plain_device_ms=d[1],
            library_device_ms=None)
        single = ""
        if len(t) > 2:
            out[name].update(single_ms=t[2], single_device_ms=d[2])
            single = (f", one leaf a launch {t[2]:.3f} ms ({d[2]:.3f} ms "
                      "device)")
        log(f"{name}, {x['what']} ({x['bytes'] / 1e6:.1f} MB): kernel "
            f"{t[0]:.3f} ms, plain {t[1]:.3f} ms; device time {d[0]:.3f} / "
            f"{d[1]:.3f} ms; bound {bound:.3f} ms ({by}){single}")
    return out


def time_newton_schulz(mats):
    """One ViT-Tiny Muon step's orthogonalisation at S=5 (48 matrices, 5
    steps): the composition as Muon runs it (15 grouped launches), its
    plain version, and cuBLAS through ``torch.bmm``/``baddbmm`` (one call
    a product, 720 calls), beside the card's bound for the same work
    (each input read and each output written once; the products'
    operations at the FP32 rate)."""
    from repro_torch.kernels.ns_ortho.ops import (
        NS_COEFFS, newton_schulz_group, newton_schulz_group_plain,
    )
    a, b, c = NS_COEFFS

    def library():
        for g in mats:
            x = g.transpose(1, 2) if g.shape[1] > g.shape[2] else g
            x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
                     + 1e-7)
            for _ in range(5):
                aa = torch.bmm(x, x.transpose(1, 2))
                bb = torch.baddbmm(aa, aa, aa, beta=b, alpha=c)
                x = torch.baddbmm(x, bb, x, beta=a)

    flops = 0
    for g in mats:
        s, m, n = g.shape
        m, n = min(m, n), max(m, n)
        # X X^T (no epilogue), then c A A + b A (a multiply and an FMA
        # an element), then B X + a X (one FMA an element)
        flops += 5 * (2 * s * m * m * n
                      + 2 * s * m * m * m + 3 * s * m * m
                      + 2 * s * m * m * n + 2 * s * m * n)
    bytes_ = 8 * sum(g.numel() for g in mats)
    bound = max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    by = "bytes" if bytes_ / HBM_BYTES_PER_S > flops / FP32_FLOPS \
        else "operations"
    fns = {"k": lambda: newton_schulz_group(mats),
           "p": lambda: newton_schulz_group_plain(mats), "l": library}
    t = {k: timed(fn) for k, fn in fns.items()}
    d = {k: device_ms(fn) for k, fn in fns.items()}
    log(f"newton_schulz, one Muon step of ViT-Tiny (S={S_VIT}, {len(mats)} "
        f"matrices, 5 steps, {flops / 1e9:.1f} GFLOP): grouped (15 launches) "
        f"{t['k']:.3f} ms, plain {t['p']:.3f} ms, torch.bmm/baddbmm (720 "
        f"calls) {t['l']:.3f} ms; device time {d['k']:.3f} / {d['p']:.3f} / "
        f"{d['l']:.3f} ms; bound {bound:.3f} ms ({by})")
    return {"newton_schulz": dict(
        ms=t["k"], plain_ms=t["p"], library_ms=t["l"], bound_ms=bound,
        bound_by=by, device_ms=d["k"], plain_device_ms=d["p"],
        library_device_ms=d["l"])}


# -------------------------------------------------------------- main path

def vit_tiny_spec():
    from repro_torch.api import resolve_scenario
    base = resolve_scenario("cifar_like_vit")
    return dataclasses.replace(
        base, name="cifar_like_vit_tiny",
        source_kwargs=dict(base.source_kwargs, image_size=32, n_classes=100),
        model_kwargs=VIT_TINY)


def kernel_wrappers():
    from repro_torch.kernels.fused_agg.kernel import dequant_accumulate
    from repro_torch.kernels.ns_ortho.kernel import matmul_fused
    from repro_torch.kernels.qblock.kernel import quantize
    from repro_torch.kernels.soap_rotate.kernel import adam_moments
    from repro_torch.kernels.sophia_update.kernel import sophia_update
    return {"adam_moments": adam_moments, "matmul_fused": matmul_fused,
            "sophia_update": sophia_update, "quantize": quantize,
            "dequant_accumulate": dequant_accumulate}


def run_experiment(label, exp, expect=()):
    """Drive ``exp`` for its rounds with every launch counter set to 0
    just before and read just after; fails if a kernel of ``expect`` was
    never launched.  Returns (history, launches)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    for _ in range(exp.fed.rounds):
        t0 = time.perf_counter()
        rec = exp.run_round()   # ends in host reads of the metrics
        dt = time.perf_counter() - t0
        log(f"{label} round {rec['round']}: {dt:.2f} s "
            + json.dumps({k: rec[k] for k in sorted(rec)}))
        for k in ("loss", "test_loss", "drift", "norm_drift"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"{label}: non-finite {k} {rec[k]}")
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"{label}: launches " + json.dumps(launches))
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was never launched")
    return exp.history, launches


def metrics_on_card(exp):
    """Wraps ``exp``'s round so that it fails unless every tensor metric of
    the round (drift and norm_drift included) lives on the card."""
    inner = exp.round_fn

    def round_fn(*args):
        out = inner(*args)
        off = {k: str(v.device) for k, v in out[2].items()
               if isinstance(v, torch.Tensor) and v.device.type != "cuda"}
        missing = {"drift", "norm_drift", "loss", "beta"} - {
            k for k, v in out[2].items() if isinstance(v, torch.Tensor)}
        if off or missing:
            raise AssertionError(f"round metrics off the card: {off}, not "
                                 f"tensors: {sorted(missing)}")
        return out

    exp.round_fn = round_fn
    return exp


def compare_histories(label, want, got, tol, rel_tol):
    for r, (w, g) in enumerate(zip(want, got)):
        for k, t in tol.items():
            if abs(w[k] - g[k]) > t:
                raise AssertionError(f"{label} GPU vs CPU round {r + 1} {k}: "
                                     f"{g[k]} vs {w[k]} (tol {t})")
        for k, t in rel_tol.items():
            if abs(w[k] - g[k]) > t * abs(w[k]):
                raise AssertionError(f"{label} GPU vs CPU round {r + 1} {k}: "
                                     f"{g[k]} vs {w[k]} (rel tol {t})")
    log(f"{label}: GPU history agrees with the CPU plain path")


def with_host_probes(exp):
    """Rebuild ``exp``'s round with Hutchinson probes drawn on the host
    from the round's seed and step, then moved to the run's device, so a
    GPU run and a CPU run of the same seed use the same probes (a CUDA
    and a CPU generator give different bits)."""
    from repro_torch.core.algorithms import build_round_fn
    from repro_torch.core.client import rademacher_like
    from repro_torch.utils.tree import tree_map
    s = max(1, int(round(exp.fed.n_clients * exp.fed.participation)))
    like = tree_map(lambda p: torch.empty((s, *p.shape)), exp.server.params)

    def probe_fn(seed, k):
        gen = torch.Generator().manual_seed(seed * 1000 + k)
        return tree_map(lambda u: u.to(exp.device), rademacher_like(like,
                                                                    gen))

    exp.round_fn = build_round_fn(
        exp.spec, exp.loss_fn, exp.opt, lr=exp.lr,
        local_steps=exp.fed.local_steps,
        beta=exp.spec.resolve_beta(exp.fed.beta),
        hessian_freq=exp.fed.hessian_freq, server_lr=exp.fed.server_lr,
        transport=exp.transport, executor=exp.fed.executor_config(),
        n_clients=exp.fed.n_clients, probe_fn=probe_fn)
    return exp


def check_qblock_bytes(label, exp, hist, shapes):
    """The wire carries n int8 + ceil(n/128) f32 scales per leaf on each
    of the two channels (Theta = {h} has the params' shapes)."""
    want = 2 * sum(math.prod(s) + 4 * -(-math.prod(s) // 128)
                   for s in shapes)
    got = {hist[-1]["upload_bytes"], exp.comm_bytes_per_round()}
    if got != {want}:
        raise AssertionError(f"{label}: upload bytes {got}, want {want}")
    log(f"{label}: {want} upload bytes per client per round (int8 + "
        "scales on both channels)")


def check_wire_bytes(label, exp, hist):
    """The round's measured upload bytes equal the transport's count for
    one client (``comm_bytes_per_round`` encodes one client's trees: for
    the low-rank codecs, real SVDs or sketches, timed here)."""
    t0 = time.perf_counter()
    want = exp.comm_bytes_per_round()
    secs = time.perf_counter() - t0
    got = {r["upload_bytes"] for r in hist}
    if got != {want}:
        raise AssertionError(f"{label}: upload bytes {got}, want {want}")
    log(f"{label}: {want} upload bytes per client per round "
        f"(comm_bytes_per_round in {secs:.3f} s)")
    return want


def check_leaf_kinds(label, exp):
    """The Theta channel's first (low-rank) stage compresses some leaves
    of one client's Theta and passes others through dense."""
    from repro_torch.core.transport.chain import Chain
    from repro_torch.utils.tree import tree_leaves, tree_map
    codec = exp.transport.theta
    if isinstance(codec, Chain):
        codec = codec.stages[0]
    msg = codec.encode(tree_map(lambda x: x[None], exp.server.theta))
    kinds = collections.Counter(m.kind for m in tree_leaves(msg.leaves))
    if len(kinds) != 2 or "dense" not in kinds:
        raise AssertionError(f"{label}: Theta leaf kinds {dict(kinds)}, "
                             "want a low-rank kind and dense")
    log(f"{label}: Theta leaves " + json.dumps(dict(kinds)))


def main_paths(vit_shapes, cnn_shapes):
    """Drives every path; returns each kernel's launches summed over the
    paths that ran it (each counted from 0)."""
    from repro_torch.api import build_experiment, materialize
    from repro_torch.convert import params_from_numpy, params_to_numpy

    spec = vit_tiny_spec()
    vit = materialize(spec, seed=0, n_clients=spec.n_clients, device="cuda")
    cnn = materialize("cifar_like_cnn", seed=0, device="cuda")
    cpu_params = params_from_numpy(params_to_numpy(cnn.params), "cpu")
    cnn_cpu = dataclasses.replace(
        materialize("cifar_like_cnn", seed=0, device="cpu"),
        params=cpu_params)
    soap_k = ("matmul_fused", "adam_moments")
    wire_k = ("sophia_update", "quantize", "dequant_accumulate")
    total = dict.fromkeys(kernel_wrappers(), 0)
    # newton_schulz launches no kernel of its own: its row carries the
    # matmul_fused launches of the Muon paths, where every matmul_fused
    # launch is a Newton-Schulz product
    total["newton_schulz"] = 0

    def drive(label, exp, expect, mf_step=5, ns_step=0, ns_refresh=0,
              dq_round=3):
        hist, launches = run_experiment(label, exp, expect)
        for name, n in launches.items():
            total[name] += n
        if ns_step and not mf_step:
            total["newton_schulz"] += launches["matmul_fused"]
        # SOAP's step is 5 grouped launches (the EMAs, 4 rotations), and a
        # Newton–Schulz refresh (once a round at K = precond_freq = 10) 15
        # more; Muon's step 15 (3 grouped products a Newton–Schulz step);
        # Sophia's step one; a qblock round of an aligned algorithm
        # encodes twice (delta, theta; a chain's qblock stage encodes its
        # whole payload tree in one launch) and flushes 3 times (delta,
        # theta twice; a lowrank_svd+qblock theta peels to the low-rank
        # GEMM, so only the delta's)
        steps = exp.fed.local_steps * exp.fed.rounds
        ns = ns_step * steps + ns_refresh * exp.fed.rounds
        for name, want, what in (
                ("matmul_fused", mf_step * steps + ns,
                 f"{mf_step + ns_step} per local step + {ns_refresh} per "
                 "refresh"),
                ("sophia_update", steps, "1 per local step"),
                ("quantize", 2 * exp.fed.rounds, "2 per round"),
                ("dequant_accumulate", dq_round * exp.fed.rounds,
                 f"{dq_round} per round")):
            if name in expect and launches[name] != want:
                raise AssertionError(f"{label}: {launches[name]} {name} "
                                     f"launches, want {want} ({what})")
        return hist

    # SOAP
    vit_soap = {}
    for algo in ("local_soap", "fedpac_soap"):
        vit_soap[algo] = drive(f"vit_tiny {algo}", build_experiment(
            algo, scenario=vit, participation=0.5, rounds=ROUNDS), soap_k)
    cnn_gpu = drive("cifar_like_cnn fedpac_soap", build_experiment(
        "fedpac_soap", scenario=cnn, rounds=ROUNDS,
        opt_kwargs={"eps": CNN_EPS}), soap_k)
    ref, _ = run_experiment(
        "cifar_like_cnn fedpac_soap (cpu reference)", build_experiment(
            "fedpac_soap", scenario=cnn_cpu, rounds=ROUNDS, device="cpu",
            opt_kwargs={"eps": CNN_EPS}))
    compare_histories("cifar_like_cnn fedpac_soap", ref, cnn_gpu, CNN_TOL,
                      CNN_REL_TOL)

    # Sophia, dense and on the qblock wire with error feedback
    sophia_kw = dict(participation=0.5, rounds=ROUNDS, lr=SOPHIA_LR,
                     hessian_freq=10)
    for algo in ("local_sophia", "fedpac_sophia"):
        drive(f"vit_tiny {algo}", build_experiment(
            algo, scenario=vit, **sophia_kw), ("sophia_update",))
    label = "vit_tiny fedpac_sophia qblock+ef"
    exp = build_experiment("fedpac_sophia", scenario=vit, **sophia_kw,
                           **QBLOCK)
    hist = drive(label, exp, wire_k)
    check_qblock_bytes(label, exp, hist, vit_shapes)

    label = "cifar_like_cnn fedpac_sophia qblock+ef"
    cnn_kw = dict(rounds=ROUNDS, lr=SOPHIA_LR, hessian_freq=10, **QBLOCK)
    exp = with_host_probes(build_experiment("fedpac_sophia", scenario=cnn,
                                            **cnn_kw))
    cnn_gpu = drive(label, exp, wire_k)
    check_qblock_bytes(label, exp, cnn_gpu, cnn_shapes)
    ref, _ = run_experiment(f"{label} (cpu reference)", with_host_probes(
        build_experiment("fedpac_sophia", scenario=cnn_cpu, device="cpu",
                         **cnn_kw)))
    compare_histories(label, ref, cnn_gpu, SOPHIA_TOL, SOPHIA_REL_TOL)

    # Muon on the grouped Newton-Schulz composition, and SOAP's NS refresh
    muon_k = ("matmul_fused", "adam_moments")
    for algo in ("local_muon", "fedpac_muon"):
        exp = build_experiment(algo, scenario=vit, participation=0.5,
                               rounds=ROUNDS)
        if exp.lr != 3e-2:
            raise AssertionError(f"{algo}: lr {exp.lr}, want Muon's 3e-2")
        drive(f"vit_tiny {algo}", exp, muon_k, mf_step=0, ns_step=15)
    drive("vit_tiny fedpac_soap eig_method=ns", build_experiment(
        "fedpac_soap", scenario=vit, participation=0.5, rounds=ROUNDS,
        opt_kwargs={"eig_method": "ns"}), muon_k, ns_refresh=15)

    # the CNN against the CPU path: Muon (its stem conv flattens tall, so
    # it is orthogonalised as its transpose), then the SGD baselines
    for algo, expect, counts in (
            ("fedpac_muon", muon_k, dict(mf_step=0, ns_step=15)),
            ("fedavg", (), {}), ("fedcm", (), {})):
        label = f"cifar_like_cnn {algo}"
        cnn_gpu = drive(label, metrics_on_card(build_experiment(
            algo, scenario=cnn, rounds=ROUNDS)), expect, **counts)
        ref, _ = run_experiment(f"{label} (cpu reference)", build_experiment(
            algo, scenario=cnn_cpu, rounds=ROUNDS, device="cpu"))
        compare_histories(label, ref, cnn_gpu, FIRST_ORDER_TOL,
                          FIRST_ORDER_REL_TOL)

    # the low-rank wire at ViT-Tiny: SOAP with the rank-4 SVD Theta
    # upload, and Muon with the qblock delta, the lowrank_svd+qblock Theta
    # chain on the bf16 wire and error feedback
    light_rounds = 2
    label = "vit_tiny fedpac_soap_light"
    exp = build_experiment("fedpac_soap_light", scenario=vit,
                           participation=0.5, rounds=light_rounds,
                           svd_rank=LIGHT_RANK)
    light = check_wire_bytes(label, exp, drive(label, exp, soap_k))
    dense = vit_soap["fedpac_soap"][-1]["upload_bytes"]
    log(f"Table 6 ratio at ViT-Tiny (round lines): fedpac_soap_light / "
        f"fedpac_soap upload bytes per client = {light} / {dense} = "
        f"{light / dense:.4f}")
    label = "vit_tiny fedpac_muon_light qblock+lowrank_svd+qblock bf16 ef"
    exp = build_experiment("fedpac_muon_light", scenario=vit,
                           participation=0.5, rounds=light_rounds,
                           **MUON_LIGHT)
    check_wire_bytes(label, exp, drive(
        label, exp, muon_k + ("quantize", "dequant_accumulate"), mf_step=0,
        ns_step=15, dq_round=1))

    # SCAFFOLD, FedPM and the low-rank Theta uploads on the CNN, against
    # the CPU path
    for algo, kw, expect, counts, tol in (
            ("scaffold", {}, (), {}, (FIRST_ORDER_TOL, FIRST_ORDER_REL_TOL)),
            ("fedpm_soap", dict(opt_kwargs=FEDPM_OPT), soap_k,
             dict(ns_refresh=15), (CNN_TOL, CNN_REL_TOL)),
            ("fedpac_soap", dict(theta_codec="power_sketch",
                                 svd_rank=CNN_SOAP_RANK,
                                 opt_kwargs={"eps": CNN_EPS}), soap_k, {},
             (CNN_TOL, CNN_REL_TOL)),
            ("fedpac_soap_light", dict(svd_rank=CNN_SOAP_RANK,
                                       opt_kwargs={"eps": CNN_EPS}),
             soap_k, {}, (CNN_TOL, CNN_REL_TOL))):
        label = " ".join(["cifar_like_cnn", algo] + [
            f"{k}={v}" for k, v in {**kw, **kw.get("opt_kwargs", {})}.items()
            if k in ("theta_codec", "eig_method")])
        exp = metrics_on_card(build_experiment(algo, scenario=cnn,
                                               rounds=ROUNDS, **kw))
        cnn_gpu = drive(label, exp, expect, **counts)
        if "svd_rank" in kw:
            check_leaf_kinds(label, exp)
        check_wire_bytes(label, exp, cnn_gpu)
        ref, _ = run_experiment(f"{label} (cpu reference)", build_experiment(
            algo, scenario=cnn_cpu, rounds=ROUNDS, device="cpu", **kw))
        compare_histories(label, ref, cnn_gpu, *tol)
    return total


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
    vit_shapes, cnn_shapes = model_leaf_shapes()
    stacked = ([(S_VIT, *s) for s in vit_shapes]
               + [(2, *s) for s in cnn_shapes])
    errs["sophia_update"] = check_sophia_update(stacked, dev, gen)
    errs["quantize"] = check_quantize(stacked, dev, gen)
    check_chain_quantize(dev, gen)
    errs["dequant_accumulate"] = check_dequant_accumulate(stacked, dev, gen)
    mats = vit_matrix_leaves(dev, gen)
    errs["newton_schulz"] = check_newton_schulz(mats)
    timings = time_kernels(dev, gen)
    timings.update(time_sophia_and_wire_kernels(vit_shapes, dev, gen))
    timings.update(time_newton_schulz(mats))
    del mats
    launches = main_paths(vit_shapes, cnn_shapes)

    meta = {
        "adam_moments": dict(
            route="triton",
            source="src/repro_torch/kernels/soap_rotate/kernel.py",
            replaces="src/repro/kernels/soap_rotate/kernel.py:34"),
        "matmul_fused": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/matmul_fused.cu",
            replaces="src/repro/kernels/ns_ortho/kernel.py:61"),
        "sophia_update": dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/sophia_update.cu",
            replaces="src/repro/kernels/sophia_update/kernel.py:31"),
        "quantize": dict(
            route="cuda", source="src/repro_torch/kernels/csrc/qblock.cu",
            replaces="src/repro/kernels/qblock/kernel.py:33"),
        "dequant_accumulate": dict(
            route="cuda", source="src/repro_torch/kernels/csrc/fused_agg.cu",
            replaces="src/repro/kernels/fused_agg/kernel.py:39"),
        # a composition of grouped matmul_fused launches (CUDA C++) with
        # no launch of its own: its launches are matmul_fused's in the
        # Muon paths, also counted in the matmul_fused row
        "newton_schulz": dict(
            route="cuda", source="src/repro_torch/kernels/ns_ortho/ops.py",
            replaces="src/repro/kernels/ns_ortho/ops.py:31",
            launches_of="matmul_fused"),
    }
    kernels = [dict(name=name, **meta[name], launches=launches[name],
                    max_abs_err=errs[name], **timings[name])
               for name in meta]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
