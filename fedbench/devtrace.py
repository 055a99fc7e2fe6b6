"""Reading the profiler's device trace: each device operation's interval,
the busy time as the union of the intervals (not their sum), the idle gaps
between them named by the program span open at the time, and device time
by kind of work.

``GROUPS`` is a frozen copy of ``tools/profile_torch_round.py``'s name
groups, matched in order against a device operation's name (the first
group that matches takes it).
"""
from __future__ import annotations

import dataclasses

GROUPS = [
    ("matmul_fused", ("matmul_fused",)),
    ("newton_schulz", ("newton_schulz",)),
    ("adam_moments", ("adam_moments",)),
    ("sophia_update", ("sophia_update",)),
    ("quantize", ("qblock_quantize",)),
    ("dequant_accumulate", ("dequant_accumulate",)),
    # the low-rank codecs' SVD, ahead of the QR group's shared patterns
    ("svd", ("gesvd", "svd", "jacobi", "gebrd", "bdsqr", "orgbr")),
    # cuSOLVER's and MAGMA's own kernel names; a bare "qr" would also
    # match "sqrt"
    ("qr", ("geqr", "orgqr", "ungqr", "larf", "householder", "cusolver",
            "magma")),
    ("gemm", ("gemm", "sgemm", "cutlass", "xmma", "gemv")),
    ("conv", ("conv", "cudnn", "implicit")),
    ("elementwise", ("elementwise", "reduce", "vectorized", "unrolled",
                     "softmax", "norm", "index", "cat", "copy", "fill")),
]


def group_of(name: str) -> str:
    """The device operation's kind of work; copies and memsets by their
    own names ("h2d", "d2h", "d2d", "memset")."""
    low = name.lower()
    if low.startswith("memcpy"):
        for tag, label in (("htod", "h2d"), ("dtoh", "d2h"),
                           ("dtod", "d2d")):
            if tag in low:
                return label
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    for label, pats in GROUPS:
        if any(p in low for p in pats):
            return label
    return "other"


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start: float        # seconds from the traced window's start
    dur: float          # seconds


def device_ops(prof):
    """[(name, start_ns, dur_ns)] of every operation the profiler saw on a
    CUDA device (kernels, copies, memsets), in the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
    out.sort(key=lambda x: x[1])
    return out


def union(ops, t0: float, t1: float):
    """The busy intervals (merged) of ``ops`` clipped to [t0, t1]."""
    spans = sorted((max(o.start, t0), min(o.start + o.dur, t1))
                   for o in ops if o.start < t1 and o.start + o.dur > t0)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(ops, t0: float, t1: float) -> float:
    return sum(b - a for a, b in union(ops, t0, t1))


def idle_gaps(ops, t0: float, t1: float):
    """[(start, seconds)] of the stretches in [t0, t1] with no device
    operation."""
    gaps, cur = [], t0
    for a, b in union(ops, t0, t1):
        if a > cur:
            gaps.append((cur, a - cur))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1 - cur))
    return gaps


def label_at(t: float, spans) -> str:
    """The innermost (shortest) host span open at ``t``; spans are
    (name, start, dur) in the window's seconds."""
    best = None
    for name, a, d in spans:
        if a <= t <= a + d and (best is None or d < best[1]):
            best = (name, d)
    return best[0] if best is not None else "outside_spans"


def breakdown(ops, spans, t0: float, t1: float, top: int = 10):
    """The ``breakdown`` of a traced run: the device operations that took
    most time (summed by name) and the longest idle gaps, each named by
    the host span open at its middle."""
    by_name: dict = {}
    for o in ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
    dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(ops, t0, t1), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in dev],
            "idle_gaps": [[label_at(a + d / 2, spans), d] for a, d in gaps]}
