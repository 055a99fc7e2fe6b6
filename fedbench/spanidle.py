"""The card's idle time put down to the program's spans: each idle gap of
the traced window is split at the spans' starts and ends, and each piece
goes to the innermost span open over all of it (the shortest, the rule by
which ``devtrace.label_at`` names a gap), or to "outside_spans".  The
pieces of every gap add up to the window's idle time, so the shares of
all names together are ``device_idle``."""
from __future__ import annotations

from fedbench import devtrace


def idle_by_span(ops, spans, t0: float, t1: float) -> dict:
    """{span name: idle seconds} over [t0, t1]; ``spans`` are (name,
    start, dur) in the window's seconds."""
    edges = sorted({x for _, a, d in spans for x in (a, a + d)})
    out: dict = {}
    for g0, gd in devtrace.idle_gaps(ops, t0, t1):
        g1 = g0 + gd
        cuts = [g0] + [e for e in edges if g0 < e < g1] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            name = devtrace.label_at((a + b) / 2, spans)
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_ms(ctx, phase: str):
    """Idle milliseconds a round of the traced window while ``phase`` is
    the innermost open span; None where the program emitted no such span
    (a program without it)."""
    if not any(name == phase for name, _, _ in ctx.spans):
        return None
    idle = idle_by_span(ctx.ops, ctx.spans, 0.0, ctx.window_s)
    return 1e3 * idle.get(phase, 0.0) / ctx.rounds
