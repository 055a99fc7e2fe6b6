"""Megabytes (1e6 bytes) of telemetry's JL Omega projections copied to
the card a round and not kept there (the program's ``omega.h2d_bytes``
counter, ``obs/telemetry.py::sketch_omega``) in the last traced round,
as its tracer recorded it (``counters.last_traced_round()``)."""


def read(ctx):
    try:
        from repro_torch.obs import counters
    except ImportError:          # a program without the counters
        return None
    last = counters.last_traced_round()
    if last is None or "omega.h2d_bytes" not in last:
        return None
    return last["omega.h2d_bytes"] / 1e6
