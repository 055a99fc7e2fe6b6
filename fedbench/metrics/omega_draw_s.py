"""Host seconds the process spent drawing telemetry's JL Omega
projections (the program's ``omega.draw_s`` counter,
``obs/telemetry.py::_omega``'s cache misses): every draw falls in
set-up's first round, so this is a part of ``setup_s``."""


def read(ctx):
    try:
        from repro_torch.obs import counters
    except ImportError:          # a program without the counters
        return None
    return counters.snapshot().get("omega.draw_s")
