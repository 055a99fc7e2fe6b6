"""The whole round's share of the card's FP32 peak: the model FLOPs of
every cohort client's local forward and backward in the run's untraced
window (``counts.round_model_flops``; SOAP's and Muon's work, eval and
telemetry not counted) over that window's seconds, on the host's clock, at
67 TFLOP/s."""

from fedbench import counts as c


def read(ctx):
    flops = ctx.timed_rounds * c.round_model_flops(ctx.cfg, ctx.traffic)
    return 100.0 * flops / (ctx.timed_s * c.FP32_FLOPS)
