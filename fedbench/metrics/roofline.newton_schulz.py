"""``newton_schulz``'s share of its roofline: Muon's orthogonalisations of
the traced rounds (``counts.newton_schulz_work``: the function's work,
each input read and each output written once) at the card's FP32 peak or
HBM rate, over the kernel's device time."""

from fedbench import counts as c


def read(ctx):
    s = ctx.group_seconds("newton_schulz")
    if s is None:
        return None
    flops, bytes_ = c.newton_schulz_work(ctx.cfg, ctx.traffic)
    return 100.0 * ctx.rounds * c.bound_seconds(flops, bytes_) / s
