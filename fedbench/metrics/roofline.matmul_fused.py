"""``matmul_fused``'s share of its roofline: SOAP's products of the traced
rounds (``counts.matmul_fused_work``: each operand read once, each output
written once) at the card's FP32 peak or HBM rate, whichever bounds them,
over the kernel's device time."""

from fedbench import counts as c


def read(ctx):
    s = ctx.group_seconds("matmul_fused")
    if s is None:
        return None
    flops, bytes_ = c.matmul_fused_work(ctx.cfg, ctx.traffic)
    return 100.0 * ctx.rounds * c.bound_seconds(flops, bytes_) / s
