"""Device milliseconds a round of host-to-device copies takes (staged
batches; telemetry's Omega where its copies exceed the card's budget),
from the profiler's trace."""


def read(ctx):
    s = ctx.group_seconds("h2d")
    return None if s is None else 1e3 * s / ctx.rounds
