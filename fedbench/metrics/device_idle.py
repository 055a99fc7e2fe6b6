"""Share of the traced window in which no kernel, copy or memset ran on
the card: one minus the union of their intervals (not their sum) over the
window."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_seconds() / ctx.window_s)
