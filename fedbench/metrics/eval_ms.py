"""Host milliseconds a round spends in the program's ``eval`` span (the
scenario's eval set through the new global model, read back), over the
traced rounds."""


def read(ctx):
    s = ctx.span_seconds("eval")
    return None if s is None else 1e3 * s / ctx.rounds
