"""Host milliseconds a round spends in the program's ``telemetry`` span
(``obs/telemetry.py::collect``: the round's drift telemetry with its JL
Omega projections; where an Omega is not kept on the card, its copy from
pageable memory first waits for the work queued ahead of it), over the
traced rounds."""


def read(ctx):
    s = ctx.span_seconds("telemetry")
    return None if s is None else 1e3 * s / ctx.rounds
