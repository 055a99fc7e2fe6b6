"""Host milliseconds a round spends in the program's ``staging`` span
(``fed/rounds.py``: the cohort's sampling and its batches drawn, stacked
and copied to the card), over the traced rounds."""


def read(ctx):
    s = ctx.span_seconds("staging")
    return None if s is None else 1e3 * s / ctx.rounds
