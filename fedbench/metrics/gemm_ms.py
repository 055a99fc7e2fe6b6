"""Device milliseconds a round of cuBLAS/CUTLASS matrix products takes:
the model's forward and backward and the refresh's power-iteration
product (``models/vision.py``, ``models/transformer.py``,
``optim/soap.py``)."""


def read(ctx):
    s = ctx.group_seconds("gemm")
    return None if s is None else 1e3 * s / ctx.rounds
