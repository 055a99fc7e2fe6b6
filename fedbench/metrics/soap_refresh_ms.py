"""Device milliseconds a round of SOAP's eigenbasis refresh takes: the
cuSOLVER/MAGMA QR kernels (``optim/soap.py``, once a round at step 0),
by the name groups of ``devtrace.GROUPS``."""


def read(ctx):
    s = ctx.group_seconds("qr")
    return None if s is None else 1e3 * s / ctx.rounds
