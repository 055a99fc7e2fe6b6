"""Milliseconds a round in which the card was idle while the program's
``soap_refresh`` span was the innermost one open (SOAP's scheduled
eigenbasis refresh, ``optim/soap.py``: a QR a side of every matrix leaf)
(``fedbench.spanidle``)."""

from fedbench import spanidle


def read(ctx):
    return spanidle.idle_ms(ctx, "soap_refresh")
