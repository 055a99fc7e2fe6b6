"""Milliseconds a round in which the card was idle while the program's
``local_update`` span was the innermost one open (the cohort's K local
steps and the upload encode, ``core/algorithms.py``, outside SOAP's
refresh and the encode's own spans): host gaps between the local steps'
launches (``fedbench.spanidle``)."""

from fedbench import spanidle


def read(ctx):
    return spanidle.idle_ms(ctx, "local_update")
