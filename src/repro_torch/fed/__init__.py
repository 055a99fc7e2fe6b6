"""Federated runtimes (counterpart of ``repro/fed``): the sync runtime."""
