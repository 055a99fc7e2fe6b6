"""Launch drivers (counterpart of ``repro/launch``): the serving driver."""
