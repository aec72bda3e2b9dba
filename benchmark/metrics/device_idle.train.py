"""device_idle.train: the share of the traced steps' window in which no
operation ran on the card (union of its kernels, copies and sets)."""

from benchmark.metrics._readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
