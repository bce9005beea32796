"""The card's idle share of the traced window: 1 - (union of device
activity) / (window), in %."""

from fhebench import readers


def read(run):
    return readers.idle_pct(run)
