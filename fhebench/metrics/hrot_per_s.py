"""Keyswitched slot rotations completed over the whole window: batch x
(logN - 1) per sum."""

from fhebench import readers


def read(run):
    return readers.rate(run, "hrot")
