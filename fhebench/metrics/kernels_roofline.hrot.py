"""A sum's least time (roofline/work.py) over the device time of all its
kernels, per sum, in %."""

from fhebench import readers


def read(run):
    return readers.roofline_pct(run, readers.work.rot_sum)
