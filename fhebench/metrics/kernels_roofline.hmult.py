"""The cc_mult step's least time (roofline/work.py) over the device time
of all its kernels, per step, in %."""

from fhebench import readers


def read(run):
    return readers.roofline_pct(run, readers.work.cc_mult)
