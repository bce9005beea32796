"""CUDA kernel launches per feed-forward forward in the trace (the port's
kernels and torch's)."""

from fhebench import readers


def read(run):
    return readers.kernels_per(run, 1)
