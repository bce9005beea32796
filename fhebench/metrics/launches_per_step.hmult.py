"""CUDA kernel launches per cc_mult step in the trace."""

from fhebench import readers


def read(run):
    return readers.kernels_per(run, 1)
