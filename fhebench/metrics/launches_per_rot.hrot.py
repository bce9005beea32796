"""CUDA kernel launches per rotation in the trace: a sum's, over its
logN - 1 rotations."""

from fhebench import readers


def read(run):
    return readers.kernels_per(run, run.config["logN"] - 1)
