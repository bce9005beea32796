"""Launches of torch's own ops a cc_mult step: the trace's kernels a
step less the program's own CUDA kernels that its ``cc_mult`` spans
counted."""

from fhebench import program


def read(run):
    return program.torch_launches(run, 1)
