"""Launches of torch's own ops a rotation: the trace's kernels a sum less
the program's own CUDA kernels that its ``sum`` spans counted, over the
sum's logN - 1 rotations."""

from fhebench import program


def read(run):
    return program.torch_launches(run, run.config["logN"] - 1)
