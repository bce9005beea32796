"""Set-up: process start to the window's start (imports, the kernels'
build or load, the parameters, keys, inputs and the warm-up)."""


def read(run):
    return run.setup_s
