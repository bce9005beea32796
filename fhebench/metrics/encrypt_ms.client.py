"""encodecrypt_batch, synchronised: the mean of the benchmark's span over
the window, in ms."""

from fhebench import readers


def read(run):
    return readers.span_mean_ms(run, "encodecrypt_batch")
