"""Homomorphic multiplications (cc_mult of two ciphertexts: rescale,
tensor product, relinearization) completed over the whole window."""

from fhebench import readers


def read(run):
    return readers.rate(run, "hmult")
