"""Toy configurations for fast tests (ring sizes below the preset cache).

Builds a duck-typed config object compatible with :class:`CkksParams` and
:class:`CkksEngine` from freshly mined NTT-friendly primes at any logN.
"""

import math
from types import SimpleNamespace

import numpy as np

from tiberate_tpu_torch.utils.primes import find_the_next_prime


def toy_config(
    logN: int = 8,
    num_scales: int = 3,
    num_special_primes: int = 1,
    scale_bits: int = 30,
    buffer_bit_length: int = 62,
    sigma: float = 3.2,
):
    """A small CKKS parameter set without security gating (tests only)."""
    N = 1 << logN
    m = 2 * N

    message_bits = buffer_bit_length - 2
    base_special = []
    q = 2**message_bits - 1
    for _ in range(1 + num_special_primes):
        q = find_the_next_prime(q, m, up=False)
        base_special.append(q)
        q -= 2

    scale_primes = []
    up, down = 2**scale_bits + 1, 2**scale_bits - 1
    for i in range(num_scales):
        if i % 2 == 0:
            p = find_the_next_prime(up, m, up=True)
            up = p + 2
        else:
            p = find_the_next_prime(down, m, up=False)
            down = p - 2
        scale_primes.append(p)

    q_chain = scale_primes + base_special
    cfg = SimpleNamespace(
        buffer_bit_length=buffer_bit_length,
        scale_bits=scale_bits,
        logN=logN,
        N=N,
        num_scales=num_scales,
        num_special_primes=num_special_primes,
        sigma=sigma,
        int_scale=2**scale_bits,
        scale=np.float64(2**scale_bits),
        message_bits=message_bits,
        q=q_chain,
        total_qbits=math.ceil(sum(math.log2(p) for p in q_chain)),
        numpy_dtype=np.int32 if buffer_bit_length == 30 else np.int64,
        num_ordinary_primes=num_scales + 1,
    )
    cfg.__repr__ = lambda: f"toy_{logN}_{scale_bits}_{num_scales}"
    return cfg
