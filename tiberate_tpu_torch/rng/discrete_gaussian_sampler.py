"""CDT (cumulative distribution table) construction for discrete Gaussian
sampling.

The table of ``tiberate_tpu/rng/discrete_gaussian_sampler.py``, in sorted
order (:func:`build_CDT`) for the port's inverse-CDF sampler: a 128-bit
fixed-point CDT over τ = 2^ceil(log2(6σ)) sampling points (σ=3.2 → 32
points).  The JAX package lays the same values out as a binary search tree
for its ChaCha20 sampler; that layout comes with the port of the CSPRNG.
High-precision arithmetic uses ``decimal`` at 100 digits (≈332 bits); the
table is exact to the last CDT bit at this precision.
"""

import math
from decimal import Decimal, getcontext


def build_CDT(security_bits=128, sigma=3.2):
    """The half-plane CDT as python ints scaled by 2^security_bits, in
    ascending order: ``cdt[0] = 0``, ``cdt[1] = P(0)/2``, ``cdt[x+1] =
    cdt[x] + P(x)``, over τ = 2^ceil(log2(6σ)) sampling points."""
    getcontext().prec = 100

    sampling_power = math.ceil(math.log2(6 * sigma))
    num_sampling_points = 2**sampling_power

    d_sigma = Decimal(str(sigma))
    two = Decimal(2)
    S = d_sigma * (two * _decimal_pi()).sqrt()

    probs = []
    for x in range(num_sampling_points):
        e = (-Decimal(x) ** 2 / (two * d_sigma**2)).exp()
        probs.append(e / S)
    probs[0] /= 2  # half plane: halve P(0)

    cdt = [Decimal(0)]
    for p in probs:
        cdt.append(cdt[-1] + p)

    scale = Decimal(2) ** security_bits
    return [int(x * scale) for x in cdt]


def _decimal_pi():
    """π via the Chudnovsky series at the current decimal precision."""
    getcontext().prec += 10
    C = 426880 * Decimal(10005).sqrt()
    K, M, X, L, S = 6, 1, 1, 13591409, Decimal(13591409)
    for _ in range(getcontext().prec // 14 + 2):
        M = M * (K**3 - 16 * K) // ((_ + 1) ** 3)
        L += 545140134
        X *= -262537412640768000
        S += Decimal(M * L) / X
        K += 12
    pi = C / S
    getcontext().prec -= 10
    return +pi
