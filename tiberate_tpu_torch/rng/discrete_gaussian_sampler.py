"""CDT (cumulative distribution table) construction for discrete Gaussian
sampling, plus a pure-python sampling oracle.

The table of ``tiberate_tpu/rng/discrete_gaussian_sampler.py``: a 128-bit
fixed-point CDT over τ = 2^ceil(log2(6σ)) sampling points (σ=3.2 → 32
points), in sorted order (:func:`build_CDT`) and laid out as the 1-D
expanded binary search tree the CSPRNG's sampler walks
(:func:`build_CDT_binary_search_tree`, tree depth 5 at σ=3.2).
High-precision arithmetic uses ``decimal`` at 100 digits (≈332 bits); the
table is exact to the last CDT bit at this precision.
"""

import math
from decimal import Decimal, getcontext

import numpy as np


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


def build_CDT_binary_search_tree(security_bits=128, sigma=3.2):
    """Returns (btree, btree_size, tree_depth).

    btree: uint64 array [btree_size, 2] with columns (low 64 bits, high 64
    bits) of the 128-bit CDT node values, in 1-D expanded binary tree
    order.
    """
    cdt = build_CDT(security_bits, sigma)
    num_sampling_points = len(cdt) - 1
    tree_depth = math.ceil(math.log2(6 * sigma))
    mask = (1 << 64) - 1
    order = []
    for depth in range(tree_depth):
        step = num_sampling_points >> depth
        order += range(step // 2, num_sampling_points, step)
    btree = np.array([[cdt[i] & mask, (cdt[i] >> 64) & mask] for i in order],
                     dtype=np.uint64)
    return btree, btree.shape[0], tree_depth


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


def sample_oracle(r_high: int, r_low: int, btree, depth: int) -> int:
    """Constant-time CDT tree traversal for one 128-bit uniform draw: the
    LSB of the high word is the sign bit, the remaining 127 bits
    binary-search the CDT."""
    sign_bit = r_high & 1
    x_high = r_high >> 1
    x_low = r_low

    jump, current, counter = 1, 0, 0
    for _ in range(depth):
        node_low = int(btree[counter + current, 0])
        node_high = int(btree[counter + current, 1])
        ge = (x_high > node_high) or (
            (x_high == node_high) and (x_low >= node_low)
        )
        current = 2 * current + int(ge)
        counter += jump
        jump *= 2
    return (sign_bit * 2 - 1) * current
