"""Homomorphic Encryption Standard logq tables and interpolation.

Behavioral equivalent of the reference security tables
(``tiberate/config/security_parameters.py:4-201``): piecewise-linear
inter-/extrapolation of the HE-standard maximum log2(q) bounds over the
cyclotomic dimension n, for pre-/post-quantum security at 128/192/256 bits and
uniform/error/ternary secret distributions.

Implemented with plain numpy (linear spline, k=1, with linear extrapolation at
both ends) instead of scipy.
"""

import numpy as np

security_levels = (128, 192, 256)

cyclotomic_n = (1024, 2048, 4096, 8192, 16384, 32768)

# Rows are n = 1024..32768; columns are security 128/192/256, flattened
# in (n-major, security-minor) order, exactly as published by the HE standard.
_logq_flat = {
    ("pre_quantum", "uniform"): (
        29, 21, 16, 56, 39, 31, 111, 77, 60, 220, 154, 120,
        440, 307, 239, 880, 612, 478,
    ),
    ("pre_quantum", "error"): (
        29, 21, 16, 56, 39, 31, 111, 77, 60, 220, 154, 120,
        440, 307, 239, 883, 613, 478,
    ),
    ("pre_quantum", "ternary"): (
        27, 19, 14, 54, 37, 29, 109, 75, 58, 218, 152, 118,
        438, 305, 237, 881, 611, 476,
    ),
    ("post_quantum", "uniform"): (
        27, 19, 15, 53, 37, 29, 103, 72, 56, 206, 143, 111,
        413, 286, 222, 829, 573, 445,
    ),
    ("post_quantum", "error"): (
        27, 19, 15, 53, 37, 29, 103, 72, 56, 206, 143, 111,
        413, 286, 222, 829, 573, 445,
    ),
    ("post_quantum", "ternary"): (
        25, 17, 13, 51, 35, 27, 101, 70, 54, 202, 141, 109,
        411, 284, 220, 827, 571, 443,
    ),
}


def _table(quantum: str, distribution: str, security_bits: int):
    if quantum not in ("pre_quantum", "post_quantum"):
        raise ValueError("Wrong quantum security model!!!")
    if distribution not in ("uniform", "error", "ternary"):
        raise ValueError(f"Unknown distribution {distribution!r}")
    if security_bits not in security_levels:
        raise ValueError(f"Unknown security level {security_bits}")
    flat = _logq_flat[(quantum, distribution)]
    col = security_levels.index(security_bits)
    return [flat[i * 3 + col] for i in range(len(cyclotomic_n))]


def _interp_linear_extrap(x, xs, ys):
    """Piecewise-linear interpolation with linear extrapolation (spline k=1)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    x = np.float64(x)
    if x <= xs[0]:
        i = 0
    elif x >= xs[-1]:
        i = len(xs) - 2
    else:
        i = int(np.searchsorted(xs, x, side="right")) - 1
    t = (x - xs[i]) / (xs[i + 1] - xs[i])
    return float(ys[i] + t * (ys[i + 1] - ys[i]))


def maximum_qbits(
    L, security_bits=128, quantum="post_quantum", distribution="uniform"
):
    """Maximum allowed log2(prod q) for ring dimension L under the HE standard."""
    ys = _table(quantum, distribution, security_bits)
    return _interp_linear_extrap(L, cyclotomic_n, ys)


def minimum_cyclotomic_order(
    q_bits, security_bits=128, quantum="post_quantum", distribution="uniform"
):
    """Minimum ring dimension supporting a total modulus of q_bits bits."""
    xs = _table(quantum, distribution, security_bits)
    return _interp_linear_extrap(q_bits, xs, cyclotomic_n)
