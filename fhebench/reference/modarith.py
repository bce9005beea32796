"""Exact modular arithmetic on int64 torch tensors, written from the
definitions.

The one primitive is Montgomery's reduction of a product at ``R = 2^62``,

    redc(a, b) = (a*b + m*q) / 2^62,   m = (a*b*k) mod 2^62,   k = -q^-1 mod 2^62,

computed exactly for any signed ``|a|, |b| < 2^62``: the product is
formed as ``hi * 2^62 + lo`` from 31-bit halves, each partial product
fitting a signed 64-bit word.  The result is congruent to
``a*b*2^-62 mod q`` and is the one integer of that class in
``[a*b / 2^62, a*b / 2^62 + q)``.  CKKS as the configurations run it
takes that exact integer in two places (the keyswitch digits and the
P-division of the special rows), so the reference computes it by the
definition; everywhere else it reduces to the canonical residue.

Torch's int64 multiply wraps modulo 2^64 on the CPU and on the card; only
``m`` relies on it, and only modulo 2^62.
"""

import torch

W = 62
R = 1 << W
MASK = R - 1
HALF = 31
HMASK = (1 << HALF) - 1


def k_of(q: int) -> int:
    """-q^-1 mod 2^62."""
    return (-pow(q, -1, R)) % R


def col(vals, device, dtype=torch.int64):
    """Python ints -> a [C, 1] column."""
    return torch.tensor([int(v) for v in vals], dtype=dtype,
                        device=device).reshape(-1, 1)


def mul_wide(a, b):
    """``a * b`` exactly, as ``(hi, lo)`` with ``a*b = hi*2^62 + lo`` and
    ``0 <= lo < 2^62``; ``|a|, |b| < 2^62``."""
    al, ah = a & HMASK, a >> HALF
    bl, bh = b & HMASK, b >> HALF
    mid = ah * bl + al * bh
    lo = al * bl + ((mid & HMASK) << HALF)
    hi = ah * bh + (mid >> HALF) + (lo >> W)
    return hi, lo & MASK


def redc(a, b, q, k):
    """Montgomery's reduction of ``a * b`` (see the module docstring)."""
    hi, lo = mul_wide(a, b)
    m = (lo * k) & MASK
    mh, ml = mul_wide(m, q)
    return hi + mh + ((lo + ml) >> W)


def mul(a, bR, q, k):
    """``a * b mod q``, canonical, for ``0 <= a < q`` and ``bR = b * 2^62
    mod q`` (``b`` given in Montgomery form)."""
    r = redc(a, bR, q, k)
    return torch.where(r >= q, r - q, r)


def add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub(a, b, q):
    s = a - b
    return torch.where(s < 0, s + q, s)


class Moduli:
    """A list of primes as [C, 1] columns on a device: ``q``, ``k`` and
    the Montgomery forms of 1 and of R (``R1 = 2^62 mod q``, ``R2 =
    2^124 mod q``), which turn :func:`mul` into a product of two plain
    residues (``mul(a, mul(b, R2))``)."""

    def __init__(self, primes, device):
        self.primes = [int(p) for p in primes]
        self.device = device
        self.q = col(self.primes, device)
        self.k = col([k_of(p) for p in self.primes], device)
        self.R1 = col([R % p for p in self.primes], device)
        self.R2 = col([R * R % p for p in self.primes], device)

    def __len__(self):
        return len(self.primes)

    def const(self, values):
        """Per-prime python ints -> their Montgomery forms [C, 1]."""
        return col([int(v) % p * R % p for v, p in zip(values, self.primes)],
                   self.device)

    def mont(self, x):
        """Plain residues [..., C, N] -> Montgomery form."""
        return mul(x, self.R2, self.q, self.k)

    def mul(self, a, bR):
        return mul(a, bR, self.q, self.k)

    def add(self, a, b):
        return add(a, b, self.q)

    def sub(self, a, b):
        return sub(a, b, self.q)

    def mod(self, x):
        """Any int64 values -> canonical residues."""
        return torch.remainder(x, self.q)
