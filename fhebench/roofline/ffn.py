"""The least time of one forward of the feature-wise feed-forward sub-layer
(``reference/ffn.py``'s circuit) and of its modular matrix products,
from the shapes alone.

**The matrix products.**  ``F_in F_out 2 N C`` modular products a stacked
linear op at a level of C channels (both polynomials of every output,
every input, every coefficient).  Their ceiling is the card's dense int8
tensor-core rate, 4,096 int8 multiply-adds a clock on each SM (the
H100 SXM's 1,979 TOPS at 1,830 MHz over 132 SMs and 2 operations), at
``clocks.max.sm``, as ``work.py`` scales its own; a modular product of a
residue of ``b_x`` bits (its channel's modulus) by a weight integer of
``b_w`` bits takes ``ceil(b_x / 8) ceil(b_w / 8)`` int8 products (25 at
40-bit words and 40-bit weights).  The weights' integers have
``scale_bits`` bits at most (|w| < 1) and more than ``scale_bits - 8``
(the largest |w| of a BERT layer's weights is above 2^-8), so ``b_w =
scale_bits`` gives their ``ceil(b_w / 8)``.  Not ``work.py``'s 32-bit
ceiling: a product on int8 tensor cores would read above 100% against it.
Bytes: each product's inputs, its weights (``ceil(b_w / 8)`` bytes each)
and its outputs once.

**The forward** adds the Quad's squares, ``work.cc_mult`` at level 1 for
each chunk of the intermediate features (their products at ``work.py``'s
ceiling, their key rows and twiddle tables); the sub-layer's input and
output are the products' own.  The intermediate features' other passes
(rescales, ``mult_scalar``, the adds, the residual) are left out: a lower
bound.

The least time is ``max(bytes / HBM rate, int8 products / int8 ceiling +
products / work's ceiling)``: the squares read the up product's output
and the down product reads theirs.
"""

import math

from fhebench.roofline import work

INT8_MAC_PER_CLOCK_PER_SM = 4096   # 1,979e12 / 2 / 132 / 1.83e9


def int8_ceiling(sm_clock_hz: float) -> float:
    """int8 multiply-adds a second on the tensor cores, dense."""
    return INT8_MAC_PER_CLOCK_PER_SM * work.SMS * sm_clock_hz


class Work:
    """int8 products (at the tensor cores' ceiling), modular products (at
    ``work.py``'s) and bytes."""

    def __init__(self, int8=0, products=0, nbytes=0):
        self.int8, self.products, self.nbytes = int8, products, nbytes

    def __iadd__(self, other):
        self.int8 += other.int8
        self.products += other.products
        self.nbytes += other.nbytes
        return self

    def least_s(self, sm_clock_hz: float) -> float:
        return max(self.nbytes / work.HBM_BYTES_PER_S,
                   self.int8 / int8_ceiling(sm_clock_hz)
                   + self.products / work.ceiling(sm_clock_hz))


def pieces(bits_x: int, bits_w: int) -> int:
    """int8 products a modular product of ``bits_x`` by ``bits_w`` bits."""
    return math.ceil(bits_x / 8) * math.ceil(bits_w / 8)


def matmul(logN: int, primes, level: int, P: int, F_in: int, F_out: int,
           bits_w: int) -> Work:
    """One stacked linear op at ``level``: ``primes`` the configuration's
    chain, P of them ordinary; its products as int8 products, its bytes."""
    N = 1 << logN
    chans = [int(q).bit_length() for q in primes[level:P]]
    per = F_in * F_out * 2 * N
    w = Work()
    w.int8 = per * sum(pieces(b, bits_w) for b in chans)
    w.nbytes = ((F_in + F_out) * 2 * len(chans) * N * work.WORD
                + F_in * F_out * math.ceil(bits_w / 8))
    return w


def matmuls(logN: int, primes, P: int, H: int, I: int, bits_w: int,
            level: int = 0) -> Work:
    """The forward's two products: H to I at ``level``, I to H at
    ``level + 2``."""
    w = matmul(logN, primes, level, P, H, I, bits_w)
    w += matmul(logN, primes, level + 2, P, I, H, bits_w)
    return w


def split(total: int, chunks: int):
    """``total`` features in ``chunks`` nearly equal chunks."""
    q, r = divmod(total, chunks)
    return [q + (i < r) for i in range(chunks)]


def forward(logN: int, primes, P: int, S: int, H: int, I: int, bits_w: int,
            chunks: int, level: int = 0) -> Work:
    """One forward over H features at ``level``, its I squares in
    ``chunks`` ``cc_mult`` calls."""
    w = matmuls(logN, primes, P, H, I, bits_w, level)
    for b in split(I, chunks):
        c = work.cc_mult(logN, P, S, level + 1, b)
        w += Work(0, c.products, c.nbytes)
    return w
