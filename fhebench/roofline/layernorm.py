"""The least time of one forward of the feature-wise LayerNorm
(``reference/layernorm.py``'s circuit) over F stacked ciphertexts, from
the shapes alone, on ``work.py``'s terms.

**Products**: those of the circuit's ``cc_mult`` calls as ``work.cc_mult``
counts them, each at its level and batch: the squares at level 1 and the
products with the reciprocal root at level 4 + 3 iters, a call a chunk of
the stack; the Newton chain's three a step on one ciphertext.  The
elementwise passes' scalar products and rescales are left out (fewer
products: a lower bound).

**Bytes**: the ``cc_mult`` calls' as ``work.cc_mult`` counts them (their
inputs, outputs, key rows and twiddle tables, a call a chunk), plus each
elementwise pass's inputs read once and outputs written once, a
ciphertext being two polynomials of C rows of N words at its level:

* a sum over the stack (the mean's, the squares'): F ciphertexts read,
  one written;
* ``mult_scalar``: the ciphertext read at its level, written at the next;
* ``add_scalar``: the first polynomial read and written;
* ``negate``: the ciphertext read and written;
* ``level_up`` to level t: the row of the prime it divides by and the C_t
  rows it keeps read, C_t rows written, of both polynomials; the
  centring's ``level_up`` and ``cc_sub`` are one pass that also reads
  the mean once.

The least time is ``max(bytes / HBM rate, products / ceiling)`` over the
whole forward (``work.Work.least_s``).
"""

from fhebench.roofline import work


def split(total: int, chunks: int):
    """``total`` features in ``chunks`` nearly equal chunks."""
    q, r = divmod(total, chunks)
    return [q + (i < r) for i in range(chunks)]


def forward(logN: int, P: int, S: int, F: int, iters: int,
            chunks: int) -> work.Work:
    """One forward over F features at level 0, its per-feature
    ``cc_mult`` calls in ``chunks`` chunks of the stack."""
    N = 1 << logN
    W = work.WORD

    def rows(level):
        return P - level

    def ct(level):
        return 2 * rows(level) * N * W

    def poly(level):
        return rows(level) * N * W

    def level_up(dst):
        return 2 * (1 + rows(dst)) * N * W + ct(dst)

    def mult_scalar(level):
        return ct(level) + ct(level + 1)

    w = work.Work()
    # the mean: the stack's sum, times 1/F
    w.nbytes += F * ct(0) + ct(0) + mult_scalar(0)
    # centring: level_up to 1 and the mean subtracted, one pass a feature
    w.nbytes += F * level_up(1) + ct(1)
    # the squares, a call a chunk, and their sum
    for b in split(F, chunks):
        w += work.cc_mult(logN, P, S, 1, b)
    w.nbytes += F * ct(2) + ct(2)
    # the variance: times 1/F, plus eps
    w.nbytes += mult_scalar(2) + 2 * poly(3)
    # the seed (v b + a, and v / 2), then iters Newton steps
    w.nbytes += 2 * mult_scalar(3) + 2 * poly(4)
    for k in range(iters):
        L = 4 + 3 * k
        w += work.cc_mult(logN, P, S, L, 1)            # y^2
        w.nbytes += level_up(L + 1)                    # v / 2 brought down
        w += work.cc_mult(logN, P, S, L + 1, 1)        # (v / 2) y^2
        w.nbytes += 2 * ct(L + 2) + 2 * poly(L + 2)    # 1.5 - p
        w.nbytes += level_up(L + 2)                    # y brought down
        w += work.cc_mult(logN, P, S, L + 2, 1)        # y w
    # the outputs: d brought down to y's level, times y, gamma and beta
    Ly = 4 + 3 * iters
    w.nbytes += F * level_up(Ly)
    for b in split(F, chunks):
        w += work.cc_mult(logN, P, S, Ly, b)
    w.nbytes += F * (mult_scalar(Ly + 1) + 2 * poly(Ly + 2))
    return w
