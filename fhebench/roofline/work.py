"""The least time a CKKS operation could take on the card, from the
configuration's shapes alone.

**Modular multiplications.**  Counted as the algorithm needs them, by its
stages, not as any kernel performs them: a kernel that trades one
reduction for another, drops a lazy reduction or fuses two stages leaves
these counts as they are.  An NTT or inverse NTT of a row of N
coefficients is N/2 log2 N butterflies, one product each (the N^-1 of
the inverse folds into constants).  Entering or leaving the Montgomery
form costs nothing here: it is one way of reducing, not a product the
algorithm needs.  Where the algorithm can do with fewer products than a
straightforward implementation, the count takes the fewer, so that no
implementation reads above 100%:

* rescale: one product per kept coefficient;
* tensor product: the forward NTT of the four input polynomials and three
  products per coefficient (Karatsuba's d1 = (x0 + x1)(y0 + y1) - d0 - d2);
* the three inverse NTTs of d0, d1, d2;
* keyswitch digits: alpha (alpha - 1) / 2 products per coefficient of a
  part of alpha primes (Garner's recurrence);
* per part, the basis extension to the rows outside the part (alpha - 1
  products per coefficient and row), the forward NTT of those rows (the
  part's own rows are the input's own, transformed once for all parts, or
  not at all where the input is already in the evaluation domain, as the
  tensor product leaves d2), and the two key products on every row;
* the two inverse NTTs of the sums, and the P-division: S (S - 1) / 2
  products per coefficient to replay the successive division on the
  special rows and S on each ordinary row;
* a rotation's Galois map and every addition: none.

**Bytes.**  Each input read once and each output written once, over the
whole operation: the input ciphertexts, every key row it uses, the
forward and inverse twiddle tables of the primes it transforms, and the
outputs.  Intermediates are not counted.

**Least time** = max(bytes / 3.35e12 B/s, products / ceiling), over the
whole operation: a fused implementation may overlap its stages, so the
maximum is not taken stage by stage.

**The ceiling.**  The card's 32-bit integer multiply-add issue rate is 64
results a clock on each SM (CUDA C++ Programming Guide, "Arithmetic
Instructions" throughput table, compute capability 9.0), on 132 SMs (H100
SXM), at the card's highest SM clock (``clocks.max.sm`` as nvidia-smi
reads it in the run: a property of the card, not of the moment).  A
product of two residues of up to 62 bits needs the four 32 x 32-bit
partial products of the 64 x 64-bit product before any reduction, so the
ceiling is a quarter of that rate: 64 x 132 x 1.98e9 / 4 = 4.18e12
products a second at 1980 MHz.  A kernel that reaches it would spend every
integer issue slot of the card on partial products alone.
"""

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet, at 700 W
INT32_MAD_PER_CLOCK_PER_SM = 64  # CUDA C++ Programming Guide, cc 9.0
SMS = 132                       # H100 SXM
PARTIAL_PRODUCTS = 4            # 32 x 32-bit pieces of a 64 x 64-bit product
WORD = 8                        # bytes of a 62-bit residue


def ceiling(sm_clock_hz: float) -> float:
    """Modular products a second that no implementation can pass."""
    return INT32_MAD_PER_CLOCK_PER_SM * SMS * sm_clock_hz / PARTIAL_PRODUCTS


def transform(rows: int, logN: int) -> int:
    """Products of an NTT or inverse NTT of ``rows`` rows."""
    return rows * (1 << logN) // 2 * logN


def part_sizes(P: int, S: int, level: int):
    """Primes in each keyswitch part at ``level``: the fixed groups of S
    ordinary primes of level 0, cut at the level, then the base prime."""
    sizes = []
    g = level // S
    while g * S < P - 1:
        n = min((g + 1) * S, P - 1) - max(g * S, level)
        if n > 0:
            sizes.append(n)
        g += 1
    return sizes + [1]


class Work:
    """Products and bytes of one operation."""

    def __init__(self, products=0, nbytes=0):
        self.products = products
        self.nbytes = nbytes

    def __iadd__(self, other):
        self.products += other.products
        self.nbytes += other.nbytes
        return self

    def least_s(self, sm_clock_hz: float) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S,
                   self.products / ceiling(sm_clock_hz))


def keyswitch(logN: int, P: int, S: int, level: int, batch: int,
              in_eval_domain: bool) -> Work:
    """One keyswitch of ``batch`` polynomials at ``level``: products, and
    the bytes of the key rows it reads (its input and output are the
    caller's)."""
    N = 1 << logN
    C = P - level
    Csp = C + S
    sizes = part_sizes(P, S, level)
    prod = 0
    ntt_rows = 0 if in_eval_domain else C
    for a in sizes:
        prod += N * a * (a - 1) // 2               # digits
        prod += N * (a - 1) * (Csp - a)            # extension
        prod += 2 * Csp * N                        # key products
        ntt_rows += Csp - a
    prod = batch * (prod + transform(ntt_rows, logN))
    prod += batch * 2 * (transform(Csp, logN)
                         + N * (S * (S - 1) // 2 + S * C))
    key_bytes = len(sizes) * 2 * Csp * N * WORD
    return Work(prod, key_bytes)


def tables(logN: int, rows: int) -> int:
    """Bytes of the forward and inverse twiddle tables of ``rows`` primes."""
    return 2 * rows * (1 << logN) * WORD


def cc_mult(logN: int, P: int, S: int, level: int, batch: int) -> Work:
    """rescale -> tensor product -> relinearize of ``batch`` pairs of
    ciphertexts at ``level``."""
    N = 1 << logN
    C0 = P - level
    C1 = C0 - 1
    w = Work()
    w.products += 4 * batch * C1 * N                     # rescale
    w.products += batch * (transform(4 * C1, logN) + 3 * C1 * N)
    w.products += batch * transform(3 * C1, logN)        # d0, d1, d2
    w += keyswitch(logN, P, S, level + 1, batch, in_eval_domain=True)
    w.nbytes += (4 * batch * C0 + 2 * batch * C1) * N * WORD
    w.nbytes += tables(logN, C1 + S)
    return w


def rot_sum(logN: int, P: int, S: int, level: int, batch: int) -> Work:
    """``sum``: logN - 1 rotations, each a keyswitch of the rotated second
    polynomial (coefficient domain) with its own key, and the additions."""
    N = 1 << logN
    C = P - level
    w = Work()
    for _ in range(logN - 1):
        w += keyswitch(logN, P, S, level, batch, in_eval_domain=False)
    w.nbytes += 4 * batch * C * N * WORD
    w.nbytes += tables(logN, C + S)
    return w
