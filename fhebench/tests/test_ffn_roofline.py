"""``roofline/ffn.py``: a feed-forward forward's int8 products are its two
matrix products' at the channels' widths, its products the squares'
``cc_mult`` calls', its bytes the products' inputs, weights and outputs
and the calls' own, counted here by hand at a toy ring."""

import pytest

from fhebench.roofline import ffn, work

# N = 4, 5 ordinary primes (of 40, 41, 40, 41 and 60 bits) and 2 special:
# H = 3, I = 5, 40-bit weights (5 bytes)
LOGN, S, H, I, BW = 2, 2, 3, 5, 40
PRIMES = [2**39 + 1, 2**40 + 1, 2**39 + 3, 2**40 + 3, 2**59 + 1, 2**59 + 3,
          2**59 + 5]
P = len(PRIMES) - S


def test_pieces():
    assert ffn.pieces(40, 40) == 25       # the 40-bit words' 25
    assert ffn.pieces(41, 37) == 30
    assert ffn.pieces(60, 40) == 40
    assert ffn.pieces(28, 25) == 16


def test_matmuls_by_hand():
    w = ffn.matmuls(LOGN, PRIMES, P, H, I, BW)
    per = H * I * 2 * 4                   # F_in F_out, both polys, N
    # up at level 0: 40, 41, 40, 41, 60 bits; down at level 2: 40, 41, 60
    assert w.int8 == per * (25 + 30 + 25 + 30 + 40) + per * (25 + 30 + 40)
    row = 4 * 8                           # a row of N words
    up = (H + I) * 2 * 5 * row + H * I * 5
    down = (I + H) * 2 * 3 * row + I * H * 5
    assert w.nbytes == up + down
    assert w.products == 0


def test_forward_adds_the_squares():
    for chunks in (1, 2, 5):
        w = ffn.forward(LOGN, PRIMES, P, S, H, I, BW, chunks)
        sq = [work.cc_mult(LOGN, P, S, 1, b) for b in ffn.split(I, chunks)]
        m = ffn.matmuls(LOGN, PRIMES, P, H, I, BW)
        assert w.int8 == m.int8
        assert w.products == sum(c.products for c in sq)
        assert w.nbytes == m.nbytes + sum(c.nbytes for c in sq)
    assert ffn.split(I, 2) == [3, 2]


def test_least_time():
    """max(bytes at the HBM rate, int8 products at the tensor cores' rate
    plus products at work.py's ceiling); the int8 ceiling is 1,979 TOPS at
    1,830 MHz."""
    assert 2 * ffn.int8_ceiling(1.83e9) == pytest.approx(1.979e15, 1e-3)
    w = ffn.Work(int8=10**15, products=10**12, nbytes=10**9)
    clk = 1.98e9
    assert w.least_s(clk) == pytest.approx(
        10**15 / ffn.int8_ceiling(clk) + 10**12 / work.ceiling(clk))
    w = ffn.Work(int8=1, products=1, nbytes=10**13)
    assert w.least_s(clk) == pytest.approx(10**13 / work.HBM_BYTES_PER_S)
