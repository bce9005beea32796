"""``roofline/layernorm.py``: a LayerNorm forward's products are its
``cc_mult`` calls' (``work.cc_mult`` at each level and chunk) and its
bytes theirs plus the elementwise passes', counted here by hand at a toy
ring."""

import pytest

from fhebench.roofline import layernorm, work

# N = 4, 11 ordinary primes, 2 special: a row is 32 bytes, a ciphertext at
# level l 64 (11 - l); 3 features, one Newton step (outputs at level 9)
LOGN, P, S, F, ITERS = 2, 11, 2, 3, 1


def mults(chunks):
    """The forward's cc_mult calls: (level, batch)."""
    return ([(1, b) for b in chunks] + [(4, 1), (5, 1), (6, 1)]
            + [(7, b) for b in chunks])


def test_products_are_the_cc_mults():
    w = layernorm.forward(LOGN, P, S, F, ITERS, 2)
    assert w.products == sum(work.cc_mult(LOGN, P, S, lvl, b).products
                             for lvl, b in mults([2, 1]))


def test_bytes_by_hand():
    w = layernorm.forward(LOGN, P, S, F, ITERS, 2)
    passes = (
        3 * 704 + 704 + (704 + 640)        # the sum of x, times 1/F
        + 3 * (64 * 11 + 640) + 640        # level_up to 1 and - mu, mu once
        + 3 * 576 + 576                    # the squares' sum
        + (576 + 512) + 2 * 256            # times 1/F, plus eps
        + 2 * (512 + 448) + 2 * 224        # v b + a, v / 2
        + (64 * 7 + 384)                   # v / 2 down to level 5
        + 2 * 320 + 2 * 160                # negate, plus 1.5, at level 6
        + (64 * 6 + 320)                   # y down to level 6
        + 3 * (64 * 5 + 256)               # d down to level 7
        + 3 * ((192 + 128) + 2 * 64))      # gamma (to level 9), beta
    assert passes == 20672
    assert w.nbytes == passes + sum(work.cc_mult(LOGN, P, S, lvl, b).nbytes
                                    for lvl, b in mults([2, 1]))


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_chunks_move_only_the_keys_and_tables(chunks):
    one = layernorm.forward(LOGN, P, S, F, ITERS, 1)
    w = layernorm.forward(LOGN, P, S, F, ITERS, chunks)
    assert w.products == one.products
    # a call's own bytes (its key rows and tables): those of two calls of
    # one less those of one call of two
    extra = sum(2 * work.cc_mult(LOGN, P, S, lvl, 1).nbytes
                - work.cc_mult(LOGN, P, S, lvl, 2).nbytes for lvl in (1, 7))
    assert extra > 0
    assert w.nbytes - one.nbytes == (chunks - 1) * extra
    assert layernorm.split(F, chunks) == [
        F // chunks + (i < F % chunks) for i in range(chunks)]
