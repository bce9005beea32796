"""Counter-mode ChaCha20 block function on int64 tensors of 32-bit words.

The torch counterpart of ``tiberate_tpu/rng/chacha20.py``: each state row
holds the 16 32-bit words of one block; 10 double rounds, then the
feed-forward add; the 64-bit block counter lives at word 12 (low) and 13
(carry) and is advanced by :func:`step_counter`.

Torch has no ``uint32`` add or shift, so words are carried in ``int64``
and masked with ``& 0xFFFFFFFF`` after every add and shift, which is the
JAX package's ``uint32`` wrap-around.  The rounds work on the 16 word
columns as four contiguous ``[4, rows]`` blocks (a, b, c, d): one
vectorised quarter round does the four column rounds, and rolling b, c
and d by one, two and three lines turns the diagonal rounds into column
rounds.  Outputs are bit-identical to the JAX package's.
"""

import numpy as np
import torch

M32 = 0xFFFFFFFF

# "expand 32-byte k" constants, little-endian words.
NOTHING_UP_MY_SLEEVE = np.frombuffer(b"expand 32-byte k", dtype="<u4").copy()


def _rotl(x, n):
    return ((x << n) & M32) | (x >> (32 - n))


def _quarter_round(a, b, c, d):
    """Four quarter rounds at once: line i of each [4, rows] block is the
    i-th quarter round's a, b, c, d.  a and c are updated in place."""
    a.add_(b).bitwise_and_(M32)
    d = _rotl(d ^ a, 16)
    c.add_(d).bitwise_and_(M32)
    b = _rotl(b ^ c, 12)
    a.add_(b).bitwise_and_(M32)
    d = _rotl(d ^ a, 8)
    c.add_(d).bitwise_and_(M32)
    b = _rotl(b ^ c, 7)
    return b, d


def chacha20_block(state):
    """One ChaCha20 block per row.

    state: [..., 16] int64 words in [0, 2^32).  Returns the keystream
    block (working state + input state) of the same shape; the counter
    is not stepped (:func:`step_counter` does that).
    """
    shape = state.shape
    # a copy, [16, rows]: a and c are updated in place
    cols = state.reshape(-1, 16).t().clone(
        memory_format=torch.contiguous_format)
    a, b, c, d = (cols[i : i + 4] for i in range(0, 16, 4))
    for _ in range(10):
        b, d = _quarter_round(a, b, c, d)              # columns
        b = torch.roll(b, -1, 0)
        c = torch.roll(c, -2, 0)
        d = torch.roll(d, -3, 0)
        b, d = _quarter_round(a, b, c, d)              # diagonals
        b = torch.roll(b, 1, 0)
        c = torch.roll(c, 2, 0)
        d = torch.roll(d, 3, 0)
    working = torch.cat([a, b, c, d]).t()
    return ((working + state.reshape(-1, 16)) & M32).reshape(shape)


def step_counter(state, step):
    """Advance the 64-bit block counter at words 12 (low) and 13 (high) by
    ``step`` < 2^32: an int, or an int64 tensor that broadcasts against
    ``state[..., 12]`` (then the result has the broadcast shape)."""
    low = state[..., 12]
    new_low = (low + step) & M32
    carry = (new_low < low).to(state.dtype)     # wrapped => carry
    new_high = (state[..., 13] + carry) & M32
    out = state.expand(*new_low.shape, 16).clone()
    out[..., 12] = new_low
    out[..., 13] = new_high
    return out


def chacha20(state, step):
    """One keystream block per row, and the stepped states.

    Returns (random_words [..., 16], new_state), as the JAX package's
    ``chacha20``."""
    return chacha20_block(state), step_counter(state, step)


def chacha20_block_oracle(state_words):
    """Pure-python RFC 7539 block function for golden tests.

    state_words: list of 16 ints (32-bit). Returns list of 16 ints.
    """
    M = M32

    def rotl(x, n):
        return ((x << n) | (x >> (32 - n))) & M

    x = list(state_words)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & M
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & M
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & M
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & M
        x[b] = rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(a + b) & M for a, b in zip(x, state_words)]
