"""The port's ChaCha20 block function and counter step against the JAX
package's (``tiberate_tpu/rng/chacha20.py``) and RFC 7539.

Inputs are numpy draws from a seed; outputs are 32-bit words, so the
tolerance is none: equal words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.rng import chacha20 as jcc
from tiberate_tpu_torch.rng import chacha20 as tcc

# RFC 7539 section 2.3.2: key 00 01 .. 1f, counter 1, nonce 00:00:00:09
# 00:00:00:4a 00:00:00:00
RFC_STATE = [
    0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
    0x03020100, 0x07060504, 0x0B0A0908, 0x0F0E0D0C,
    0x13121110, 0x17161514, 0x1B1A1918, 0x1F1E1D1C,
    0x00000001, 0x09000000, 0x4A000000, 0x00000000,
]
RFC_BLOCK = [
    0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3,
    0xC7F4D1C7, 0x0368C033, 0x9AAA2204, 0x4E6CD4C3,
    0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
    0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2,
]


def _jax(state):
    return np.asarray(state, dtype=np.uint32)


def test_rfc7539_block():
    """One block of RFC 7539 section 2.3.2 through the port's block
    function and its python oracle; the input state is left as it was."""
    state = torch.tensor([RFC_STATE], dtype=torch.int64)
    out = tcc.chacha20_block(state)
    assert out.tolist() == [RFC_BLOCK]
    assert state.tolist() == [RFC_STATE]
    assert tcc.chacha20_block_oracle(RFC_STATE) == RFC_BLOCK
    np.testing.assert_array_equal(tcc.NOTHING_UP_MY_SLEEVE,
                                  jcc.NOTHING_UP_MY_SLEEVE)


@pytest.mark.parametrize("shape", [(1,), (37,), (3, 5)])
def test_block_matches_jax_on_random_states(shape):
    """Random states, with every fourth row's low counter at 0xFFFFFFFF
    (the word a carry leaves), against the JAX block function."""
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    state = rng.integers(0, 1 << 32, (*shape, 16), dtype=np.int64)
    state.reshape(-1, 16)[::4, 12] = 0xFFFFFFFF
    want = np.asarray(jcc.chacha20_block(jnp.asarray(_jax(state))))
    got = tcc.chacha20_block(torch.from_numpy(state))
    assert got.shape == state.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    row = state.reshape(-1, 16)[-1].tolist()
    assert got.reshape(-1, 16)[-1].tolist() == jcc.chacha20_block_oracle(row)


@pytest.mark.parametrize("step", [1, 5, 0xFFFF, (1 << 31) + 7, 0xFFFFFFFF])
def test_step_counter_matches_jax(step):
    """Low counters just below and above the wrap, high words at 0 and at
    0xFFFFFFFF (the high word wraps too), stepped by values up to 2^32 - 1,
    against the JAX package's step."""
    rng = np.random.default_rng(step % 1000)
    lows = [0, 1, 0xFFFFFFFF - step, 0xFFFFFFFF - step + 1, 0xFFFFFFFE,
            0xFFFFFFFF, (1 << 32) - 1 - (step >> 1)]
    state = rng.integers(0, 1 << 32, (2 * len(lows), 16), dtype=np.int64)
    state[:, 12] = [x & 0xFFFFFFFF for x in lows] * 2
    state[: len(lows), 13] = 0
    state[len(lows):, 13] = 0xFFFFFFFF
    want = np.asarray(jcc.step_counter(jnp.asarray(_jax(state)), step))
    got = tcc.step_counter(torch.from_numpy(state), step)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_step_counter_by_replica_matches_sequential_steps():
    """A tensor of steps k * inc, broadcast over replicas, gives replica k
    the state k sequential steps of inc reach, carries included (the
    batched draws' counter trajectory)."""
    rng = np.random.default_rng(2)
    inc = 0x2F00_0001
    state = rng.integers(0, 1 << 32, (6, 16), dtype=np.int64)
    state[::2, 12] = 0xFFFFFFFF - inc
    base = torch.from_numpy(state)
    ks = torch.arange(5, dtype=torch.int64)[:, None]
    batched = tcc.step_counter(base, ks * inc)
    cur = base
    for k in range(5):
        assert torch.equal(batched[k], cur)
        cur = tcc.step_counter(cur, inc)


def test_chacha20_matches_jax():
    """``chacha20(state, step)``: the words and the stepped states of 4
    random states (two at the low counter's wrap) over two steps, fed
    back, against the JAX package's."""
    rng = np.random.default_rng(75)
    state = rng.integers(0, 1 << 32, (4, 16), dtype=np.int64)
    state[::2, 12] = 0xFFFFFFFF
    jstate, tstate = jnp.asarray(_jax(state)), torch.from_numpy(state)
    for _ in range(2):
        jwords, jstate = jcc.chacha20(jstate, 3)
        twords, tstate = tcc.chacha20(tstate, 3)
        np.testing.assert_array_equal(twords.numpy(),
                                      np.asarray(jwords).astype(np.int64))
        np.testing.assert_array_equal(tstate.numpy(),
                                      np.asarray(jstate).astype(np.int64))
