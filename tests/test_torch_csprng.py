"""The port's CSPRNG (``tiberate_tpu_torch/rng/csprng.py``) against the JAX
package's (``tiberate_tpu/rng/csprng.py``).

* the samplers' 64-bit arithmetic on words with their top bits set, and
  ``randint``'s moduli up to 2^62;
* every ``Csprng`` method over three successive calls, with the channel
  model of a toy engine and of Preset.logN14, from the same seed and
  nonce: equal words and samples (tolerance none), and equal states after;
* the batch draws against the sequential ones, a mid-stream JAX generator
  carried over by ``interop.csprng_from_jax``, and ``SimpleRNG``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.rng import csprng as jcs
from tiberate_tpu.rng import discrete_gaussian_sampler as jdg
from tiberate_tpu.rng.simplerng import SimpleRNG as JSimple
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.rng import csprng as tcs
from tiberate_tpu_torch.rng import discrete_gaussian_sampler as tdg
from tiberate_tpu_torch.rng.chacha20 import chacha20_block_oracle
from tiberate_tpu_torch.rng.simplerng import SimpleRNG as TSimple

torch.set_num_threads(1)

U64 = (1 << 64) - 1


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def _words(seed, rows):
    """[rows, 16] words with the top bit of every word set in a quarter of
    the rows, and all bits set in one."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, (rows, 16),
                                             dtype=np.int64)
    w[::4] |= 0x80000000
    w[1] = 0xFFFFFFFF
    return w


def test_umul64hi_exact():
    """High 64 bits of 64 x 64-bit products, top bits set, against python
    ints."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, 512, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, 512, dtype=np.uint64)
    a[:4] = [U64, U64, 1 << 63, 0]
    b[:4] = [U64, 1, U64, U64]
    got = tcs._umul64hi(torch.from_numpy(a.view(np.int64)),
                        torch.from_numpy(b.view(np.int64)))
    want = [(int(x) * int(y)) >> 64 for x, y in zip(a, b)]
    assert (got.numpy().view(np.uint64) == np.array(want, np.uint64)).all()


@pytest.mark.parametrize("qbits", [2, 30, 41, 61, 62])
def test_randint_from_words_matches_jax(qbits):
    """Moduli of ``qbits`` bits (the top one 2^62 - 57) on words whose top
    bits are set; also against the exact (u128 * q) >> 128."""
    rows = 64
    rng = np.random.default_rng(qbits)
    q = rng.integers(1 << (qbits - 1), 1 << qbits, rows, dtype=np.int64)
    q[0] = (1 << qbits) - (57 if qbits == 62 else 1)
    w = _words(qbits, rows)
    want = jcs._randint_from_words(jnp.asarray(w.astype(np.uint32)),
                                   jnp.asarray(q.astype(np.uint64)), 0)
    got = tcs._randint_from_words(torch.from_numpy(w), torch.from_numpy(q),
                                  0)
    assert _eq(want, got)
    for i in (0, 1, 5):
        for s in range(4):
            x = w[i, 4 * s : 4 * s + 4].tolist()
            u = (x[0] << 32 | x[1]) | (x[3] << 64) | (x[2] << 96)
            assert int(got[i, s]) == (u * int(q[i])) >> 128
    shifted = tcs._randint_from_words(torch.from_numpy(w),
                                      torch.from_numpy(q), -1)
    assert torch.equal(shifted, got - 1)


def test_dgauss_from_words_matches_jax_and_oracle():
    btree, _, depth = tdg.build_CDT_binary_search_tree()
    jtree, jsize, jdepth = jdg.build_CDT_binary_search_tree()
    np.testing.assert_array_equal(btree, jtree)
    assert (btree.shape[0], depth) == (jsize, jdepth)
    w = _words(3, 256)
    lo = torch.from_numpy(np.ascontiguousarray(btree[:, 0]).view(np.int64))
    hi = torch.from_numpy(btree[:, 1].astype(np.int64))
    got = tcs._dgauss_from_words(torch.from_numpy(w), lo, hi, depth)
    want = jcs._dgauss_from_words(jnp.asarray(w.astype(np.uint32)),
                                  jnp.asarray(jtree[:, 0]),
                                  jnp.asarray(jtree[:, 1]), depth)
    assert _eq(want, got)
    for i in range(8):
        for s in range(4):
            x = w[i, 4 * s : 4 * s + 4].tolist()
            r_high, r_low = x[2] << 32 | x[3], x[0] << 32 | x[1]
            want_i = jdg.sample_oracle(r_high, r_low, jtree, depth)
            assert tdg.sample_oracle(r_high, r_low, btree, depth) == want_i
            assert int(got[i, s]) == want_i


# (num_coefs, P, repeating channels, the q chain of randint): a toy engine
# (logN 7, 4 + 2 primes) and Preset.logN14 (8 + 1 primes, 2 repeating)
MODELS = {
    "toy": (128, 4, 2, [(1 << 30) - 35, (1 << 30) - 107, (1 << 30) - 173,
                        (1 << 30) - 237, (1 << 61) - 1, (1 << 62) - 57]),
    "logN14": (1 << 14, 8, 2, [1099510054913, 1099515691009, 1099508121601,
                              1099515789313, 1099507695617, 1099516280833,
                              1099506515969, 1152921504606748673,
                              1152921504606683137]),
}


_JAX = {}


def _pair(model, seed=1234, nonce=1):
    """(JAX, port) generators of ``model`` from (seed, nonce).  One JAX
    generator per model, refreshed: its block function is jitted per
    instance, and a new instance compiles it anew."""
    N, P, rep, _ = MODELS[model]
    kw = dict(num_coefs=N, num_channels=[P], num_repeating_channels=rep,
              seed=seed, nonce=nonce)
    if model not in _JAX:
        _JAX[model] = jcs.Csprng(**kw)
    j = _JAX[model]
    j.refresh(seed, nonce)
    j._calls = 0
    return j, tcs.Csprng(**kw, device="cpu")


def _draws(rng, method, model):
    """One call of ``method`` -> a tuple of arrays (numpy inputs from a
    seed that depends on the call count).  The block rows of one model's
    draws come in three counts only: the q chain's channels, one channel,
    and randround's N/16 rows (the JAX generator compiles its block
    function once for each)."""
    N, _, _, q = MODELS[model]
    rng._calls = getattr(rng, "_calls", 0) + 1
    src = np.random.default_rng(rng._calls)
    chain = len(q) - 2                    # non-repeating channels of q
    if method == "randbytes":
        return (rng.randbytes(shares=chain, repeats=2),
                rng.randbytes(shares=0, repeats=1, reshape=True))
    if method == "randint":
        return (rng.randint(amax=q, repeats=2),
                rng.randint(amax=3, shift=-1, repeats=1),
                rng.randint(amax=q[-1:]))
    if method == "discrete_gaussian":
        return (rng.discrete_gaussian(repeats=1),
                rng.discrete_gaussian(non_repeats=chain, repeats=2))
    if method == "randround":
        coef = src.uniform(-2**52, 2**52, N)
        coef[:4] = [0.5, -0.5, 2.5, -(2**52 + 0.5)]
        return (rng.randround(coef),)
    if method == "randround_batch":
        return (rng.randround_batch(src.uniform(-1e12, 1e12, (3, N))),)
    if method == "encrypt_noise_batch":
        return rng.encrypt_noise_batch(8)
    raise ValueError(method)


METHODS = ["randbytes", "randint", "discrete_gaussian", "randround",
           "randround_batch", "encrypt_noise_batch"]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("method", METHODS)
def test_csprng_method_matches_jax(model, method):
    """Three successive calls from the same (seed, nonce): equal draws
    every time (a counter that carries wrongly shows on the second or
    third), and equal states after."""
    j, t = _pair(model)
    assert _eq(j.states, t.states)
    for _ in range(3):
        for want, got in zip(_draws(j, method, model),
                             _draws(t, method, model)):
            assert got.dtype == torch.int64
            assert got.shape == tuple(np.shape(want))
            assert _eq(want, got)
    assert _eq(j.states, t.states)


def test_batch_draws_equal_sequential_draws():
    """``randround_batch`` gives B sequential ``randround`` calls' bytes and
    ``encrypt_noise_batch(B)`` B sequential encrypt draw pairs'
    (``discrete_gaussian(repeats=2)``, ``randint(amax=2, repeats=1)[0]``),
    with the same states after, twice in a row."""
    N = MODELS["toy"][0]
    a, b = _pair("toy")[1], _pair("toy")[1]
    src = np.random.default_rng(4)
    for _ in range(2):
        coefs = src.uniform(-1e6, 1e6, (4, N))
        assert torch.equal(a.randround_batch(coefs),
                           torch.stack([b.randround(c) for c in coefs]))
        e, v = a.encrypt_noise_batch(5)
        for k in range(5):
            assert torch.equal(e[k], b.discrete_gaussian(repeats=2))
            assert torch.equal(v[k], b.randint(amax=2, shift=0,
                                               repeats=1)[0])
        assert torch.equal(a.states, b.states)


def test_batch_draws_refuse_a_counter_step_past_32_bits():
    """B * inc (2 B * inc for the noise) must stay below 2^32, where one
    add equals B sequential counter steps."""
    t = _pair("logN14")[1]                     # inc = 10 * 4096
    with pytest.raises(OverflowError):
        t.encrypt_noise_batch((1 << 32) // (2 * t.inc) + 1)
    with pytest.raises(OverflowError):
        t.randround_batch(np.zeros(((1 << 32) // t.inc + 1, 1)))


def test_refresh_key_and_nonce_derivation():
    """An int seed without a nonce: key and nonce from one numpy stream;
    with a nonce, or a word-list seed, as the JAX package derives them."""
    for seed, nonce in ((7, None), (7, 3), ([1, 2, 3, 4, 5, 6, 7, 2**33],
                                            [9, 10])):
        j = jcs.Csprng(num_coefs=64, num_channels=[2], seed=seed,
                       nonce=nonce)
        t = tcs.Csprng(num_coefs=64, num_channels=[2], seed=seed,
                       nonce=nonce, device="cpu")
        assert (t.key, t.nonce) == (j.key, j.nonce)
        assert _eq(j.states, t.states)
    row = t.states[5].tolist()
    assert t.randbytes()[5].tolist() == chacha20_block_oracle(row)


def test_interop_carries_a_mid_stream_generator():
    """A JAX generator after some draws, carried into the port, continues
    its stream: the next draws of both are equal."""
    j, _ = _pair("toy", seed=99, nonce=4)
    j.randint(amax=MODELS["toy"][3], repeats=2)
    j.randround_batch(np.full((3, 128), 0.25))
    t = interop.csprng_from_jax(j, device="cpu")
    assert (t.key, t.nonce, t.inc) == (j.key, j.nonce, j.inc)
    for method in ("discrete_gaussian", "encrypt_noise_batch", "randint"):
        for want, got in zip(_draws(j, method, "toy"),
                             _draws(t, method, "toy")):
            assert _eq(want, got)


def test_csprng_draw_supports_and_moments():
    """Over 2^16 draws: the discrete Gaussian's sample std within 2% of
    sigma = 3.2 and no draw past the table's 31; randint's ternary draws
    in {-1, 0, 1}; stochastic rounding unbiased to within 1% of a unit."""
    t = tcs.Csprng(num_coefs=1 << 14, num_channels=[2], seed=4,
                   device="cpu")
    g = t.discrete_gaussian(non_repeats=2, repeats=2).double()
    assert abs(float(g.std()) / 3.2 - 1) < 0.02
    assert float(g.abs().max()) <= 31
    assert set(t.randint(amax=3, shift=-1, repeats=1).unique().tolist()) == {
        -1, 0, 1}
    r = t.randround(np.full(1 << 14, -2.25))
    assert set(r.tolist()) == {-2, -3}
    assert abs(float(r.double().mean()) + 2.25) < 0.01


def test_simplerng_matches_jax():
    """The numpy stand-in: the JAX one's draws for the same seed, with the
    supports asked of them."""
    kw = dict(num_coefs=256, num_channels=[3], num_repeating_channels=2,
              seed=5)
    j, t = JSimple(**kw), TSimple(**kw, device="cpu")
    q = [97, 1 << 40, (1 << 61) - 1]
    pairs = [
        (j.randbytes(repeats=1), t.randbytes(repeats=1)),
        (j.randint(amax=q, repeats=1), t.randint(amax=q, repeats=1)),
        (j.randint(amax=3, shift=-1), t.randint(amax=3, shift=-1)),
        (j.discrete_gaussian(2, 1), t.discrete_gaussian(2, 1)),
        (j.randround(np.full(256, 1.5)), t.randround(np.full(256, 1.5))),
    ]
    for want, got in pairs:
        assert _eq(want, got)
    words, u, tern, g, r = (got for _, got in pairs)
    assert words.shape == (4 * 64, 16) and int(words.max()) < 1 << 32
    for row, qi in zip(u, q):
        assert 0 <= int(row.min()) and int(row.max()) < qi
    assert set(tern.unique().tolist()) <= {-1, 0, 1}
    assert g.shape == (3, 256)
    assert set(r.unique().tolist()) == {1, 2}


def test_channeled_states_match_jax():
    """``channeled_states`` ([channels, L, 16]) after one draw."""
    j, t = _pair("toy")
    _draws(j, "randint", "toy")
    _draws(t, "randint", "toy")
    assert t.channeled_states.shape == (t.total_num_channels
                                        + t.num_repeating_channels, t.L, 16)
    assert _eq(j.channeled_states, t.channeled_states)
