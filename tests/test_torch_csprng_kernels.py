"""The CSPRNG kernels' wrappers and plain versions (``ops/csprng_kernels.py``,
R1-R4) against the JAX package's functions they replace, on the CPU.

On a CPU tensor each wrapper runs its plain version; both are held here,
byte for byte (tolerance none: words, samples and counters are
integers), to ``tiberate_tpu/rng``'s ``chacha20``, ``_randint_from_words``,
``_dgauss_from_words``, ``_encrypt_noise_core`` and the generator's
``_randround_core`` on the same numpy states.  Three channel models: a toy
(logN 7, 4 + 2 channels, moduli near 2^62), a 30-bit toy (5 + 2, moduli
near 2^30) and Preset.logN14's (8 + 2).  The states are the generator's,
with adversarial counters: low words at 2^32 - 1 and at 2^32 - 1 - k inc
and 2^32 - k inc for every replica advance k inc a batch form reads
(carries into word 13), and high words at 2^32 - 1 (word 13 wraps).  The
coefficients of R4 include fractions of exactly m / 2^32, one ulp either
side, halves of 2^-32 (rounded half to even), negatives and +-0.  Last,
the wrappers' refusals: wrong dtypes, non-contiguous states, a row range
outside the state, a wrong tree, a 32-bit counter step exceeded.

Each JAX function compiles once per model: the row counts are one per
model and kernel.  The card's kernels are held to these plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 2d.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.rng import chacha20 as jcc
from tiberate_tpu.rng import csprng as jcs
from tiberate_tpu_torch.ops import csprng_kernels as ck
from tiberate_tpu_torch.rng import csprng as tcs

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
B = 3   # replicas of the batch forms
# R2's shifts (each a compile of the JAX sampler): the engine's 0 and the
# ternary secret's -1
SHIFTS = {"toy": (0, -1), "toy30": (0,), "logN14": (-1,)}
# (N, channels P, repeating, the q chain of P + repeating moduli)
MODELS = {
    "toy": (128, 4, 2, [(1 << 62) - 57, (1 << 62) - 87, (1 << 61) - 1,
                        (1 << 40) - 87, 3, (1 << 62) - 1]),
    "toy30": (128, 5, 2, [(1 << 30) - 35, (1 << 30) - 107, (1 << 29) - 3,
                          (1 << 21) - 9, 2, (1 << 30) - 1, (1 << 30) - 173]),
    "logN14": (1 << 14, 8, 2, [1099510054913, 1099515691009, 1099508121601,
                              1099515789313, 1099507695617, 1099516280833,
                              1099506515969, 1099516870657,
                              1152921504606748673, 1152921504606683137]),
}


def _u32(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def adversarial(states, inc, kmax):
    """``states`` with every second row's low counter at 2^32 - 1, or at
    2^32 - 1 - k inc or 2^32 - k inc (k <= kmax), and every seventh high
    counter at 2^32 - 1."""
    lows = [M32, *((M32 - k * inc) & M32 for k in range(kmax + 1)),
            *((M32 + 1 - k * inc) & M32 for k in range(1, kmax + 1))]
    s = states.clone()
    rows = torch.arange(0, s.shape[0], 2)
    s[rows, 12] = torch.tensor(lows)[rows % len(lows)]
    s[::7, 13] = M32
    return s


def _model(name):
    """(port generator, adversarial states, its q chain as a tensor)."""
    N, P, rep, q = MODELS[name]
    t = tcs.Csprng(num_coefs=N, num_channels=[P], num_repeating_channels=rep,
                   seed=1234, nonce=1, device="cpu")
    return t, adversarial(t.states, t.inc, 2 * B + 1), torch.tensor(q)


def _both(fn, plain, states, *args):
    """The wrapper and its plain version on copies of ``states``: their
    results (equal), and the states after."""
    a, b = states.clone(), states.clone()
    got, want = fn(a, *args), plain(b, *args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(a, b)
    return got, a


@pytest.mark.parametrize("model", sorted(MODELS))
def test_words_randint_dgauss_match_jax(model):
    """R1, R2 (shift 0 or -1) and R3 over every channel of the model:
    the JAX package's ``chacha20`` words and stepped states, and its
    samplers on those words."""
    t, states, q = _model(model)
    rows, L = states.shape[0], t.L
    jwords, jstates = jcc.chacha20(_u32(states), t.inc)
    (words,), after = _both(ck.chacha_words, ck.chacha_words_plain, states,
                            0, rows, t.inc)
    assert _eq(jwords, words) and _eq(jstates, after)
    q_rows = jnp.asarray(np.repeat(q.numpy(), L).astype(np.uint64))
    for shift in SHIFTS[model]:
        (got,), after = _both(ck.chacha_randint, ck.chacha_randint_plain,
                              states, 0, rows, q, shift, t.inc)
        want = jcs._randint_from_words(jwords, q_rows, shift)
        assert _eq(want, got) and _eq(jstates, after)
        if shift == 0:
            assert (got.reshape(-1, L * 4) < q[:, None]).all()
    (got,), after = _both(ck.chacha_dgauss, ck.chacha_dgauss_plain, states,
                          0, rows, t._btree_lo, t._btree_hi, t.tree_depth,
                          t.inc)
    jtree = tcs.build_CDT_binary_search_tree()[0]
    want = jcs._dgauss_from_words(jwords, jnp.asarray(jtree[:, 0]),
                                  jnp.asarray(jtree[:, 1]), t.tree_depth)
    assert _eq(want, got) and _eq(jstates, after)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_encrypt_noise_matches_jax(model):
    """R2 + R3 in their batch forms: the JAX package's
    ``_encrypt_noise_core`` for B messages (e, v and both channels'
    stepped states)."""
    t, states, _ = _model(model)
    L, r0 = t.L, t.repeating_start
    jtree = tcs.build_CDT_binary_search_tree()[0]
    je, jv, jt, ju = jcs._encrypt_noise_core(
        _u32(states[r0:r0 + L]), _u32(states[r0 + L:r0 + 2 * L]),
        jnp.asarray(jtree[:, 0]), jnp.asarray(jtree[:, 1]),
        jnp.asarray(np.full(B * L, 2, dtype=np.uint64)), B=B,
        depth=t.tree_depth, inc=t.inc)
    (e, v), after = _both(ck.encrypt_noise, ck.encrypt_noise_plain, states,
                          r0, L, t._btree_lo, t._btree_hi, t.tree_depth, 2,
                          B, t.inc)
    assert e.shape == (B, 2, 4 * L) and v.shape == (B, 4 * L)
    assert _eq(je, e.reshape(-1, 4)) and _eq(jv, v.reshape(-1, 4))
    assert _eq(jt, after[r0:r0 + L]) and _eq(ju, after[r0 + L:r0 + 2 * L])
    assert torch.equal(after[:r0], states[:r0])


def edge_coefs(rng, shape):
    """f64 coefficients with fractions of exactly m / 2^32, one ulp either
    side, (2m + 1) / 2^33 (a half after the x 2^32, rounded to even),
    negatives, +-0 and a few named edges."""
    c = rng.uniform(-2.0**40, 2.0**40, shape)
    whole = np.floor(rng.uniform(0, 2.0**20, shape))
    exact = whole + rng.integers(0, 1 << 32, shape) / 2.0**32
    c[:, 0::6] = exact[:, 0::6]
    c[:, 1::6] = np.nextafter(exact, np.inf)[:, 1::6]
    c[:, 2::6] = np.nextafter(exact, -np.inf)[:, 2::6]
    c[:, 3::6] = (whole + (2 * rng.integers(0, 1 << 32, shape) + 1)
                  / 2.0**33)[:, 3::6]
    c[:, 1::4] *= -1
    edges = [0.0, -0.0, 0.5, -0.5, 2.5, -2.5, 2.0**-33, 3 * 2.0**-33,
             -(2.0**-33), 1 - 2.0**-53, -(1 - 2.0**-53), 2.0**51 + 0.5]
    c[0, 5:5 + len(edges)] = edges
    c[:, 5::24] = 0.0
    c[:, 11::24] = -0.0
    return c


@pytest.mark.parametrize("model", sorted(MODELS))
def test_randround_matches_jax(model):
    """R4 over B messages: the JAX generator's ``_randround_core`` against
    the words of replica k at counter advance k inc (``randround_batch``),
    and the stored counters advanced by B inc."""
    t, states, _ = _model(model)
    N, P, rep, _ = MODELS[model]
    coefs = edge_coefs(np.random.default_rng(N + P), (B, N))
    j = jcs.Csprng(num_coefs=N, num_channels=[P], num_repeating_channels=rep,
                   seed=1234, nonce=1)
    base = _u32(states[: N // 16])
    words = jcc.chacha20_block(jnp.concatenate(
        [jcc.step_counter(base, k * t.inc) for k in range(B)]))
    want = j._randround_core(jnp.asarray(coefs.reshape(-1)), words)
    (got,), after = _both(ck.chacha_randround, ck.chacha_randround_plain,
                          states, 0, torch.from_numpy(coefs), t.inc)
    assert _eq(want, got.reshape(-1))
    assert _eq(jcc.step_counter(base, B * t.inc), after[: N // 16])
    signs = np.sign(coefs)
    assert (np.sign(got.numpy()) * signs >= 0).all()


def test_wrappers_refuse_bad_operands():
    """Wrong dtypes, non-contiguous states, row ranges outside the state, a
    q that does not split the rows, a wrong tree, a tensor on another
    device and counter steps past 32 bits raise, before any draw."""
    t, states, q = _model("toy")
    rows, lo, hi, d = states.shape[0], t._btree_lo, t._btree_hi, 5
    coefs = torch.zeros((2, 128), dtype=torch.float64)
    strided = torch.zeros((16, rows), dtype=torch.int64).t()
    bad = [
        (TypeError, ck.chacha_words, (states.int(), 0, 4, 1)),
        (ValueError, ck.chacha_words, (strided, 0, 4, 1)),
        (ValueError, ck.chacha_words, (states[:, :8], 0, 4, 1)),
        (ValueError, ck.chacha_words, (states, 0, rows + 1, 1)),
        (ValueError, ck.chacha_words, (states, -1, 4, 1)),
        (ValueError, ck.chacha_words, (states, 5, 4, 1)),
        (OverflowError, ck.chacha_words, (states, 0, 4, 1 << 32)),
        (ValueError, ck.chacha_words, (states.to("meta"), 0, 4, 1)),
        (TypeError, ck.chacha_randint, (states, 0, 6, q.int(), 0, 1)),
        (ValueError, ck.chacha_randint, (states, 0, 7, q, 0, 1)),
        (ValueError, ck.chacha_randint, (states, 0, rows + 6, q, 0, 1)),
        (ValueError, ck.chacha_dgauss, (states, 0, 4, lo[:-1], hi, d, 1)),
        (ValueError, ck.chacha_dgauss, (states, 0, 4, lo, hi, 9, 1)),
        (TypeError, ck.chacha_dgauss, (states, 0, 4, lo.double(), hi, d, 1)),
        (ValueError, ck.encrypt_noise, (states, rows - 32, 32, lo, hi, d, 2,
                                        1, 1)),
        (OverflowError, ck.encrypt_noise, (states, 0, 32, lo, hi, d, 2,
                                           1 << 20, 1 << 12)),
        (TypeError, ck.chacha_randround, (states, 0, coefs.float(), 1)),
        (ValueError, ck.chacha_randround, (states, 0, coefs[:, :120], 1)),
        (ValueError, ck.chacha_randround, (states, 0, torch.zeros(
            (128, 2), dtype=torch.float64).t(), 1)),
        (ValueError, ck.chacha_randround, (states, rows - 4, coefs, 1)),
        (OverflowError, ck.chacha_randround, (states, 0, coefs, 1 << 31)),
    ]
    for exc, fn, args in bad:
        before = states.clone()
        with pytest.raises(exc):
            fn(*args)
        assert torch.equal(states, before), (fn.__name__, exc)
