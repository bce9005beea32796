"""The port's native host oracle (``tiberate_tpu_torch/utils/native.py``,
``csrc/native_oracle.cpp``) against the JAX package's loader, a schoolbook
sum, the port's plain NTT product and the port's ChaCha20.

The port's copy fixes the root of the JAX copy's negacyclic product
(``native/tiberate_native.cpp:85`` raises psi, of order 2N, to (q-1)/len,
an order-len root only when (q-1)/2N is odd): the two oracles agree on the
primes whose quotient is odd, and the port's equals the exact sum on one
whose quotient is even.  Everything is exact integer arithmetic: no
tolerance.
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.utils import native as jnative
from tiberate_tpu_torch.config import CkksConfig, Preset
from tiberate_tpu_torch.context.ntt_context import CkksParams
from tiberate_tpu_torch.ops import mont, ntt
from tiberate_tpu_torch.rng.chacha20 import chacha20_block
from tiberate_tpu_torch.utils import native


@pytest.fixture(scope="module")
def libs():
    """Both oracles; the port's must build wherever the JAX one does."""
    try:
        jnative.load()
    except jnative.NativeUnavailable as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    return native.load()


def _params(preset):
    return CkksParams(CkksConfig.parse(preset), "cpu")


def _schoolbook(a, b, q, k):
    """Coefficient k of a*b mod (X^N + 1, q), exactly."""
    N = len(a)
    a, b = [int(x) for x in a], [int(x) for x in b]
    s = sum(a[i] * b[k - i] for i in range(k + 1))
    s -= sum(a[i] * b[N + k - i] for i in range(k + 1, N))
    return s % q


def test_oracle_matches_jax_where_its_root_is_right(libs):
    """logN15's chain: the primes with odd (q - 1)/2N give the JAX
    oracle's bytes; the even ones are where the JAX copy is wrong."""
    N = 1 << 15
    q_all = _params(Preset.logN15).q
    odd = [q for q in q_all if ((q - 1) // (2 * N)) % 2]
    assert odd and len(odd) < len(q_all)
    rng = np.random.default_rng(0)
    for q in odd:
        a, b = (rng.integers(0, q, N, dtype=np.int64) for _ in range(2))
        assert np.array_equal(native.negacyclic_mul(a, b, q),
                              jnative.negacyclic_mul(a, b, q)), q


def test_oracle_matches_schoolbook_for_an_even_quotient(libs):
    """q = 1152921504606584833 at N = 2^15: (q - 1)/2N is even; the JAX
    oracle differs from the exact sum there, the port's equals it."""
    q, N = 1152921504606584833, 1 << 15
    assert ((q - 1) // (2 * N)) % 2 == 0
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, q, N, dtype=np.int64) for _ in range(2))
    got = native.negacyclic_mul(a, b, q)
    ks = (0, 1, 12345, N - 1)
    want = [_schoolbook(a, b, q, k) for k in ks]
    assert [int(got[k]) for k in ks] == want
    jgot = jnative.negacyclic_mul(a, b, q)
    assert [int(jgot[k]) for k in ks] != want


@pytest.mark.parametrize("preset", ["logN15", "logN16"])
def test_plain_ntt_product_matches_oracle(libs, preset):
    """The port's plain enter_ntt -> mont_mult -> intt_exit_reduce on every
    prime of the chain equals the oracle's exact product."""
    prm = _params(preset)
    lp = prm.lp(0, True)
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(np.stack([rng.integers(0, q, prm.N)
                                       for q in prm.q]).astype(np.int64))
            for _ in range(2))
    A = ntt.enter_ntt(a, lp.Rs, lp.psi, lp.pack)
    B = ntt.enter_ntt(b, lp.Rs, lp.psi, lp.pack)
    got = ntt.intt_exit_reduce(mont.mont_mult(A, B, lp.pack), lp.ipsi,
                               lp.Ninv, lp.pack).numpy()
    for c, q in enumerate(prm.q):
        assert np.array_equal(got[c], native.negacyclic_mul(
            a[c].numpy(), b[c].numpy(), q)), (preset, c)


def test_chacha20_matches_port_block_function(libs):
    rng = np.random.default_rng(3)
    states = rng.integers(0, 2**32, (4096, 16), dtype=np.uint32)
    states[:, 12] = 0xFFFFFFFF
    want = chacha20_block(torch.from_numpy(states.astype(np.int64)))
    assert np.array_equal(native.chacha20_blocks(states).astype(np.int64),
                          want.numpy())
    assert np.array_equal(native.chacha20_blocks(states),
                          jnative.chacha20_blocks(states))


def test_mont_verify_prime_and_shoup_rows_match_jax(libs):
    q = 1152921504606830593
    rng = np.random.default_rng(4)
    pack = mont.ModPack.from_q([q])
    a = torch.from_numpy(rng.integers(0, 2 * q, (1, 4096), dtype=np.int64))
    b = torch.from_numpy(rng.integers(0, 2 * q, (1, 4096), dtype=np.int64))
    got = mont.mont_mult(a, b, pack).numpy()
    bad = got.copy()
    bad[0, 7] += 1
    for g, n in ((got, 0), (bad, 1)):
        assert native.mont_mult_verify(a, b, g, q) == n
        assert jnative.mont_mult_verify(a.numpy(), b.numpy(), g, q) == n
    for n in (1, 2, 4, 97, 2**31 - 1, 2**62 - 1, q, q + 2):
        assert native.is_prime(n) == jnative.is_prime(n), n
    k = rng.integers(0, 2 * q, 1024).astype(np.uint64)
    rinv = pow(1 << 62, -1, q)
    outs = []
    for mod in (native, jnative):
        w, s = np.empty_like(k), np.empty_like(k)
        mod.shoup_key_row(k, q, rinv, 62, w, s)
        outs.append((w, s))
    assert all(np.array_equal(x, y) for x, y in zip(*outs))
    assert int(outs[0][0][5]) == int(k[5]) * rinv % q
