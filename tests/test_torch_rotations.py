"""Rotations, conjugation and their keys: tiberate_tpu_torch against the JAX
package on the CPU.

Both engines come from the same (seed, nonce) at the toy
``toy_config(logN=7, num_scales=4, num_special_primes=2)`` and its 30-bit
twin, keyed in the same order (sk, pk, evk); each test first carries the
JAX engine's CSPRNG state and rotation-key store over
(``interop.csprng_from_jax``, ``interop.from_jax``), so both draw the same
keys in the same order.

* rotation keys (deltas 1, 2, 5, the six of ``gk``) and the conjugation
  key byte-identical;
* ``rotate_offset`` (1, 2, 5, -3, and 3, which ``decompose_rot_offsets``
  composes), ``rotate_galois`` and ``conjugate`` on JAX-made ciphertexts
  byte-identical, and within ``TOL`` of ``np.roll`` / ``np.conj``;
* a batch of 3 rotated at once equals the 3 single rotations;
* ``allow_sk_gen=False`` raises as in the JAX package;
* ``ops/ntt.intt_exit_reduce_signed`` on the same residues;
* ``sum`` byte-identical and within 200 x ``TOL``.

Tolerances: the JAX package's (``tests/test_engine.py:17``: 5e-5, and its
``sum`` bound 200 x that, ``:168-175``; the 30-bit toy
``tests/test_mode30.py:21``: 1e-2).
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.utils import encoding as tcodec
from tiberate_tpu_torch.utils import massive

torch.set_num_threads(1)

CASES = {
    "toy": (dict(scale_bits=30), 5e-5),
    "toy30": (dict(scale_bits=21, buffer_bit_length=30), 1e-2),
}
_PAIRS = {}


def _cfg(case):
    return toy_config(logN=7, num_scales=4, num_special_primes=2,
                      **CASES[case][0])


def _pair(case):
    """(JAX engine, port engine) from seed 21, nonce 5, keyed sk, pk, evk;
    built once per case."""
    if case not in _PAIRS:
        j = jeng.CkksEngine(_cfg(case), seed=21, nonce=5)
        t = teng.CkksEngine(_cfg(case), device="cpu", seed=21, nonce=5)
        for eng in (j, t):
            eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
        _PAIRS[case] = (j, t)
    return _PAIRS[case]


def _synced(case):
    """The pair with the port's CSPRNG and rotation-key store set to the
    JAX engine's."""
    j, t = _pair(case)
    t.rng = interop.csprng_from_jax(j.rng, device="cpu")
    t.rotk = {d: interop.from_jax(j.rotk[d], device="cpu")
              for d in j.rotk.keys()}
    return j, t


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


def _same(j_leaves, t_leaves):
    j_leaves, t_leaves = list(j_leaves), list(t_leaves)
    return len(j_leaves) == len(t_leaves) and all(
        _eq(a, b) for a, b in zip(j_leaves, t_leaves))


def _key_leaves(ksk):
    return [leaf for part in ksk.data for leaf in part]


def _msgs(t, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, t.num_slots) for _ in range(n)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


def test_galois_tables_match_jax():
    """The port's Galois tables and numpy rotations are the JAX
    package's."""
    from tiberate_tpu.utils import encoding as jcodec
    from tiberate_tpu.utils import massive as jmassive

    N = 128
    x = np.arange(N) - 40
    for leap in (jcodec.rotate_leap(5, N), jcodec.conjugate_leap(N)):
        for a, b in zip(jcodec.rotation_perm_tables(N, leap),
                        tcodec.rotation_perm_tables(N, leap)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for d in (1, 3, -7):
        assert tcodec.rotate_leap(d, N) == jcodec.rotate_leap(d, N)
        assert np.array_equal(tcodec.rotate_np(x, d), jcodec.rotate_np(x, d))
    assert np.array_equal(tcodec.conjugate_np(x), jcodec.conjugate_np(x))
    for off in (3, -3, 5, 21, -1):
        assert massive.decompose_rot_offsets(off, 64, {1: 0, 5: 0}) == \
            jmassive.decompose_rot_offsets(off, 64, {1: 0, 5: 0})
        assert massive.decompose_with_power_of_2(off, 64) == \
            jmassive.decompose_with_power_of_2(off, 64)


def test_intt_exit_reduce_signed_matches_jax(case):
    """``ops/ntt.intt_exit_reduce_signed`` (the centred iNTT exit) on the
    same residues, both lanes."""
    from tiberate_tpu.context.ntt_context import CkksParams as JParams
    from tiberate_tpu.ops import ntt as jntt
    from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams
    from tiberate_tpu_torch.ops import ntt as tntt

    jlp = JParams(_cfg(case)).lp(0, False)
    tlp = TParams(_cfg(case), "cpu").lp(0, False)
    q = np.asarray(tlp.pack.q)[:, None].astype(np.int64)
    x = (np.random.default_rng(7).integers(0, 1 << 62, (2, *tlp.psi.shape))
         % q).astype(tlp.psi.numpy().dtype)
    want = jntt.intt_exit_reduce_signed(x, jlp.ipsi, jlp.Ninv, jlp.pack)
    got = tntt.intt_exit_reduce_signed(torch.from_numpy(x), tlp.ipsi,
                                       tlp.Ninv, tlp.pack)
    assert bool((got < 0).any()) and _eq(want, got)


def test_rotation_galois_and_conjugation_keys_match_jax(case):
    """Rotation keys for deltas 1, 2 and 5, the Galois key's six and the
    conjugation key, made in the same order by both engines: the same
    bytes (each a key-switching key from the permuted secret key, whose
    negative words pass through the forward NTT)."""
    j, t = _synced(case)
    for d in (1, 2, 5):
        jk, tk = j.rotk[d], t.rotk[d]
        assert type(tk).__name__ == "RotationKey" and tk.delta == d
        assert _same(_key_leaves(jk), _key_leaves(tk)), d
    assert sorted(t.rotk.keys()) == sorted(j.rotk.keys())
    jg, tg = j.gk, t.gk
    assert [k.delta for k in tg.data] == [1, 2, 4, 8, 16, 32]
    for jk, tk in zip(jg.data, tg.data):
        assert _same(_key_leaves(jk), _key_leaves(tk)), tk.delta
    carried = interop.from_jax(jg, device="cpu")
    assert [k.delta for k in carried.data] == [1, 2, 4, 8, 16, 32]
    assert massive.datastruct_size_bytes(carried) == \
        massive.datastruct_size_bytes(tg)
    jc, tc = j.conjk, t.conjk
    assert type(tc).__name__ == "ConjugationKey"
    assert _same(_key_leaves(jc), _key_leaves(tc))
    assert tc._flags == interop.from_jax(jc, device="cpu")._flags
    assert _eq(j.rng.states, t.rng.states)


@pytest.fixture(scope="module")
def jax_cts(case):
    """Two JAX-made ciphertexts of the case (real and complex messages)."""
    j, _ = _pair(case)
    m1, m2 = _msgs(j, 2)
    mc = m1 + 1j * m2
    return (m1, mc), [j.encodecrypt(m1), j.encodecrypt(mc)]


def test_rotate_offset_and_conjugate_match_jax(case, jax_cts):
    """``rotate_offset`` by 1, 2, 5, 3 (composed: 1 + 2) and -3 (composed
    from powers of 2, keys made on first use), ``rotate_galois`` and
    ``conjugate``: the JAX package's bytes, the offsets it composes, and
    decrypts within the case's bound."""
    _pair(case)[0].conjk  # noqa: B018 — made before the streams are synced
    j, t = _synced(case)
    tol = CASES[case][1]
    (m, mc), (jct, jcc) = jax_cts
    ct, cc = (interop.from_jax(c, device="cpu") for c in (jct, jcc))
    for off in (1, 2, 5, 3, -3):
        jr = j.rotate_offset(jct, off, return_decomposed_offsets=True)
        tr = t.rotate_offset(ct, off, return_decomposed_offsets=True)
        if isinstance(jr, tuple):
            (jr, joffs), (tr, toffs) = jr, tr
            assert toffs == joffs, off
        assert tr.level == jr.level and _same(jr.data, tr.data), off
        err = np.abs(t.decryptcode(tr, is_real=True) - np.roll(m, off)).max()
        assert err < tol, (off, err)
    assert sorted(t.rotk.keys()) == sorted(j.rotk.keys())
    jr = j.rotate_galois(jct, delta=2)
    assert _same(jr.data, t.rotate_galois(ct, delta=2).data)
    tconj = t.conjugate(cc, interop.from_jax(j.conjk, device="cpu"))
    assert _same(j.conjugate(jcc).data, tconj.data)
    assert np.abs(t.decryptcode(tconj) - np.conj(mc)).max() < tol
    assert _eq(j.rng.states, t.rng.states)


def test_rotation_batch_equals_singles(case, jax_cts):
    """A batch of 3 ciphertexts rotated (and conjugated) in one call gives
    the bytes of 3 single calls."""
    _, t = _synced(case)
    cts = [interop.from_jax(c, device="cpu") for c in jax_cts[1]]
    cts.append(t.negate(cts[0]))
    batch = teng.stack_ciphertexts(cts)
    for op in (lambda c: t.rotate_offset(c, 1), t.conjugate):
        outs = teng.unstack_ciphertext(op(batch))
        for out, single in zip(outs, map(op, cts)):
            assert all(torch.equal(a, b)
                       for a, b in zip(out.data, single.data))


def test_sum_matches_jax(case):
    """``sum``: logN - 1 rotations and adds, the JAX package's bytes, and
    every slot within 200 x the bound of the sum of the message.  The
    ciphertext is encrypted before the port's CSPRNG is synced, so the
    rotation keys ``sum`` makes come from the same point of the stream in
    both packages, whichever tests ran before."""
    j, _ = _pair(case)
    m = np.full(j.num_slots, 0.25)
    jct = j.encodecrypt(m)
    j, t = _synced(case)
    jsum = j.sum(jct)
    tsum = t.sum(interop.from_jax(jct, device="cpu"))
    assert _same(jsum.data, tsum.data)
    out = t.decryptcode(tsum, is_real=True)
    assert np.abs(out - 0.25 * t.num_slots).max() < 200 * CASES[case][1]


def test_allow_sk_gen_false_raises_as_jax():
    """``allow_sk_gen=False``: no secret key and no missing rotation key
    is made, with the JAX package's exception and message; a key set by
    hand is used."""
    jk, tk = _pair("toy")
    j = jeng.CkksEngine(_cfg("toy"), allow_sk_gen=False, seed=1)
    t = teng.CkksEngine(_cfg("toy"), device="cpu", allow_sk_gen=False,
                        seed=1)
    for call in (lambda e: e.sk, lambda e: e.rotk[3],
                 lambda e: e.get_rotation_key(3)):
        with pytest.raises(RuntimeError) as jexc:
            call(j)
        with pytest.raises(RuntimeError) as texc:
            call(t)
        assert str(texc.value) == str(jexc.value)
    t.sk = tk.sk
    t.rotk = {1: tk.rotk[1]}
    assert t.rotk[1] is tk.rotk[1] and 1 in t.rotk and 3 not in t.rotk
    with pytest.raises(RuntimeError, match="delta=2 and key generation"):
        t.rotate_offset(interop.from_jax(jk.encodecrypt([0.5]),
                                         device="cpu"), 3)
