"""The threshold (multiparty) extension of tiberate_tpu_torch against the
JAX package's party run on the CPU.

Both extension engines come from one configuration object (the JAX
package's ``toy_config(logN=7, num_scales=3, num_special_primes=1)``, the
one ``tests/test_extensions.py`` runs) with seed 303, nonce 4 and the bias
guard off, and run the same protocol steps in the same order, so they
draw the same values: every key share, collective key, ciphertext, head
and partial decryption is byte-identical, and the fused decryptions are
the same floats.

* two parties: secret keys, the first party's public key, its common
  random ``a`` (``multiparty_public_crs``, a copy on the engine's
  device), the second party's key under it, the collective public key;
* collective encrypt, head + partial + fusion within ``TOL``; a single
  share decrypts to garbage (error > 1.0);
* a collective rotation key (the second party under the first one's
  per-part ``a``), one rotation decrypted by fusion within 50 x ``TOL``;
* collective Galois keys (``generate_galois_crs``);
* the three rounds of the evaluation-key share protocol.

``TOL`` = 5e-4 (``tests/test_extensions.py:18``, and its 50 x for the
rotation).
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.extension import mpc as jmpc
from tiberate_tpu_torch.extension import mpc as tmpc

torch.set_num_threads(1)

TOL = 5e-4


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if hasattr(x, "_flags"):  # a DataStruct of either package
        return _leaves(x.data)
    return [x]


def _same(j, t):
    jl, tl = _leaves(j), _leaves(t)
    return len(jl) == len(tl) and all(_eq(a, b) for a, b in zip(jl, tl))


@pytest.fixture(scope="module")
def engines():
    cfg = toy_config(logN=7, num_scales=3, num_special_primes=1,
                     scale_bits=30)
    j = jmpc.CkksEngineMPCExtension(cfg, seed=303, nonce=4, bias_guard=False)
    t = tmpc.CkksEngineMPCExtension(cfg, device="cpu", seed=303, nonce=4,
                                    bias_guard=False)
    return j, t


def _parties(eng):
    sk1 = eng._create_secret_key()
    sk2 = eng._create_secret_key()
    pk1 = eng.multiparty_create_public_key(sk1)
    crs = eng.multiparty_public_crs(pk1)
    pk2 = eng.multiparty_create_public_key(sk2, a=crs)
    cpk = eng.multiparty_create_collective_public_key([pk1, pk2])
    return sk1, sk2, pk1, crs, pk2, cpk


@pytest.fixture(scope="module")
def parties(engines):
    return tuple(_parties(eng) for eng in engines)


def test_collective_keys_match_jax(engines, parties):
    """Both parties' secret keys, public keys under one ``a`` and the
    collective key: the JAX party run's bytes; the common ``a`` is a copy
    on the engine's device."""
    (j, t), (jp, tp) = engines, parties
    for a, b in zip(jp, tp):
        assert _same(a, b)
    crs, pk1 = tp[3], tp[2]
    assert crs.device == t.device and torch.equal(crs, pk1.data[1])
    assert crs.data_ptr() != pk1.data[1].data_ptr()
    assert tp[5]._flags.dumps() == jp[5]._flags.dumps()
    assert np.array_equal(np.asarray(j.rng.states), t.rng.states.numpy())


def test_collective_encrypt_and_threshold_decrypt(engines, parties):
    """Encrypt under the collective key; head (party 1) + partial (party 2)
    + fusion: the JAX bytes and floats, within ``TOL``; one share alone
    decodes to garbage in both packages."""
    (j, t), (jp, tp) = engines, parties
    m = np.linspace(-1, 1, t.num_slots)
    jct, tct = j.encodecrypt(m, pk=jp[5]), t.encodecrypt(m, pk=tp[5])
    assert _same(jct, tct)
    jh, th = (e.multiparty_decrypt_head(c, p[0])
              for e, c, p in ((j, jct, jp), (t, tct, tp)))
    jq, tq = (e.multiparty_decrypt_partial(c, p[1])
              for e, c, p in ((j, jct, jp), (t, tct, tp)))
    assert _eq(jh, th) and _eq(jq, tq)
    jout = j.multiparty_decrypt_fusion([jh, jq], level=0, is_real=True)
    tout = t.multiparty_decrypt_fusion([th, tq], level=0, is_real=True)
    assert np.array_equal(jout, tout)
    assert np.abs(tout - m).max() < TOL
    single = t.multiparty_decrypt_fusion([th], level=0, is_real=True)
    assert np.array_equal(
        single, j.multiparty_decrypt_fusion([jh], level=0, is_real=True))
    assert np.abs(single - m).max() > 1.0
    from tiberate_tpu import errors as jerrors
    from tiberate_tpu_torch import errors as terrors

    for e, ct, err in ((j, jct.clone(), jerrors), (t, tct.clone(), terrors)):
        ct.set_flag(type(ct._flags).NTT_STATE)
        with pytest.raises(err.NTTStateError, match="NTT_STATE=False"):
            e.multiparty_decrypt_head(ct, jp[0] if e is j else tp[0])


def test_collective_rotation_matches_jax(engines, parties):
    """Party 1's rotation key share, its per-part ``a``, party 2's share
    under it, the collective rotation key, one rotation and its fused
    decryption: the JAX bytes, within 50 x ``TOL`` of ``np.roll``."""
    (j, t), (jp, tp) = engines, parties
    m = np.linspace(-1, 1, t.num_slots)
    outs = []
    for e, p in ((j, jp), (t, tp)):
        sk1, sk2, cpk = p[0], p[1], p[5]
        rotk1 = e.multiparty_create_rotation_key(sk1, 1)
        crs = e.generate_rotation_crs(rotk1)
        rotk2 = e.multiparty_create_rotation_key(sk2, 1, a=crs)
        crotk = e.multiparty_generate_rotation_key([rotk1, rotk2])
        ct = e.encodecrypt(m, pk=cpk)
        rot = e.rotate_single(ct, crotk)
        head = e.multiparty_decrypt_head(rot, sk1)
        part = e.multiparty_decrypt_partial(rot, sk2)
        out = e.multiparty_decrypt_fusion([head, part], level=0,
                                          is_real=True)
        outs.append((rotk1, rotk2, crotk, rot, head, part, out))
    for a, b in zip(*outs[:2]):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert _same(a, b)
    assert outs[1][2].delta == 1
    assert np.abs(outs[1][-1] - np.roll(m, 1)).max() < 50 * TOL


def test_collective_galois_and_evk_protocol_match_jax(engines, parties):
    """Collective Galois keys (party 2 under party 1's ``a`` of every
    rotation key) and the evaluation key's three rounds (share-sum,
    multiply by each party's key, share-sum): the JAX party run's
    bytes."""
    (j, t), (jp, tp) = engines, parties
    outs = []
    for e, p in ((j, jp), (t, tp)):
        sk1, sk2 = p[0], p[1]
        g1 = e.multiparty_create_galois_key(
            sk1, [None] * (e.ckksCfg.logN - 1))
        g2 = e.multiparty_create_galois_key(sk2, e.generate_galois_crs(g1))
        cg = e.multiparty_generate_galois_key([g1, g2])
        evk_a = [part[1] for part in e.create_key_switching_key(
            sk1, sk1).data]
        shares = [e.multiparty_create_key_switching_key(sk, sk, a=evk_a)
                  for sk in (sk1, sk2)]
        evk_sum = e.multiparty_sum_evk_share(shares)
        mults = [e.multiparty_mult_evk_share_sum(evk_sum, sk)
                 for sk in (sk1, sk2)]
        evk = e.multiparty_sum_evk_share_mult(mults)
        outs.append((g1, g2, cg, evk_sum, *mults, evk))
    for a, b in zip(*outs):
        assert type(b).__name__ == type(a).__name__
        assert _same(a, b)
    assert [k.delta for k in outs[1][2].data] == [1, 2, 4, 8, 16, 32]
    assert type(outs[1][-1]).__name__ == "EvaluationKey"
