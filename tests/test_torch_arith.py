"""CkksEngine's arithmetic beyond cc_mult: tiberate_tpu_torch against the
JAX package on the CPU.

Both engines come from the same (seed, nonce) at the toy
``toy_config(logN=7, num_scales=4, num_special_primes=2)`` and its 30-bit
twin, keyed in the same order; ciphertexts are JAX-made and carried over
with ``interop.from_jax``; a test that draws (an encode, a rotation key)
first carries the JAX engine's CSPRNG state and rotation-key store over.

* ``cc_add`` / ``cc_sub`` in the double and triplet forms, ``negate``;
* ``pc_add`` and ``pc_mult`` (the cache filled per level and op, its rows
  the JAX package's), ``mc_add`` / ``mc_mult``, a plaintext at its own
  scale;
* ``add_scalar`` (both FFT norms), ``mult_scalar``, ``mult_int_scalar``,
  ``reduce_error``;
* ``level_up`` and ``align_level``; ``cc_mult`` at two levels and with
  ``pre_rescale=False`` / ``post_relin=False``; ``relinearize``;
  ``square``; ``rescale(exact_rounding=False)``; ``final_round=False`` on
  the decrypt forms;
* ``mean``, ``var``, ``cov`` and ``pow(., 3)``; ``randn`` (the port
  alone: its message comes from numpy's global generator);
* the ``NTTStateError``, ``DifferentTypeError`` and ``MaximumLevelError``
  paths, with the JAX package's messages.

Every output is byte-identical to the JAX package's and decrypts within
its tests' bounds (``tests/test_engine.py:17``, ``:134-175``: 5e-5, 2x
for a triplet sum, 100x for ``pc_add``, 10x two levels down; the 30-bit
toy ``tests/test_mode30.py:21``: 1e-2).
"""

import numpy as np
import pytest
import torch

from tiberate_tpu import errors as jerrors
from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.typing import Plaintext as JPlaintext
from tiberate_tpu_torch import errors as terrors
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.typing import Plaintext

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
    """(JAX engine, port engine) from seed 31, nonce 9, keyed sk, pk, evk;
    built once per case."""
    if case not in _PAIRS:
        j = jeng.CkksEngine(_cfg(case), seed=31, nonce=9)
        t = teng.CkksEngine(_cfg(case), device="cpu", seed=31, nonce=9)
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


def _port(c):
    return interop.from_jax(c, device="cpu")


def _same(jc, tc):
    """Same class name, level and flags, and byte-identical data."""
    return (type(jc).__name__ == type(tc).__name__ and jc.level == tc.level
            and jc._flags.dumps() == tc._flags.dumps()
            and len(jc.data) == len(tc.data)
            and all(np.array_equal(np.asarray(a), b.numpy())
                    for a, b in zip(jc.data, tc.data)))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def made(case):
    """Messages, two JAX-made ciphertexts at level 0, one at level 1, and
    two triplets (``cc_mult(post_relin=False)``)."""
    j, _ = _pair(case)
    rng = np.random.default_rng(5)
    m1, m2 = (rng.uniform(-1, 1, j.num_slots) for _ in range(2))
    ct1, ct2 = j.encodecrypt(m1), j.encodecrypt(m2)
    ct1_l1 = j.encodecrypt(m1, level=1)
    tri1 = j.cc_mult(ct1, ct2, post_relin=False)
    tri2 = j.cc_mult(ct2, ct2, post_relin=False)
    return dict(m1=m1, m2=m2, ct1=ct1, ct2=ct2, ct1_l1=ct1_l1, tri1=tri1,
                tri2=tri2)


def _check(t, jc, tc, want, tol):
    assert _same(jc, tc)
    out = t.decryptcode(tc, is_real=True)
    assert np.abs(out - want).max() < tol


def test_add_sub_negate_match_jax(case, made):
    """cc_add / cc_sub (double, triplet, and through the dispatching
    forms) and negate; cc_add of two levels aligns like the JAX
    package."""
    j, t = _pair(case)
    tol = CASES[case][1]
    m1, m2 = made["m1"], made["m2"]
    ct1, ct2, tri1, tri2 = (made[k] for k in ("ct1", "ct2", "tri1", "tri2"))
    c1, c2, t1, t2 = map(_port, (ct1, ct2, tri1, tri2))
    for name, want in (("cc_add", m1 + m2), ("cc_sub", m1 - m2)):
        for form in (name, name + "_double"):
            _check(t, getattr(j, form)(ct1, ct2), getattr(t, form)(c1, c2),
                   want, tol)
    for name, want in (("cc_add", m1 * m2 + m2 * m2),
                       ("cc_sub", m1 * m2 - m2 * m2)):
        for form in (name, name + "_triplet"):
            _check(t, getattr(j, form)(tri1, tri2),
                   getattr(t, form)(t1, t2), want, 2 * tol)
    _check(t, j.negate(ct1), t.negate(c1), -m1, tol)
    c1_l1 = _port(made["ct1_l1"])
    _check(t, j.cc_add(made["ct1_l1"], ct2), t.cc_add(c1_l1, c2), m1 + m2,
           10 * tol)


def test_plaintext_ops_match_jax(case, made):
    """pc_add, pc_mult (with and without the rescale), mc_add, mc_mult and
    a plaintext at its own scale: the JAX package's bytes; the cache holds
    one row per (level, op), equal to the JAX package's rows, and a second
    call draws nothing."""
    j, t = _synced(case)
    tol = CASES[case][1]
    m1, m2 = made["m1"], made["m2"]
    ct1, c1 = made["ct1"], _port(made["ct1"])
    jpt, tpt = JPlaintext(m2), Plaintext(m2)
    _check(t, j.pc_add(jpt, ct1), t.pc_add(tpt, c1), m1 + m2, 100 * tol)
    _check(t, j.pc_mult(jpt, ct1), t.pc_mult(tpt, c1), m1 * m2, tol)
    assert sorted(tpt.cache[0]) == ["pc_add", "pc_mult"]
    for op in ("pc_add", "pc_mult"):
        assert np.array_equal(np.asarray(jpt.cache[0][op]),
                              tpt.cache[0][op].numpy())
    states = t.rng.states.clone()
    _check(t, j.pc_mult(jpt, ct1), t.pc_mult(tpt, c1), m1 * m2, tol)
    assert torch.equal(states, t.rng.states)
    carried = _port(jpt)
    assert carried.scale is None and carried.padding is True
    assert torch.equal(carried.cache[0]["pc_mult"], tpt.cache[0]["pc_mult"])
    jraw, traw = j.pc_mult(jpt, ct1, post_rescale=False), t.pc_mult(tpt, c1,
                                                                  False)
    assert _same(jraw, traw) and traw.level == 0
    c1_l1 = _port(made["ct1_l1"])
    _check(t, j.pc_mult(jpt, made["ct1_l1"]), t.pc_mult(tpt, c1_l1),
           m1 * m2, tol)
    assert sorted(tpt.cache) == [0, 1]
    _check(t, j.mc_add(m2, ct1), t.mc_add(m2, c1), m1 + m2, 100 * tol)
    _check(t, j.mc_mult(m2, ct1), t.mc_mult(m2, c1), m1 * m2, tol)
    half = float(t.ckksCfg.scale) / 2
    assert _same(j.pc_mult(JPlaintext(m2, scale=half), ct1),
                 t.pc_mult(Plaintext(m2, scale=half), c1))
    assert np.array_equal(np.asarray(j.rng.states), t.rng.states.numpy())


def test_scalar_ops_match_jax(case, made):
    """add_scalar, mult_scalar, mult_int_scalar and reduce_error."""
    j, t = _pair(case)
    tol = CASES[case][1]
    m1, ct1, c1 = made["m1"], made["ct1"], _port(made["ct1"])
    _check(t, j.add_scalar(ct1, 0.25), t.add_scalar(c1, 0.25), m1 + 0.25,
           tol)
    _check(t, j.mult_scalar(ct1, -1.5), t.mult_scalar(c1, -1.5), m1 * -1.5,
           tol)
    _check(t, j.mult_int_scalar(ct1, 3), t.mult_int_scalar(c1, 3), m1 * 3,
           tol)
    _check(t, j.reduce_error(ct1), t.reduce_error(c1), m1, tol)


def test_add_scalar_backward_norm_matches_jax():
    """``norm="backward"`` scales add_scalar's constant by N as the JAX
    package does."""
    cfg = _cfg("toy")
    j = jeng.CkksEngine(cfg, norm="backward", seed=1)
    t = teng.CkksEngine(cfg, device="cpu", norm="backward", seed=1)
    rng = np.random.default_rng(3)
    C = t._lp(0).num_channels
    data = [np.stack([rng.integers(0, q, t.ckksCfg.N) for q in
                      t.params.q[:C]]) for _ in range(2)]
    from tiberate_tpu.typing import Ciphertext as JCiphertext

    jct = JCiphertext(data=tuple(data), level=0)
    assert _same(j.add_scalar(jct, 0.5), t.add_scalar(_port(jct), 0.5))


def test_level_management_and_unfused_mult_match_jax(case, made):
    """level_up, align_level, rescale without exact rounding, cc_mult at
    two levels (aligned first), cc_mult without the rescale and without
    relinearization, relinearize, square, and the decrypt forms with
    ``final_round=False``."""
    j, t = _pair(case)
    tol = CASES[case][1]
    m1, m2 = made["m1"], made["m2"]
    ct1, ct2, tri1 = made["ct1"], made["ct2"], made["tri1"]
    c1, c2, t1 = map(_port, (ct1, ct2, tri1))
    for dst in (1, 2):
        _check(t, j.level_up(ct2, dst), t.level_up(c2, dst), m2, tol)
    c1_l1 = _port(made["ct1_l1"])
    for ja, ta in zip(j.align_level(ct2, made["ct1_l1"]),
                      t.align_level(c2, c1_l1)):
        assert _same(ja, ta) and ta.level == 1
    assert _same(j.rescale(ct1, exact_rounding=False),
                 t.rescale(c1, exact_rounding=False))

    z = t.cc_mult(c1, c2)
    jz = j.cc_mult(ct1, ct2)
    _check(t, jz, z, m1 * m2, tol)
    _check(t, j.cc_mult(jz, ct2), t.cc_mult(z, c2), m1 * m2 * m2, 10 * tol)
    _check(t, j.cc_mult(ct2, jz), t.cc_mult(c2, z), m1 * m2 * m2, 10 * tol)
    jtri, ttri = (e.cc_mult(a, b, post_relin=False)
                  for e, a, b in ((j, ct1, ct2), (t, c1, c2)))
    assert type(ttri).__name__ == "CiphertextTriplet"
    _check(t, jtri, ttri, m1 * m2, tol)
    _check(t, j.relinearize(tri1), t.relinearize(t1), m1 * m2, tol)
    # pre_rescale=False takes operands the caller rescaled
    jnr = j.cc_mult(j.rescale(ct1), j.rescale(ct2), pre_rescale=False)
    tnr = t.cc_mult(t.rescale(c1), t.rescale(c2), pre_rescale=False)
    _check(t, jnr, tnr, m1 * m2, tol)
    jraw = j.cc_mult(ct1, ct2, pre_rescale=False, post_relin=False)
    traw = t.cc_mult(c1, c2, pre_rescale=False, post_relin=False)
    assert _same(jraw, traw) and traw.level == 0
    _check(t, j.cc_mult(ct1, ct2, j.evk), t.cc_mult(c1, c2, t.evk),
           m1 * m2, tol)
    _check(t, j.square(ct1), t.square(c1), m1 * m1, tol)
    _check(t, j.square(ct1, post_relin=False),
           t.square(c1, post_relin=False), m1 * m1, tol)
    for jx, tx in ((ct1, c1), (tri1, t1)):
        for form in ("decrypt", "decrypt_double" if jx is ct1
                     else "decrypt_triplet"):
            jd = getattr(j, form)(jx, final_round=False)
            td = getattr(t, form)(tx, final_round=False)
            assert np.array_equal(np.asarray(jd).reshape(-1),
                                  td.numpy().reshape(-1))
        assert np.array_equal(j.decryptcode(jx, final_round=False),
                              t.decryptcode(tx, final_round=False))


def test_statistics_match_jax(case, made):
    """mean, var, cov and pow(., 3): the JAX package's bytes (their
    rotation keys and encodes drawn in the same order), within the
    bounds."""
    j, t = _synced(case)
    tol = CASES[case][1]
    m1, m2 = made["m1"], made["m2"]
    ct1, ct2 = made["ct1"], made["ct2"]
    c1, c2 = _port(ct1), _port(ct2)
    _check(t, j.mean(ct1), t.mean(c1), m1.mean(), tol)
    _check(t, j.var(ct1), t.var(c1), m1.var(), tol)
    # per slot, as the JAX package computes it (no sum over the slots)
    cov = (m1 - m1.mean()) * (m2 - m2.mean()) / (len(m1) - 1)
    _check(t, j.cov(ct1, ct2), t.cov(c1, c2), cov, tol)
    _check(t, j.pow(ct1, 3), t.pow(c1, 3), m1**3, 10 * tol)
    assert np.array_equal(np.asarray(j.rng.states), t.rng.states.numpy())
    # randn: numpy's global generator draws the message
    np.random.seed(4)
    rct, src = t.randn(return_src=True)
    assert src.shape == (t.num_slots,) and np.iscomplexobj(src)
    assert np.abs(t.decryptcode(rct) - src).max() < tol


def test_error_paths_match_jax(case, made):
    """The state, type and level checks raise the JAX package's exception,
    with its message, in its order."""
    j, t = _pair(case)
    ct1, tri1 = made["ct1"], made["tri1"]
    c1, t1 = _port(ct1), _port(tri1)
    last = j.num_levels - 1
    jlast = j.encodecrypt(made["m1"], level=last)
    tlast = _port(jlast)
    calls = [
        (jerrors.NTTStateError, lambda e, c, x: e.cc_add_double(x, x)),
        (jerrors.NTTStateError, lambda e, c, x: e.cc_sub_double(c, x)),
        (jerrors.NTTStateError, lambda e, c, x: e.cc_add_triplet(c, c)),
        (jerrors.NTTStateError, lambda e, c, x: e.relinearize(c)),
        (jerrors.DifferentTypeError, lambda e, c, x: e.cc_add(c, x)),
        (jerrors.DifferentTypeError, lambda e, c, x: e.cc_sub(x, c)),
        (jerrors.DifferentTypeError, lambda e, c, x: e.cc_add(c, 1.0)),
    ]
    last_calls = [
        lambda e, c: e.rescale(c),
        lambda e, c: e.cc_mult(c, c),
        lambda e, c: e.mult_scalar(c, 2.0),
    ]
    for exc, call in calls:
        with pytest.raises(exc) as jexc:
            call(j, ct1, tri1)
        with pytest.raises(getattr(terrors, exc.__name__)) as texc:
            call(t, c1, t1)
        # DifferentTypeError names the operands' classes, module and all
        assert str(texc.value).replace("tiberate_tpu_torch.",
                                       "tiberate_tpu.") == str(jexc.value)
    for call in last_calls:
        with pytest.raises(jerrors.MaximumLevelError) as jexc:
            call(j, jlast)
        with pytest.raises(terrors.MaximumLevelError) as texc:
            call(t, tlast)
        assert str(texc.value) == str(jexc.value)
