"""tiberate_tpu_torch engine cores and round trips (CPU tensors).

* keygen and encrypt/decrypt cores against the JAX cores on the same
  numpy-drawn ternary / a / e / v — byte-identical outputs;
* a port-only encodecrypt -> cc_mult -> decryptcode round trip, decrypt
  error below the bound tests/test_engine.py uses at this toy size;
* the same round trip, a rotation and a ``pc_mult``, in the 62-bit and the
  30-bit mode, in a subprocess where jax cannot be imported;
* engines of both packages from the same (seed, nonce): byte-identical sk,
  pk and evk, batch and single encrypts, seed-expanded keys and their
  compressed forms; the pinned logN14 ciphertext digest of
  tests/test_golden.py; the decrypt forms on JAX-made ciphertexts.
"""

import hashlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.context.ntt_context import CkksParams as JParams
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams
from tiberate_tpu_torch.engine import ckks_engine as teng

torch.set_num_threads(1)

TOL = 5e-5  # toy 30-bit scale primes (the bound of tests/test_engine.py)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return toy_config(logN=7, num_scales=4, num_special_primes=2,
                      scale_bits=30)


@pytest.fixture(scope="module")
def params():
    cfg = _cfg()
    return JParams(cfg), TParams(cfg, "cpu")


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


def _uniform(rng, q_list, N):
    return np.stack([rng.integers(0, q, N, dtype=np.int64) for q in q_list])


def test_keygen_and_encrypt_cores_match_jnp(params):
    """sk, pk, a ksk shard, encrypt and decrypt from the same draws."""
    jp, tp = params
    rng = np.random.default_rng(11)
    N, P = jp.N, jp.P
    t = torch.from_numpy

    ternary = rng.integers(-1, 2, N, dtype=np.int64)
    j_sk = jeng._keygen_sk_core(jnp.asarray(ternary), jp.lp(0, True))
    t_sk = teng._keygen_sk_core(t(ternary), tp.lp(0, True))
    assert _eq(j_sk, t_sk)

    e = rng.integers(-8, 9, N, dtype=np.int64)
    a = _uniform(rng, jp.q[:P], N)
    j_pk0 = jeng._keygen_pk_core(jnp.asarray(e), jnp.asarray(a), j_sk[:P],
                                 jp.lp(0, False))
    t_pk0 = teng._keygen_pk_core(t(e), t(a), t_sk[:P], tp.lp(0, False))
    assert _eq(j_pk0, t_pk0)

    part = jp.parts[0][0]
    pk0_sp = _uniform(rng, jp.q, N)
    Psk = _uniform(rng, jp.q[: part.alpha], N)
    j_sh = jeng._ksk_shard_core(
        jnp.asarray(pk0_sp), jnp.asarray(Psk), part.g0, part.alpha,
        jp.pack[part.g0 : part.g0 + part.alpha])
    t_sh = teng._ksk_shard_core(
        t(pk0_sp), t(Psk), part.g0, part.alpha,
        tp.pack[part.g0 : part.g0 + part.alpha])
    assert _eq(j_sh, t_sh)

    pt = rng.integers(-(1 << 35), 1 << 35, N, dtype=np.int64)
    dc = np.array([rng.integers(0, q) for q in jp.q[:P]], dtype=np.int64)
    e0, e1 = (rng.integers(-8, 9, N, dtype=np.int64) for _ in range(2))
    v = rng.integers(0, 2, N, dtype=np.int64)
    j_ct = jeng._encrypt_core(*map(jnp.asarray, (pt, dc, e0, e1, v)),
                              j_pk0, jnp.asarray(a), jp.lp(0, False))
    t_ct = teng._encrypt_core(*map(t, (pt, dc, e0, e1, v)), t_pk0, t(a),
                              tp.lp(0, False))
    for j, c in zip(j_ct, t_ct):
        assert _eq(j, c)

    rh = jp.q[-jp.S - 2] // 2
    j_dec = jeng._decrypt_double_core(
        *j_ct, j_sk[:P], jp.lp(0, False), jp.base_lp(), jp.final_scalar[0],
        rh, base_at=P - 1, final_round=True)
    t_dec = teng._decrypt_double_core(
        *t_ct, t_sk[:P], tp.lp(0, False), tp.base_lp(), tp.final_scalar[0],
        rh, P - 1, True)
    assert _eq(j_dec[1], t_dec[1])
    assert _eq(np.asarray(j_dec[0]).reshape(-1), t_dec[0].reshape(-1))


@pytest.fixture(scope="module")
def port_engine():
    return teng.CkksEngine(_cfg(), device="cpu", seed=7)


def _msgs(eng, n):
    rng = np.random.default_rng(5)
    return [rng.uniform(-1, 1, eng.num_slots) for _ in range(n)]


def test_port_roundtrip_encrypt_mult_decrypt(port_engine):
    eng = port_engine
    m1, m2 = _msgs(eng, 2)
    x, y = eng.encodecrypt(m1), eng.encodecrypt(m2)
    assert np.abs(eng.decryptcode(x, is_real=True) - m1).max() < TOL
    z = eng.cc_mult(x, y)
    assert z.level == 1
    assert np.abs(eng.decryptcode(z, is_real=True) - m1 * m2).max() < TOL
    zz = eng.cc_mult(z, z)
    assert np.abs(eng.decryptcode(zz, is_real=True)
                  - (m1 * m2) ** 2).max() < TOL


def test_port_roundtrip_without_bias_guard():
    """bias_guard=False: the DC slot is rounded with the rest, not carried
    as exact RNS residues; the same error bound holds."""
    eng = teng.CkksEngine(_cfg(), device="cpu", bias_guard=False, seed=8)
    m1, m2 = _msgs(eng, 2)
    z = eng.cc_mult(eng.encodecrypt(m1), eng.encodecrypt(m2))
    assert np.abs(eng.decryptcode(z, is_real=True) - m1 * m2).max() < TOL


def test_port_batched_step_equals_single(port_engine):
    """A leading batch dimension through cc_mult gives, per entry, the
    bytes of the single-ciphertext step."""
    eng = port_engine
    ms = _msgs(eng, 4)
    cts = [eng.encodecrypt(m) for m in ms]
    A = teng.stack_ciphertexts(cts[:2])
    B = teng.stack_ciphertexts(cts[2:])
    out = teng.unstack_ciphertext(eng.cc_mult(A, B))
    for i in range(2):
        single = eng.cc_mult(cts[i], cts[2 + i])
        for d_b, d_s in zip(out[i].data, single.data):
            assert torch.equal(d_b, d_s)
        err = np.abs(eng.decryptcode(out[i], is_real=True)
                     - ms[i] * ms[2 + i]).max()
        assert err < TOL


@pytest.fixture(scope="module")
def jax_engine():
    return jeng.CkksEngine(_cfg(), seed=7)


@pytest.mark.parametrize("entry", ["decrypt_double", "decryptcode"])
@pytest.mark.parametrize("flag", ["NTT_STATE", "MONTGOMERY_STATE"])
def test_decrypt_refuses_ntt_and_montgomery_state(jax_engine, port_engine,
                                                  flag, entry):
    """A ciphertext flagged as in the NTT or the Montgomery state, built
    from the same numpy residues in both packages, is refused by both
    decrypt entries with the exception of the same name and message
    (``expected=False``)."""
    from tiberate_tpu import errors as jerrors
    from tiberate_tpu import typing as jtyping
    from tiberate_tpu_torch import errors as terrors
    from tiberate_tpu_torch import typing as ttyping

    rng = np.random.default_rng(13)
    C = port_engine._lp(0, False).num_channels
    data = [_uniform(rng, port_engine.params.q[:C], port_engine.ckksCfg.N)
            for _ in range(2)]
    jct = jtyping.Ciphertext(data=tuple(jnp.asarray(d) for d in data),
                             flags=getattr(jtyping.FLAGS, flag), level=0)
    tct = ttyping.Ciphertext(data=tuple(torch.from_numpy(d) for d in data),
                             flags=getattr(ttyping.FLAGS, flag), level=0)
    name = {"NTT_STATE": "NTTStateError",
            "MONTGOMERY_STATE": "MontgomeryStateError"}[flag]
    with pytest.raises(getattr(jerrors, name)) as jexc:
        getattr(jax_engine, entry)(jct)
    with pytest.raises(getattr(terrors, name)) as texc:
        getattr(port_engine, entry)(tct)
    assert str(jexc.value).endswith(f"requires {flag}=False.")
    assert str(texc.value) == str(jexc.value)


def test_cuda_engine_needs_a_card():
    """No silent CPU default: device='cuda' (the default) raises when no
    GPU is present."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        teng.CkksEngine(_cfg())


def test_interop_needs_a_card_by_default(jax_engine):
    """No silent CPU default in the carry-over either: ``from_jax`` and
    ``csprng_from_jax`` put their tensors on the card unless asked for the
    CPU, so without a GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for carry, obj in ((interop.from_jax, jax_engine.sk),
                       (interop.csprng_from_jax, jax_engine.rng)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            carry(obj)
        assert carry(obj, device="cpu") is not None


_NO_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine
from tiberate_tpu_torch.typing import Plaintext
from tiberate_tpu_torch.rng import (chacha20, csprng,
                                    discrete_gaussian_sampler, interface,
                                    simplerng)

assert issubclass(csprng.Csprng, interface.RandNumGen)
assert issubclass(simplerng.SimpleRNG, interface.RandNumGen)
rng = csprng.Csprng(num_coefs=64, num_channels=[2], seed=1, device="cpu")
assert rng.randint(amax=[5, 7], repeats=1).shape == (2, 64)

rng = np.random.default_rng(1)
for bits, scale_bits, tol in ((62, 30, {tol}), (30, 21, {tol30})):
    eng = CkksEngine(toy_config(logN=7, num_scales=4, num_special_primes=2,
                                scale_bits=scale_bits,
                                buffer_bit_length=bits), device="cpu", seed=3)
    m1, m2 = (rng.uniform(-1, 1, eng.num_slots) for _ in range(2))
    ct = eng.cc_mult(eng.encodecrypt(m1), eng.encodecrypt(m2))
    assert ct.data[0].dtype == eng.params.dtype
    out = eng.decryptcode(ct, is_real=True)
    assert np.abs(out - m1 * m2).max() < tol, bits
    ct1 = eng.encodecrypt(m1)
    rot = eng.decryptcode(eng.rotate_offset(ct1, 1), is_real=True)
    assert np.abs(rot - np.roll(m1, 1)).max() < tol, bits
    pc = eng.decryptcode(eng.pc_mult(Plaintext(m2), ct1), is_real=True)
    assert np.abs(pc - m1 * m2).max() < tol, bits

# the typed front door and the extensions, with jax blocked too
import tempfile
from tiberate_tpu_torch import extension
from tiberate_tpu_torch.extension.benchmarks import benchreg
from tiberate_tpu_torch.typing import DataStruct
from tiberate_tpu_torch.utils import trace
assert "batched_inference" in benchreg and extension.PackedCT
ct2 = eng.encodecrypt(m2)
out = ct1 * ct2 + ct1                  # the sugar, through the registry
assert np.abs(out.plain - (m1 * m2 + m1)).max() < {tol30}
with tempfile.TemporaryDirectory() as d:
    out.save(d + "/ct")
    back = DataStruct.load(d + "/ct", device="cpu")
    with trace.profile(d):
        with trace.annotate("no_jax"):
            (back >> 1).plain
assert type(back).__name__ == "Ciphertext" and back.level == out.level
assert back.data[0].dtype == eng.params.dtype
assert np.abs(back.plain - out.plain).max() == 0
assert "tiberate_tpu" not in sys.modules
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(tol=TOL, tol30=1e-2)],
        cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# ----------------------------------------------------------------------
# Both packages from the same (seed, nonce).
# ----------------------------------------------------------------------

REPO_GOLDEN = os.path.join(REPO, "tests", "golden", "presets.json")

KEY_CASES = {
    "toy": _cfg,
    "toy30": lambda: toy_config(logN=7, num_scales=4, num_special_primes=2,
                                scale_bits=21, buffer_bit_length=30),
    "logN14": lambda: "logN14",
}
_PAIRS = {}


def _keyed_pair(case):
    """(JAX engine, port engine) of ``case`` from seed 21, nonce 5, with
    sk, pk and evk drawn in that order; built once per case.  Tests that
    draw more carry the JAX stream over first (``csprng_from_jax``)."""
    if case not in _PAIRS:
        cfg = KEY_CASES[case]()
        j = jeng.CkksEngine(cfg, seed=21, nonce=5)
        t = teng.CkksEngine(cfg, device="cpu", seed=21, nonce=5)
        for eng in (j, t):
            eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
        _PAIRS[case] = (j, t)
    return _PAIRS[case]


def _same(j_leaves, t_leaves):
    return all(_eq(a, b) for a, b in zip(j_leaves, t_leaves))


def _ksk_leaves(ksk):
    return [leaf for part in ksk.data
            for leaf in (part if isinstance(part, tuple) else (part,))]


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_keys_match_jax(case):
    """sk, pk and evk of both packages from the same (seed, nonce) are
    byte-identical (the 30-bit toy's in int32)."""
    j, t = _keyed_pair(case)
    assert t.sk.data.dtype == t.params.dtype
    assert _eq(j.sk.data, t.sk.data)
    assert _same(j.pk.data, t.pk.data)
    assert len(t.evk.data) == len(j.evk.data)
    assert _same(_ksk_leaves(j.evk), _ksk_leaves(t.evk))
    assert t.pk._flags == interop.from_jax(j.pk, device="cpu")._flags


def test_port_logN14_ciphertext_digest_pinned():
    """The port's counterpart of tests/test_golden.py's pinned digest: its
    own keygen, CSPRNG, codec and encrypt at Preset.logN14 give the JAX
    package's ciphertext bytes; the ciphertext decrypts below 1e-6."""
    with open(REPO_GOLDEN) as f:
        golden = json.load(f)["logN14"]["ct_sha256_seed1234_nonce1"]
    eng = teng.CkksEngine("logN14", device="cpu", seed=1234, nonce=1)
    m = np.linspace(-1, 1, eng.num_slots)
    ct = eng.encodecrypt(m)
    h = hashlib.sha256()
    for d in ct.data:
        h.update(np.ascontiguousarray(d.numpy()).tobytes())
    assert h.hexdigest() == golden
    assert np.abs(eng.decryptcode(ct, is_real=True) - m).max() < 1e-6


@pytest.mark.parametrize("bias_guard", [True, False])
def test_encodecrypt_batch_matches_jax_and_sequential(bias_guard):
    """Three messages (one with a DC of 3, which the bias guard splits)
    through the port's ``encodecrypt_batch``: the bytes of three
    sequential ``encodecrypt`` calls of a port engine in the same state;
    with the bias guard on (the engine's default), also the bytes of the
    JAX package's ``encodecrypt_batch``."""
    if bias_guard:
        j, t = _keyed_pair("toy")
        t.rng = interop.csprng_from_jax(j.rng, device="cpu")
    else:
        t = teng.CkksEngine(_cfg(), device="cpu", seed=21, nonce=5,
                            bias_guard=False)
        t.sk, t.pk, t.evk  # noqa: B018 — keygen
    rng = np.random.default_rng(17)
    ms = [rng.uniform(-1, 1, t.num_slots) for _ in range(3)]
    ms[1] = ms[1] + 3.0
    twin = teng.CkksEngine(_cfg(), device="cpu", seed=21, nonce=5,
                           bias_guard=bias_guard)
    twin.sk, twin.pk, twin.evk  # noqa: B018 — t's keys
    twin.rng.states = t.rng.states.clone()
    tb = t.encodecrypt_batch(ms)
    seq = [twin.encodecrypt(m) for m in ms]
    assert len(tb) == 3
    for tc, sc in zip(tb, seq):
        assert tc.level == 0 and tc._flags == sc._flags
        for a, b in zip(tc.data, sc.data):
            assert torch.equal(a, b)
    if bias_guard:
        for jc, tc in zip(j.encodecrypt_batch(ms), tb):
            assert _same(jc.data, tc.data)
    assert torch.equal(t.rng.states, twin.rng.states)
    out = t.decryptcode_batch(tb, is_real=True)
    assert np.abs(out - np.stack(ms)).max() < TOL


def test_encrypt_matches_jax():
    """``encrypt`` of the same encoded coefficients, twice in a row, from
    the same CSPRNG state: the JAX package's bytes (the port draws its
    noise by ``encrypt_noise_batch(1)``, the JAX package by
    ``discrete_gaussian`` then ``randint``), and the same states after."""
    j, t = _keyed_pair("toy")
    t.rng = interop.csprng_from_jax(j.rng, device="cpu")
    pt = np.random.default_rng(31).integers(-2**40, 2**40, t.ckksCfg.N)
    for _ in range(2):
        jc, tc = j.encrypt(pt), t.encrypt(pt)
        assert tc._flags == interop.from_jax(jc, device="cpu")._flags
        assert _same(jc.data, tc.data)
    assert _eq(j.rng.states, t.rng.states)


@pytest.fixture(scope="module")
def jax_made():
    """JAX-made ciphertexts at the toy: three fresh ones (one with a DC of
    3) and the triplet of a cc_mult without relinearization."""
    j, _ = _keyed_pair("toy")
    rng = np.random.default_rng(23)
    ms = [rng.uniform(-1, 1, j.num_slots) for _ in range(3)]
    ms[2] = ms[2] + 3.0
    cts = [j.encodecrypt(m) for m in ms]
    triplet = j.cc_mult(cts[0], cts[1], post_relin=False)
    return ms, cts, triplet


def test_decrypt_forms_match_jax(jax_made):
    """``decryptcode_batch``, ``decrypt_triplet``, ``decrypt`` (both kinds)
    and ``decryptcode`` of a triplet, on JAX-made ciphertexts carried over
    by ``from_jax``: the scaled coefficients byte-identical to the JAX
    package's, the batch decode equal to the JAX batch decode and within
    the JAX package's 1e-9 of the sequential decode (float summation
    order), and every message within the toy bound."""
    j, t = _keyed_pair("toy")
    ms, jcts, jtrip = jax_made
    tcts = [interop.from_jax(c, device="cpu") for c in jcts]
    ttrip = interop.from_jax(jtrip, device="cpu")
    assert type(ttrip).__name__ == "CiphertextTriplet"

    jbat = j.decryptcode_batch(jcts, is_real=True)
    tbat = t.decryptcode_batch(tcts, is_real=True)
    assert np.array_equal(jbat, tbat)
    seq = np.stack([t.decryptcode(c, is_real=True) for c in tcts])
    np.testing.assert_allclose(tbat, seq, rtol=0, atol=1e-9)
    assert np.abs(tbat - np.stack(ms)).max() < TOL

    assert _eq(np.asarray(j.decrypt_triplet(jtrip)).reshape(-1),
               t.decrypt_triplet(ttrip).reshape(-1))
    assert torch.equal(t.decrypt(ttrip), t.decrypt_triplet(ttrip))
    assert _eq(np.asarray(j.decrypt(jcts[0])).reshape(-1),
               t.decrypt(tcts[0]).reshape(-1))
    jdec = j.decryptcode(jtrip, is_real=True)
    tdec = t.decryptcode(ttrip, is_real=True)
    assert np.array_equal(jdec, tdec)
    assert np.abs(tdec - ms[0] * ms[1]).max() < TOL


def test_intt_exit_to_mont_matches_jax():
    """The iNTT that keeps the Montgomery factor, on the same residues."""
    jp, tp = JParams(_cfg()), TParams(_cfg(), "cpu")
    x = _uniform(np.random.default_rng(29), jp.q[: jp.P], jp.N)
    want = jeng._intt_exit_to_mont(jnp.asarray(x), jp.lp(0, False))
    assert _eq(want, teng._intt_exit_to_mont(torch.from_numpy(x),
                                             tp.lp(0, False)))


def test_seed_expanded_keys_compress_and_expand(jax_made):
    """``a_seed`` keys in both packages: a key-switching key and a public
    key (with and without the special primes) byte-identical across the
    packages; compressing drops the a halves; expanding gives back the
    bytes in both packages, and across them through ``from_jax``."""
    j, t = _keyed_pair("toy")
    # the streams may have parted
    t.rng = interop.csprng_from_jax(j.rng, device="cpu")
    jsk2, tsk2 = j._create_secret_key(), t._create_secret_key()
    assert _eq(jsk2.data, tsk2.data)
    jk = j.create_key_switching_key(jsk2, j.sk, a_seed=12345)
    tk = t.create_key_switching_key(tsk2, t.sk, a_seed=12345)
    assert tk.misc["a_seed"] == 12345
    assert _same(_ksk_leaves(jk), _ksk_leaves(tk))
    t.switch_key(teng.stack_ciphertexts(
        [interop.from_jax(c, device="cpu") for c in jax_made[1][:2]]), tk)
    ck = t.compress_ksk(tk)
    assert ck.misc["compressed"] and len(_ksk_leaves(ck)) == len(tk.data)
    assert not any(k.startswith("_") for k in ck.misc)
    assert _same(_ksk_leaves(j.expand_ksk(j.compress_ksk(jk))),
                 _ksk_leaves(tk))
    for cksk in (ck, interop.from_jax(j.compress_ksk(jk), device="cpu")):
        back = t.expand_ksk(cksk)
        assert "compressed" not in back.misc
        assert all(torch.equal(a, b) for a, b in
                   zip(_ksk_leaves(back), _ksk_leaves(tk)))
    with pytest.raises(ValueError, match="a_seed"):
        t.compress_ksk(t.evk)
    for special in (False, True):
        jpk = j.create_public_key(include_special=special, a_seed=777)
        tpk = t.create_public_key(include_special=special, a_seed=777)
        assert _same(jpk.data, tpk.data)
        cpk = t.compress_pk(tpk)
        assert len(cpk.data) == 1
        for c in (cpk, interop.from_jax(j.compress_pk(jpk), device="cpu")):
            assert all(torch.equal(a, b) for a, b in
                       zip(t.expand_pk(c).data, tpk.data))


def test_decryptcode_batch_refuses_ntt_and_montgomery_state(port_engine):
    """The batch decrypt checks each ciphertext as ``decryptcode`` does;
    the JAX package's batch form refuses only the NTT state."""
    from tiberate_tpu_torch import errors as terrors
    from tiberate_tpu_torch import typing as ttyping

    ok = port_engine.encodecrypt(np.zeros(port_engine.num_slots))
    for flag, exc in (("NTT_STATE", terrors.NTTStateError),
                      ("MONTGOMERY_STATE", terrors.MontgomeryStateError)):
        bad = ttyping.Ciphertext(data=ok.data, level=0,
                                 flags=getattr(ttyping.FLAGS, flag))
        with pytest.raises(exc, match=f"requires {flag}=False"):
            port_engine.decryptcode_batch([ok, bad])
