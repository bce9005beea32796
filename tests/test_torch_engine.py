"""tiberate_tpu_torch engine cores and round trips (CPU tensors).

* keygen and encrypt/decrypt cores against the JAX cores on the same
  numpy-drawn ternary / a / e / v — byte-identical outputs;
* a port-only encodecrypt -> cc_mult -> decryptcode round trip, decrypt
  error below the bound tests/test_engine.py uses at this toy size;
* the same round trip, in the 62-bit and the 30-bit mode, in a subprocess
  where jax cannot be imported;
* the stand-in sampler's draws have the supports and moments asked of them.
"""

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


def test_sampler_draws():
    """Supports of every draw, and the discrete Gaussian's spread: over
    2^17 draws the sample std lies within 2% of sigma = 3.2 (its standard
    error there is about 0.2%) and no draw exceeds the table's 32 points.
    Stochastic rounding is unbiased to within 1% of a unit."""
    from tiberate_tpu_torch.rng.sampler import Sampler

    N = 1 << 14
    smp = Sampler(N, 3.2, seed=4)
    assert set(smp.ternary().tolist()) == {-1, 0, 1}
    assert set(smp.binary().tolist()) == {0, 1}
    q = [97, 1 << 40, (1 << 61) - 1]
    u = smp.uniform(q)
    assert u.shape == (3, N)
    for row, qi in zip(u, q):
        assert 0 <= int(row.min()) and int(row.max()) < qi
    g = smp.discrete_gaussian(8).double()
    assert g.shape == (8, N)
    assert abs(float(g.std()) / 3.2 - 1) < 0.02
    assert float(g.abs().max()) <= 32
    x = np.full(N, 2.25)
    r = smp.randround(-x)
    assert set(r.tolist()) == {-2, -3}
    assert abs(float(r.double().mean()) + 2.25) < 0.01


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


_NO_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine

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
