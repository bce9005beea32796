"""``HELayerNormFeatureWise`` of tiberate_tpu_torch against the JAX package
and against numpy, on the CPU.

The data is ``tests/test_extensions.py::test_he_layernorm_feature_wise``'s:
F = 4 features as ciphertexts, samples in the slots, a bounded per-slot
variance (1.25 r^2, r in [0.5, 0.9]), ``eps = 1e-2``.

* Against the JAX package: ``iters=1`` (depth 3 + 3 + 2 = 8) on
  ``toy_config(logN=7, num_scales=11)``, the JAX test's margin of 3 over
  its depth, from one configuration object: the same bytes, the output
  within 5e-2 of numpy (one Newton step); the JAX layer carried over with
  ``interop.from_jax`` gives the same bytes on the port engine.
* The port alone at the JAX test's size (logN 8, ``num_scales=14``,
  ``iters=2``): within 5e-3 of numpy (its bound).

LayerNorm draws nothing (scalar ops, adds and products only), so the
engines need no CSPRNG carry beyond their keys.
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.extension import nn as jnn
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.config.toy import toy_config as ttoy_config
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.extension import nn as tnn

torch.set_num_threads(1)

F = 4
EPS = 1e-2


def _data(num_slots):
    """(x [F, slots], gamma, beta, var_range) of the JAX test."""
    rng = np.random.default_rng(0)
    pattern = np.array([-1.5, -0.5, 0.5, 1.5])
    c = rng.uniform(-0.3, 0.3, num_slots)
    r = rng.uniform(0.5, 0.9, num_slots)
    x = c[None, :] + r[None, :] * pattern[:, None]
    gamma = rng.uniform(0.5, 1.5, F)
    beta = rng.uniform(-0.5, 0.5, F)
    return x, gamma, beta, (1.25 * 0.25 + EPS, 1.25 * 0.81 + EPS)


def _expect(x, gamma, beta):
    mu = x.mean(axis=0)
    var = x.var(axis=0)
    return gamma[:, None] * (x - mu) / np.sqrt(var + EPS) + beta[:, None]


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def test_layernorm_matches_jax():
    """One Newton step: the JAX forward's bytes for every feature, and the
    carried JAX layer's on the port engine."""
    cfg = toy_config(logN=7, num_scales=11, num_special_primes=2,
                     scale_bits=30)
    j = jeng.CkksEngine(cfg, seed=7, nonce=2)
    t = teng.CkksEngine(cfg, device="cpu", seed=7, nonce=2)
    x, gamma, beta, var_range = _data(t.num_slots)
    jcts = [j.encodecrypt(x[f]) for f in range(F)]
    j.evk  # noqa: B018
    t.sk = interop.from_jax(j.sk, device="cpu")
    t.evk = interop.from_jax(j.evk, device="cpu")
    tcts = [interop.from_jax(c, device="cpu") for c in jcts]

    jln = jnn.HELayerNormFeatureWise(gamma, beta, j, eps=EPS,
                                     var_range=var_range, iters=1)
    tln = tnn.HELayerNormFeatureWise(gamma, beta, t, eps=EPS,
                                     var_range=var_range, iters=1)
    assert (tln._y0_a, tln._y0_b) == (jln._y0_a, jln._y0_b)
    jout, tout = jln(jcts), tln(tcts)
    assert len(tout) == F
    for a, b in zip(jout, tout):
        assert b.level == a.level
        assert all(_eq(u, v) for u, v in zip(a.data, b.data))
    got = np.stack([t.decryptcode(o, is_real=True) for o in tout])
    assert np.abs(got - _expect(x, gamma, beta)).max() < 5e-2

    carried = interop.from_jax(jln, engine=t)
    assert isinstance(carried, tnn.HELayerNormFeatureWise)
    assert (carried.eps, carried.iters, carried.var_range) == \
        (jln.eps, jln.iters, jln.var_range)
    for a, b in zip(jout, carried(tcts)):
        assert all(_eq(u, v) for u, v in zip(a.data, b.data))


def test_layernorm_against_numpy():
    """Two Newton steps at the JAX test's size: within 5e-3 of numpy."""
    eng = teng.CkksEngine(
        ttoy_config(logN=8, num_scales=14, num_special_primes=2,
                    scale_bits=30),
        device="cpu", seed=7,
    )
    x, gamma, beta, var_range = _data(eng.num_slots)
    ln = tnn.HELayerNormFeatureWise(gamma, beta, eng, eps=EPS,
                                    var_range=var_range, iters=2)
    out = ln([eng.encodecrypt(x[f]) for f in range(F)])
    got = np.stack([eng.decryptcode(o, is_real=True) for o in out])
    assert np.abs(got - _expect(x, gamma, beta)).max() < 5e-3
    with pytest.raises(ValueError, match="positive interval"):
        tnn.HELayerNormFeatureWise(gamma, beta, eng, var_range=(1.0, 0.5))
