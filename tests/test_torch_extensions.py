"""The packing extension, the HE linear layer and the batched-inference
benchmark of tiberate_tpu_torch against the JAX package on the CPU.

The pair of engines comes from one configuration object (the JAX
package's ``toy_config(logN=7, num_scales=3, num_special_primes=2)``, the
one ``tests/test_extensions.py`` runs) and the same (seed, nonce); a test
that draws (an encrypt, a plaintext encode, a rotation key) first carries
the JAX engine's CSPRNG state and rotation-key store over, so both
packages draw the same values in the same order.

* ``FeatureWisePacking.pack`` / ``unpack``: the JAX package's arrays,
  exactly, and the identity round trip;
* ``FeatureWiseCTEncoding.encodecrypt``: the JAX package's ciphertexts,
  byte for byte, and the round trip within ``TOL``;
* ``PackedCT``'s operators (through the ciphertext sugar): the JAX
  package's bytes;
* ``HELinearFeatureWise`` with and without bias: the JAX forward's bytes,
  and ``x @ W.T + b`` within 200 x ``TOL``; the JAX layer carried over
  with ``interop.from_jax`` (its cached plaintext rows and all) gives the
  same bytes on the port engine without drawing;
* ``interop.from_jax`` of a ``PackedCT``;
* ``batched_inference`` at the toy (the port alone): ``max_err`` < 1e-4.

Tolerances are ``tests/test_extensions.py``'s (``TOL`` = 5e-4, 200 x for
the linear layer, 1e-4 for ``batched_inference``).
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.extension import nn as jnn
from tiberate_tpu.extension import packing as jpacking
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.extension import nn as tnn
from tiberate_tpu_torch.extension import packing as tpacking

torch.set_num_threads(1)

TOL = 5e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, port engine) of one configuration object, seed 99,
    nonce 1."""
    cfg = toy_config(logN=7, num_scales=3, num_special_primes=2,
                     scale_bits=30)
    j = jeng.CkksEngine(cfg, seed=99, nonce=1)
    t = teng.CkksEngine(cfg, device="cpu", seed=99, nonce=1)
    for eng in (j, t):
        eng.sk, eng.pk, eng.evk  # noqa: B018 — keygen
    return j, t


def _synced(pair):
    j, t = pair
    t.rng = interop.csprng_from_jax(j.rng, device="cpu")
    t.rotk = {d: interop.from_jax(j.rotk[d], device="cpu")
              for d in j.rotk.keys()}
    return j, t


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def _cts(x):
    if isinstance(x, list):
        return [c for v in x for c in _cts(v)]
    return [x]


def _same_packed(jp, tp):
    jc, tc = _cts(jp.cts), _cts(tp.cts)
    return len(jc) == len(tc) and all(
        a.level == b.level and all(_eq(x, y) for x, y in zip(a.data, b.data))
        for a, b in zip(jc, tc))


def _states_equal(j, t):
    return np.array_equal(np.asarray(j.rng.states), t.rng.states.numpy())


@pytest.mark.parametrize("shape, num_slots", [
    ((2, 3, 8), 64), ((2, 128), 64), ((5,), 64), ((3, 100), 64),
    ((4, 5), 8), ((1, 64), 64)])
def test_pack_unpack_matches_jax(shape, num_slots):
    """The packing math on numpy arrays: the JAX package's logical slot
    count and packed array, exactly, and unpack(pack(x)) == x."""
    x = np.random.default_rng(len(shape)).uniform(-1, 1, shape)
    JP, TP = jpacking.FeatureWisePacking, tpacking.FeatureWisePacking
    logical = TP.find_logical_num_slots(num_slots, shape[-1])
    assert logical == JP.find_logical_num_slots(num_slots, shape[-1])
    packed = TP.pack(x, num_slots, logical)
    assert np.array_equal(packed, JP.pack(x, num_slots, logical))
    assert packed.shape[-1] == num_slots
    back = TP.unpack(packed, logical, shape[-1])
    assert np.array_equal(back, x)
    assert np.array_equal(back, JP.unpack(packed, logical, shape[-1]))


@pytest.mark.parametrize("fold", [False, True])
def test_feature_wise_encoding_matches_jax(pair, fold):
    """``FeatureWiseCTEncoding.encodecrypt`` of a [2, 3, 8] array (one
    ciphertext a row) and of a [2, 2 * num_slots] array (two a row): the
    JAX package's ciphertexts and metadata; the decrypt within ``TOL``."""
    j, t = _synced(pair)
    shape = (2, 2 * t.num_slots) if fold else (2, 3, 8)
    x = np.random.default_rng(1).uniform(-1, 1, shape)
    jp = jpacking.FeatureWiseCTEncoding.encodecrypt(x, j)
    tp = tpacking.FeatureWiseCTEncoding.encodecrypt(x, t)
    assert _same_packed(jp, tp) and _states_equal(j, t)
    assert len(tp.cts[0]) == (2 if fold else 1)
    md = tp.metadata
    assert (md.original_shape, md.logical_num_slots) == \
        (jp.metadata.original_shape, jp.metadata.logical_num_slots)
    assert md.packed_by is tpacking.FeatureWisePacking
    assert md.encoded_by is tpacking.FeatureWiseCTEncoding
    out = tpacking.FeatureWiseCTEncoding.decryptcode(tp, t)
    assert out.shape == x.shape and np.abs(out - x).max() < TOL


def test_packed_ct_ops_match_jax(pair):
    """``PackedCT`` + and * with a PackedCT, a scalar and a vector, its
    negation and clone: the JAX package's bytes, within ``TOL`` of numpy;
    the port's PackedCT carried from the JAX one decrypts alike."""
    j, t = _synced(pair)
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-1, 1, (2, 1, 8))
    jx, jy = (jpacking.FeatureWiseCTEncoding.encodecrypt(v, j)
              for v in (x, y))
    tx, ty = (interop.from_jax(p, device="cpu") for p in (jx, jy))
    assert _same_packed(jx, tx)
    assert tx.metadata.encoded_by is tpacking.FeatureWiseCTEncoding
    vec = rng.uniform(-1, 1, t.num_slots)
    ops = {
        "x + y": (lambda a, b: a + b, x + y),
        "x * y": (lambda a, b: a * b, x * y),
        "-x": (lambda a, b: -a, -x),
        "x + 0.5": (lambda a, b: a + 0.5, x + 0.5),
        "x * 2.0": (lambda a, b: a * 2.0, 2.0 * x),
        "x * vector": (lambda a, b: a * vec, x * vec[:8]),
        "clone": (lambda a, b: a.clone(), x),
    }
    dec = tpacking.FeatureWiseCTEncoding.decryptcode
    for name, (op, want) in ops.items():
        j, t = _synced(pair)
        jout, tout = op(jx, jy), op(tx, ty)
        assert _same_packed(jout, tout) and _states_equal(j, t), name
        assert np.abs(dec(tout, t) - want).max() < TOL, name


@pytest.mark.parametrize("bias", [True, False])
def test_he_linear_matches_jax(pair, bias):
    """``HELinearFeatureWise`` (dim 8: one pc_mult a row, 3 rotate-and-sum
    rotations, the mask, the placement rotation) with and without bias:
    the JAX forward's bytes, and ``x @ W.T (+ b)`` within 200 x ``TOL``.
    The JAX layer carried over (its plaintext rows with their caches) runs
    on the port engine to the same bytes and draws nothing."""
    j, _ = pair
    dim = 8
    rng = np.random.default_rng(4 if bias else 5)
    W = rng.uniform(-1, 1, (dim, dim))
    b = rng.uniform(-1, 1, dim) if bias else None
    x = rng.uniform(-1, 1, (1, dim))
    jin = jpacking.FeatureWiseCTEncoding.encodecrypt(x, j)
    tin = interop.from_jax(jin, device="cpu")
    j, t = _synced(pair)
    jlayer = jnn.HELinearFeatureWise(W, b, j)
    tlayer = tnn.HELinearFeatureWise(W, b, t)
    assert (tlayer.dim, tlayer.logical, tlayer.fold, tlayer.period) == \
        (jlayer.dim, jlayer.logical, jlayer.fold, jlayer.period)
    jout = jlayer(jin)
    tout = tlayer(tin)
    assert _same_packed(jout, tout) and _states_equal(j, t)
    got = tpacking.FeatureWiseCTEncoding.decryptcode(tout, t)
    want = x @ W.T + (b if bias else 0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 200 * TOL

    carried = interop.from_jax(jlayer, engine=t)
    assert isinstance(carried, tnn.HELinearFeatureWise)
    assert carried.weight_rows[0][0].cache[0]["pc_mult"].device == t.device
    before = t.rng.states.clone()
    again = carried(tin)
    assert _same_packed(jout, again)
    assert torch.equal(before, t.rng.states)
    with pytest.raises(ValueError, match="engine="):
        interop.from_jax(jlayer)


def test_batched_inference_toy():
    """The port's ``batched_inference`` through its registry at the toy
    (features 3, batches 2): the encrypted logistic-regression scores
    within 1e-4 of numpy, with the JAX package's metric names."""
    from tiberate_tpu_torch.extension.benchmarks import benchreg

    res = benchreg["batched_inference"]().run(
        preset="toy", features=3, batches=2, iters=1, device="cpu")
    vals = {m.name: m.value for m in res.metrics}
    assert list(vals) == ["samples_per_s", "latency_per_batch_ms", "max_err",
                          "samples", "features", "encode_ms", "decode_ms",
                          "codec_share"]
    assert vals["max_err"] < 1e-4
    assert vals["samples_per_s"] > 0 and 0 < vals["codec_share"] < 1
    assert vals["samples"] == 2 * 128  # batches x num_slots (logN 8)
