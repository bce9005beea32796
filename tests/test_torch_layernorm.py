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

The stacked forward (one ``Ciphertext`` of F rows):

* at both rings, each row's residues are the list forward's, and at the
  JAX ring the JAX layer's;
* in chunks of 3 features (F = 8) the same as in one chunk;
* per-row ``mult_scalar`` / ``add_scalar``: each row the scalar call's on
  that row alone, in both lanes;
* against ``fhebench/reference/layernorm.py`` at a ring of 16 levels
  (logN 7, the BERT cell's depth: ``iters=3`` ends at level 15), F = 8:
  every residue the reference circuit's, the decryption within
  ``CIRCUIT_TOL`` of the same circuit in float64, and a forward with two
  Newton steps outside it;
* its spans: the ``layernorm`` root, its six phases, one ``cc_mult`` a
  chunk, and their launch counts.
"""

import numpy as np
import pytest
import torch

from fhebench.reference import ckks as rref
from fhebench.reference import layernorm as rln
from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.extension import nn as jnn
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.config.toy import toy_config as ttoy_config
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.engine import stack_ciphertexts, unstack_ciphertext
from tiberate_tpu_torch.extension import nn as tnn
from tiberate_tpu_torch.utils import trace

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


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX engine and the port engine on one configuration object, the
    port's keys and ciphertexts carried from the JAX engine, and the JAX
    layer (one Newton step) with its forward."""
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
    return dict(t=t, x=x, gamma=gamma, beta=beta, var_range=var_range,
                tcts=tcts, jln=jln, jout=jln(jcts))


def test_layernorm_matches_jax(jax_pair):
    """One Newton step: the JAX forward's bytes for every feature, and the
    carried JAX layer's on the port engine."""
    t, x, tcts = jax_pair["t"], jax_pair["x"], jax_pair["tcts"]
    gamma, beta = jax_pair["gamma"], jax_pair["beta"]
    jln, jout = jax_pair["jln"], jax_pair["jout"]
    tln = tnn.HELayerNormFeatureWise(gamma, beta, t, eps=EPS,
                                     var_range=jax_pair["var_range"],
                                     iters=1)
    assert (tln._y0_a, tln._y0_b) == (jln._y0_a, jln._y0_b)
    tout = tln(tcts)
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


# ----------------------------------------------------------------------
# The stacked forward.
# ----------------------------------------------------------------------

JAX_RING = dict(logN=7, num_scales=11, num_special_primes=2, scale_bits=30)
NUMPY_RING = dict(logN=8, num_scales=14, num_special_primes=2, scale_bits=30)
DEEP_RING = dict(logN=7, num_scales=16, num_special_primes=2, scale_bits=30)
FB = 8                   # features at the deep ring
VAR_RANGE = (0.5, 2.0)   # the BERT configuration's
BERT_EPS = 1e-12
# The decryption's distance from the same circuit in float64 at the deep
# ring (scale 2^30): the CKKS noise of 15 levels, 3.4e-7 to 6.5e-7 over
# message seeds 0-2 here; 1e-5 leaves room above it and lies far below
# what two Newton steps instead of three leave (1.2e-2 to 1.5e-2 on the
# same seeds: their rsqrt is 4.7e-3 off).
CIRCUIT_TOL = 1e-5


def _rows_equal(stacked, outs):
    return all(torch.equal(o.data[i], stacked.data[i][f])
               for f, o in enumerate(outs) for i in (0, 1))


@pytest.mark.parametrize("ring", ["jax", "numpy"])
def test_stacked_matches_list(jax_pair, ring):
    """Each row of the stacked forward has the list forward's residues,
    and at the JAX ring the JAX layer's."""
    if ring == "jax":
        eng, cts, jout = jax_pair["t"], jax_pair["tcts"], jax_pair["jout"]
        gamma, beta = jax_pair["gamma"], jax_pair["beta"]
        var_range, iters = jax_pair["var_range"], 1
    else:
        eng = teng.CkksEngine(ttoy_config(**NUMPY_RING), device="cpu",
                              seed=7)
        x, gamma, beta, var_range = _data(eng.num_slots)
        cts, iters, jout = eng.encodecrypt_batch(list(x)), 2, None
    ln = tnn.HELayerNormFeatureWise(gamma, beta, eng, eps=EPS,
                                    var_range=var_range, iters=iters)
    stacked = ln(stack_ciphertexts(cts))
    listed = ln(cts)
    assert isinstance(stacked, teng.Ciphertext)
    assert stacked.data[0].shape[0] == F
    assert stacked.level == listed[0].level
    assert _rows_equal(stacked, listed)
    if jout is not None:
        for f, a in enumerate(jout):
            assert all(_eq(u, v[f]) for u, v in zip(a.data, stacked.data))


@pytest.fixture(scope="module")
def deep():
    """An engine of 16 levels and F = 8 seeded BERT-like inputs: (engine,
    messages, gamma, beta, the stacked ciphertexts)."""
    eng = teng.CkksEngine(ttoy_config(**DEEP_RING), device="cpu", seed=11)
    rng = np.random.default_rng(11)
    x = rln.messages(rng, FB, eng.num_slots, VAR_RANGE)
    gamma = rng.uniform(0.5, 1.5, FB)
    beta = rng.uniform(-0.5, 0.5, FB)
    eng.evk  # noqa: B018
    return eng, x, gamma, beta, stack_ciphertexts(
        eng.encodecrypt_batch(list(x)))


def test_chunked_forward_matches_one_chunk(deep, monkeypatch):
    eng, _, gamma, beta, X = deep
    ln = eng.layer_norm(gamma, beta, eps=BERT_EPS, var_range=VAR_RANGE,
                        iters=3)
    assert tnn.stack_chunk(eng, 1) >= FB
    whole = ln(X)
    monkeypatch.setattr(tnn, "stack_chunk", lambda engine, level: 3)
    chunked = ln(X)
    assert all(torch.equal(a, b) for a, b in zip(whole.data, chunked.data))


@pytest.mark.parametrize("op,values", [
    ("mult_scalar", [0.75, -1.25, 3e-3, 1.0]),
    ("add_scalar", [0.5, -0.25, 1e-12, -2.0])])
@pytest.mark.parametrize("lane", [30, 62])
def test_per_row_scalar_matches_each_row(op, values, lane):
    """One value per stacked ciphertext: row i is the scalar call's on row
    i alone; a count that is not the stack's is refused."""
    ring = (dict(logN=6, num_scales=4, num_special_primes=2, scale_bits=21,
                 buffer_bit_length=30) if lane == 30 else
            dict(logN=6, num_scales=4, num_special_primes=2, scale_bits=30))
    eng = teng.CkksEngine(ttoy_config(**ring), device="cpu", seed=4)
    rng = np.random.default_rng(4)
    cts = eng.encodecrypt_batch(list(rng.uniform(-1, 1, (4, eng.num_slots))))
    cts = [eng.level_up(c, 1) for c in cts]
    fn = getattr(eng, op)
    stacked = fn(stack_ciphertexts(cts), np.asarray(values))
    assert _rows_equal(stacked, [fn(c, v) for c, v in zip(cts, values)])
    with pytest.raises(ValueError, match="scalars of shape"):
        fn(stack_ciphertexts(cts), values[:3])


def _reference(eng, X, gamma, beta, iters):
    pr = rref.Params([int(q) for q in eng.params.q], eng.ckksCfg.logN,
                     eng.ckksCfg.num_special_primes, "cpu",
                     eng.ckksCfg.scale_bits)
    circuit = rln.Circuit(pr, [tuple(p) for p in eng.evk.data], BERT_EPS,
                          VAR_RANGE, iters)
    (i, z), = circuit.forward(*X.data, gamma, beta, FB)
    return pr, z


@pytest.mark.parametrize("iters", [3, 2])
def test_forward_against_the_reference(deep, iters):
    """The residues of the reference circuit at any ``iters``; three Newton
    steps decrypt within CIRCUIT_TOL of the float64 circuit of three, two
    do not."""
    eng, x, gamma, beta, X = deep
    out = eng.layer_norm(gamma, beta, eps=BERT_EPS, var_range=VAR_RANGE,
                         iters=iters)(X)
    pr, z = _reference(eng, X, gamma, beta, iters)
    assert out.level == z.level == rln.output_level(iters)
    assert torch.equal(out.data[0], z.c0) and torch.equal(out.data[1], z.c1)
    s, bad = rref.secret(pr, eng.sk.data)
    y, _ = rln.decrypt(pr, *out.data, s, out.level,
                       rln.scale_at(pr, out.level))
    got = rref.decode(y).real
    assert bad == 0
    assert np.abs(got - eng.decryptcode_batch(unstack_ciphertext(out),
                                              is_real=True)).max() < 1e-6
    err = np.abs(got - rln.float_circuit(x, gamma, beta, BERT_EPS,
                                         VAR_RANGE, 3)).max()
    if iters == 3:
        assert err < CIRCUIT_TOL
        assert np.abs(got - rln.exact(x, gamma, beta, BERT_EPS)).max() < 1e-3
    else:
        assert err > 100 * CIRCUIT_TOL


def test_stacked_spans(deep, monkeypatch):
    """The ``layernorm`` root holds its six phases in order, one
    ``cc_mult`` a chunk in the squares and in the outputs, 3 iters in the
    Newton chain; every launch of the forward is counted in a phase, and
    each phase's in its children, plus its own calls' kernels: one a
    polynomial for each rescale (G1) and for each ``cc_add``, ``cc_sub``
    and product by a column in ``level_up`` and ``mult_scalar`` (G4)."""
    eng, _, gamma, beta, X = deep
    ln = eng.layer_norm(gamma, beta, eps=BERT_EPS, var_range=VAR_RANGE,
                        iters=3)
    monkeypatch.setattr(tnn, "stack_chunk", lambda engine, level: 3)
    trace.clear()
    with trace.profile():
        ln(X)
    recs = trace.spans()
    by = {r.index: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["layernorm"]
    root = roots[0]

    def kids(r):
        return [c for c in recs if c.parent == r.index]

    phases = kids(root)
    assert [p.name for p in phases] == [
        "layernorm.mean", "layernorm.center", "layernorm.square",
        "layernorm.var", "layernorm.rsqrt", "layernorm.out"]
    assert root.launches == sum(p.launches for p in phases) > 0
    ph = {p.name: p for p in phases}
    chunks = 3    # 8 features in chunks of 3
    for name, n in (("layernorm.square", chunks), ("layernorm.out", chunks),
                    ("layernorm.rsqrt", 9)):
        assert [c.name for c in kids(ph[name])] == ["cc_mult"] * n, name
    step = kids(ph["layernorm.square"])[0].launches
    assert step > 0
    F = X.data[0].shape[0]

    def tree_adds(n):   # tree_sum's cc_add calls: one a halving
        return 0 if n <= 1 else 1 + tree_adds(n // 2 + n % 2)

    # each chunk's tree, then the sum over the chunks
    adds = sum(tree_adds(min(3, F - i)) for i in range(0, F, 3))
    assert ph["layernorm.square"].launches == (chunks * step
                                               + 2 * (adds + chunks - 1))
    # a chunk's level_up (G1, G4) and cc_sub (G4)
    assert ph["layernorm.center"].launches == chunks * 6
    # the tree, then mult_scalar (G4, G1)
    assert ph["layernorm.mean"].launches == 2 * tree_adds(F) + 4
    assert ph["layernorm.var"].launches == 4
    out_mults = sum(c.launches for c in kids(ph["layernorm.out"]))
    # a chunk's level_up (G1, G4), then gamma's mult_scalar (G4, G1)
    assert ph["layernorm.out"].launches == out_mults + chunks * 4 + 4
    # the engine's spans nest inside: no cc_mult is a root
    assert all(by[r.root].name == "layernorm" for r in recs)
    trace.clear()
