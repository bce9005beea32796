"""The port's mesh layer against the JAX package, on ``["cpu"] * D``.

At the toy of the JAX package's mesh tests (``toy_config(logN=7,
num_scales=3, num_special_primes=2, scale_bits=30)``,
tests/test_parallel.py::test_rns_sharded_keyswitch) and its 30-bit twin:

* the coefficient-sharded NTT and iNTT at D = 2, 4, 8 give the bytes of the
  JAX package's unsharded ``ops.ntt`` (lazy forward outputs included);
* the rns-sharded switcher at D = 2, 4, with the special rows replicated
  and scattered, and at rns 2 x coef 2, gives the bytes of the JAX
  engine's unsharded ``create_switcher`` (the JAX package's mesh test
  proves its own sharded switcher equals that), with one all_gather a
  switch, two with scattered special rows; so does its per-part loop
  (``_pre_extend``, ``_extend``, ``ntt_keymul``, ``ntt_keymul_accum``)
  over parts of unequal alpha, at the logN17-pattern toy
  (``toy_config(logN=7, num_scales=14, num_special_primes=6,
  scale_bits=30)``) at level 1: 14 ordinary channels, parts (0, 5),
  (5, 11), (11, 13), (13, 14), at rns 2 and rns 2 x coef 2;
* the (batch 2, rns 2) mesh step on B = 4 gives the single-device step's
  bytes per ciphertext, with one all_gather in all.

Residues are canonical where the reference's are, so the tolerance is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.context.ntt_context import CkksParams as JParams
from tiberate_tpu.engine import CkksEngine as JaxEngine
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams
from tiberate_tpu_torch.engine import CkksEngine as TorchEngine
from tiberate_tpu_torch.parallel import coef_sharded, rns_sharded
from tiberate_tpu_torch.parallel import mesh as meshlib
from tiberate_tpu_torch.parallel import sharded as tsharded

TOYS = {
    "toy": lambda: toy_config(logN=7, num_scales=3, num_special_primes=2,
                              scale_bits=30),
    "toy30": lambda: toy_config(logN=7, num_scales=3, num_special_primes=2,
                                scale_bits=21, buffer_bit_length=30),
}


def _cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return meshlib.make_mesh(devices=["cpu"] * n, **axes)


@pytest.mark.parametrize("case", sorted(TOYS))
def test_coef_sharded_ntt_matches_jax(case):
    cfg = TOYS[case]()
    jp, tp = JParams(cfg), TParams(cfg, "cpu")
    jlp, tlp = jp.lp(0, True), tp.lp(0, True)
    rng = np.random.default_rng(0)
    a = np.stack([rng.integers(0, 2 * q, tp.N) for q in tp.q]).astype(
        cfg.numpy_dtype)
    want_f = np.asarray(jntt.ntt(jnp.asarray(a), jlp.psi, jlp.pack))
    want_rt = np.asarray(jntt.intt(jnp.asarray(want_f), jlp.ipsi, jlp.Ninv,
                                   jlp.pack))
    for D in (2, 4, 8):
        mesh = _cpu_mesh(rns=1, coef=D)
        ntt_fn, intt_fn = coef_sharded.make_coef_sharded_ntt(tlp, cfg.logN,
                                                             mesh)
        x = meshlib.ShardedArray.from_tensor(torch.from_numpy(a), mesh,
                                             (None, "coef"))
        got_f = ntt_fn(x)
        assert got_f.spec == (None, "coef") and len(got_f.blocks) == D
        assert np.array_equal(got_f.gather().numpy(), want_f), D
        assert np.array_equal(intt_fn(got_f).gather().numpy(), want_rt), D
        # log2(D) cross stages each way, one ppermute each
        assert mesh.counts["ppermute"] == 2 * (D.bit_length() - 1)
        assert mesh.counts["all_gather"] == 0


def _switch_case(cfg, level):
    """(JAX c0, c1 of create_switcher at ``level``, port engine carrying the
    JAX evk, the input a: two rows of the level's ordinary channels)."""
    jeng = JaxEngine(cfg, seed=5, nonce=2)
    q = jeng.params.q[level:jeng.params.P]
    rng = np.random.default_rng(0)
    a = np.stack([rng.integers(0, p, (2, jeng.params.N)) for p in q],
                 axis=1).astype(cfg.numpy_dtype)
    want = [np.stack([np.asarray(c) for c in jeng.create_switcher(
        jnp.asarray(row), jeng.evk, level=level)]) for row in a]
    teng = TorchEngine(cfg, device="cpu", seed=5)
    teng.evk = interop.from_jax(jeng.evk, device="cpu")
    return np.stack(want, axis=1), teng, torch.from_numpy(a)


@pytest.fixture(scope="module", params=sorted(TOYS))
def switch_case(request):
    """``_switch_case`` at level 0: C_ord = 4, so 2 and 4 divide it."""
    return _switch_case(TOYS[request.param](), 0)


@pytest.fixture(scope="module")
def switch_case_s6():
    """``_switch_case`` at the logN17-pattern toy, level 1."""
    cfg = toy_config(logN=7, num_scales=14, num_special_primes=6,
                     scale_bits=30)
    return _switch_case(cfg, 1)


def _check_switcher(case, level, rns, coef, scatter):
    want, teng, a = case
    mesh = _cpu_mesh(rns=rns, coef=coef)
    sw = rns_sharded.make_rns_sharded_switcher(
        teng, level, mesh, scatter_special=scatter, coef_axis="coef")
    x = meshlib.ShardedArray.from_tensor(
        a, mesh, (None, "rns", "coef" if coef > 1 else None))
    mesh.reset_counts()
    c0, c1 = sw(x, teng.evk.data)
    for w, g in zip(want, (c0, c1)):
        assert g.spec == x.spec
        assert np.array_equal(g.gather().numpy(), w)
    # one all_gather of the ordinary channels a switch; scattered special
    # rows (not with a coef axis) add one of their canonical rows
    assert mesh.counts["all_gather"] == (2 if scatter and coef == 1 else 1)
    # coef 2: one cross stage a part forward, one for the inverse
    n_parts = len(teng.params.parts[level])
    assert mesh.counts["ppermute"] == (0 if coef == 1 else n_parts + 1)
    # the prepared key form gives the same bytes
    rksk = sw.prepare_ksk(teng.evk.data)
    assert isinstance(rksk, rns_sharded.RnsKsk)
    for w, g in zip(want, sw(x, rksk)):
        assert np.array_equal(g.gather().numpy(), w)


@pytest.mark.parametrize("rns,coef,scatter", [
    (2, 1, False), (4, 1, False), (2, 1, True), (4, 1, True),
    (2, 2, False)])
def test_rns_switcher_matches_jax(switch_case, rns, coef, scatter):
    _check_switcher(switch_case, 0, rns, coef, scatter)


@pytest.mark.parametrize("rns,coef,scatter", [
    (2, 1, False), (2, 1, True), (2, 2, False), (2, 2, True)])
def test_rns_switcher_over_unequal_parts_matches_jax(switch_case_s6, rns,
                                                     coef, scatter):
    """The mesh switcher's per-part loop over parts of alpha 5, 6, 2 and 1
    (rns 4 does not divide the 14 channels)."""
    teng = switch_case_s6[1]
    assert [(p.lo, p.hi) for p in teng.params.parts[1]] == [
        (0, 5), (5, 11), (11, 13), (13, 14)]
    _check_switcher(switch_case_s6, 1, rns, coef, scatter)


def test_batch_rns_mesh_step_matches_single_device_step():
    """make_mult_step on a (batch 2, rns 2) engine mesh, B = 4, level 0
    without the rescale (C_ord = 4 divides 2), against the same engine's
    single-device step per ciphertext (``rns_shard=False``), as the JAX
    package checks its own (tests/test_parallel.py; the single-device
    step is held to the JAX step by tests/test_torch_step.py): the same
    bytes, one all_gather for the whole step."""
    cfg = TOYS["toy"]()
    mesh = _cpu_mesh(batch=2, rns=2, coef=1)
    teng = TorchEngine(cfg, seed=5, mesh=mesh)
    assert teng.device == torch.device("cpu")
    rng = np.random.default_rng(1)
    cts = teng.encodecrypt_batch([rng.uniform(-1, 1, teng.num_slots)
                                  for _ in range(8)])
    local = [[d.gather() for d in ct.data] for ct in cts]
    step_u = tsharded.make_mult_step(teng, 0, pre_rescale=False,
                                     rns_shard=False)
    ksk_u = tsharded.prepare_step_ksk(teng, 0, pre_rescale=False,
                                      rns_shard=False)
    prm_u = tsharded.mult_step_params(teng, 0, pre_rescale=False,
                                      rns_shard=False)
    want = [step_u(*a, *b, ksk_u, prm_u)
            for a, b in zip(local[:4], local[4:])]

    args = [meshlib.ShardedArray.from_tensor(
        torch.stack([c[i] for c in group]), mesh, ("batch", "rns", None))
        for group, i in ((local[:4], 0), (local[:4], 1), (local[4:], 0),
                         (local[4:], 1))]
    prm = tsharded.mult_step_params(teng, 0, pre_rescale=False)
    assert prm["rns_tables"] is not None, "the sharded switcher is off"
    rksk = tsharded.prepare_step_ksk(teng, 0, pre_rescale=False)
    assert isinstance(rksk, rns_sharded.RnsKsk)
    step = tsharded.make_mult_step(teng, 0, pre_rescale=False)
    mesh.reset_counts()
    o0, o1 = step(*args, rksk, prm)
    assert mesh.counts["all_gather"] == 1 and mesh.counts["ppermute"] == 0
    assert o0.spec == ("batch", "rns", None)
    for b, (w0, w1) in enumerate(want):
        assert torch.equal(o0.gather()[b], w0)
        assert torch.equal(o1.gather()[b], w1)


def test_make_mesh_refuses_what_it_cannot_lay_out():
    with pytest.raises(ValueError):
        meshlib.make_mesh(devices=["cpu"] * 2, rns=4)
    with pytest.raises(ValueError):
        meshlib.make_mesh(n_devices=3, devices=["cpu"] * 2)
    mesh = meshlib.make_mesh(devices=["cpu"] * 4, rns=2, coef=2)
    assert mesh.shape == {"rns": 2, "coef": 2}
    assert meshlib.make_mesh(devices=["cpu"] * 4, batch=2).shape == {
        "batch": 2, "rns": 2, "coef": 1}
    x = torch.arange(6 * 8).reshape(6, 8)
    sa = meshlib.shard_leveled(x, mesh)      # 6 rows: 2 divides, 4 no
    assert sa.spec == ("rns", "coef") and torch.equal(sa.gather(), x)
    assert torch.equal(meshlib.reshard(sa, (None, None)).blocks[0, 1], x)
    with pytest.raises(ValueError):
        meshlib.ShardedArray.from_tensor(torch.zeros(3, 8), mesh,
                                         ("rns", None))
    ct = TorchEngine(TOYS["toy"](), device="cpu", seed=1).encodecrypt(
        np.zeros(64))
    laid = meshlib.shard_ciphertext(ct, mesh)
    assert laid.data[0].spec == ("rns", "coef") and laid.level == ct.level
    assert all(torch.equal(a.gather(), b) for a, b in zip(laid.data, ct.data))
