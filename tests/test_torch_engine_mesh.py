"""``CkksEngine(mesh=)`` against the JAX engine, on ``["cpu"] * D``.

The port's counterpart of ``tests/test_parallel.py::test_engine_mesh_mode``:
the same seed and nonce in both packages, the same draws in the same order
(keys on first use), so every ciphertext must be the JAX engine's bytes,
whether an op ran per shard or took the gathered route:

* rns 2 x coef 2, 62-bit toy: ``encodecrypt`` (laid out over the mesh),
  ``cc_mult`` (the sharded step: the work level's 4 channels divide 2),
  ``rotate_offset(3)`` at level 0 (5 channels: the gathered keyswitch) and
  of the product at level 1 (the sharded keyswitch with coef cross
  stages), and ``decryptcode`` within tests/test_parallel.py's 1e-3;
* rns 2, 30-bit toy: the same ops, within the JAX 30-bit bound 1e-2.
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine as JaxEngine
from tiberate_tpu_torch.engine import CkksEngine as TorchEngine
from tiberate_tpu_torch.parallel import mesh as meshlib

CASES = {
    "toy_rns2_coef2": (dict(scale_bits=30), dict(rns=2, coef=2), 1e-3),
    "toy30_rns2": (dict(scale_bits=21, buffer_bit_length=30),
                   dict(rns=2, coef=1), 1e-2),
}


def _bytes(ct):
    return [np.asarray(d.gather() if isinstance(d, meshlib.ShardedArray)
                       else d) for d in ct.data]


def _same(t, j):
    return all(np.array_equal(a, np.asarray(b))
               for a, b in zip(_bytes(t), j.data))


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_mesh_matches_jax(case):
    cfg_kw, axes, tol = CASES[case]
    cfg = toy_config(logN=7, num_scales=4, num_special_primes=2, **cfg_kw)
    mesh = meshlib.make_mesh(devices=["cpu"] * (axes["rns"] * axes["coef"]),
                             **axes)
    ref = JaxEngine(cfg, seed=42, nonce=5)
    eng = TorchEngine(cfg, seed=42, nonce=5, mesh=mesh)
    assert eng.mesh is mesh and eng.device == torch.device("cpu")

    m1 = np.linspace(-1, 1, eng.num_slots)
    m2 = np.cos(np.linspace(0, 3, eng.num_slots))
    ct1, ct2 = eng.encodecrypt(m1), eng.encodecrypt(m2)
    rt1, rt2 = ref.encodecrypt(m1), ref.encodecrypt(m2)
    # placement: one block per mesh device; 5 channels stay whole on rns
    d = ct1.data[0]
    assert isinstance(d, meshlib.ShardedArray) and len(d.blocks) == mesh.size
    assert d.spec == (None, "coef" if axes["coef"] > 1 else None)
    assert isinstance(eng.sk.data, meshlib.ShardedArray)
    assert _same(ct1, rt1) and _same(ct2, rt2)

    out = eng.cc_mult(ct1, ct2)
    ref_out = ref.cc_mult(rt1, rt2)
    assert out.data[0].spec[-2] == "rns"       # the sharded step's rows
    assert _same(out, ref_out)
    dec = eng.decryptcode(out, is_real=True)
    assert np.abs(dec - m1 * m2).max() < tol

    rot = eng.rotate_offset(ct1, 3)
    assert _same(rot, ref.rotate_offset(rt1, 3))
    dec_rot = eng.decryptcode(rot, is_real=True)
    assert np.abs(dec_rot - np.roll(m1, 3)).max() < tol

    mesh.reset_counts()
    rot2 = eng.rotate_offset(out, 3)
    assert mesh.counts["all_gather"] >= 2      # per rotation: one switch
    assert rot2.data[0].spec[-2] == "rns"
    assert _same(rot2, ref.rotate_offset(ref_out, 3))

    # the level-0 keyswitches (5 channels) took the gathered route, as did
    # the decrypts; the level-1 ones ran per shard
    assert eng.gathered_ops["switch_key"] == 2
    assert eng.gathered_ops["decryptcode"] == 2
    assert "cc_mult" not in eng.gathered_ops
