"""The 30-bit mode of tiberate_tpu_torch against the JAX package.

``buffer_bit_length=30``: int32 residues, 15-bit-half REDC with R = 2^30,
q < 2^28.  What has a 62-bit twin runs in both lanes where the twin lives:
the Montgomery and NTT ops, ``CkksParams`` and the exact-REDC oracle in
``tests/test_torch_mont_ntt.py``, every kernel's plain version (K1-K6, K3's
accumulating chain at every part's skip range) in
``tests/test_torch_kernels.py``, the step through both keyswitch routes in
``tests/test_torch_step.py``, the card tests in ``tests/test_torch_cuda.py``.
This file holds what only the 30-bit mode has:

* the ``_30`` presets' prime chains against the JAX package's;
* a port round trip at the JAX package's 30-bit toy
  (``tests/test_pallas_mxu.py``), within its 30-bit bound of 1e-2
  (``tests/test_mode30.py``);
* ``interop.from_jax`` of a 30-bit ciphertext and key: int32 bytes kept.
"""

import numpy as np
import pytest
import torch

from tiberate_tpu.config import CkksConfig as JConfig
from tiberate_tpu.config.toy import toy_config as jax_toy_config
from tiberate_tpu.engine import CkksEngine as JaxEngine
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.config import CkksConfig as TConfig
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine as TorchEngine

torch.set_num_threads(1)

TOL = 1e-2
CFG = dict(logN=7, num_scales=3, num_special_primes=2, scale_bits=21,
           buffer_bit_length=30)


@pytest.mark.parametrize("preset", ["logN14_30", "logN15_30", "logN17_30"])
def test_presets_30_match_jax(preset):
    """``parse("logN15_30")`` etc.: the JAX package's prime chain (19 primes
    at logN15_30, 17 at logN17_30, whose depth parse_30bit caps)."""
    jc, tc = JConfig.parse(preset), TConfig.parse(preset)
    assert [int(q) for q in tc.q] == [int(q) for q in jc.q]
    assert (tc.num_scales, tc.num_special_primes, tc.scale_bits) == (
        jc.num_scales, jc.num_special_primes, jc.scale_bits)
    assert tc.buffer_bit_length == 30 and tc.numpy_dtype == np.int32
    assert max(tc.q) < 1 << 28
    assert len(tc.q) == {"logN14_30": 10, "logN15_30": 19,
                         "logN17_30": 17}[preset]


def test_port_roundtrip_30():
    """encodecrypt -> decryptcode and one cc_mult on the port alone: int32
    ciphertexts, decrypt error within the JAX package's 30-bit bound."""
    eng = TorchEngine(toy_config(**CFG), device="cpu", seed=12)
    rng = np.random.default_rng(38)
    m1, m2 = (rng.uniform(-1, 1, eng.num_slots) for _ in range(2))
    x, y = eng.encodecrypt(m1), eng.encodecrypt(m2)
    assert x.data[0].dtype == torch.int32
    assert eng.sk.data.dtype == eng.evk.data[0][0].dtype == torch.int32
    assert np.abs(eng.decryptcode(x, is_real=True) - m1).max() < TOL
    z = eng.cc_mult(x, y)
    assert z.level == 1 and z.data[0].dtype == torch.int32
    assert np.abs(eng.decryptcode(z, is_real=True) - m1 * m2).max() < TOL


def test_from_jax_keeps_int32():
    """A 30-bit JAX ciphertext and key cross as int32, and the port
    decrypts the ciphertext under the carried key."""
    jax_eng = JaxEngine(jax_toy_config(**CFG), seed=13, nonce=3)
    m = np.random.default_rng(39).uniform(-1, 1, jax_eng.num_slots)
    ct = jax_eng.encodecrypt(m)
    tct = interop.from_jax(ct, device="cpu")
    assert all(d.dtype == torch.int32 for d in tct.data)
    assert all(np.array_equal(np.asarray(j), d.numpy())
               for j, d in zip(ct.data, tct.data))
    eng = TorchEngine(toy_config(**CFG), device="cpu", seed=13)
    eng.sk = interop.from_jax(jax_eng.sk, device="cpu")
    assert eng.sk.data.dtype == torch.int32
    assert np.abs(eng.decryptcode(tct, is_real=True) - m).max() < TOL
