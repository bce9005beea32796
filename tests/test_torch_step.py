"""The port's fused cc_mult step against the JAX package's step.

The JAX engine makes the keys and ciphertexts; ``interop.from_jax`` carries
its evk and ciphertexts into the port, and both ``make_mult_step`` steps
(rescale -> tensor product -> relinearize) run on them.  The port's step
keyswitches through the all-parts kernel, its one route on one device at
every logN (the JAX package's from logN17 up is the per-part chain), with
the key form ``prepare_step_ksk`` returns.  Both outputs are canonical
[0, q) residues, so the tolerance is none: byte-identical.  The decrypt
error of the port's result stays under the bound of the JAX package's own
tests for that size.
"""

import jax
import numpy as np
import pytest

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine as JaxEngine
from tiberate_tpu.parallel import sharded as jsharded
from tiberate_tpu_torch import interop
from tiberate_tpu_torch.engine import CkksEngine as TorchEngine
from tiberate_tpu_torch.parallel import sharded as tsharded


def _toy():
    return toy_config(logN=7, num_scales=4, num_special_primes=2,
                      scale_bits=30)


def _toy_s6():
    """Six special primes: keyswitch parts of alpha 5, 6, 2 and 1 at the
    step's work level, the logN17 pattern in small."""
    return toy_config(logN=7, num_scales=14, num_special_primes=6,
                      scale_bits=30)


def _toy30():
    """The 30-bit mode (int32 residues, R = 2^30): parts of alpha 1 and 2 at
    the step's work level."""
    return toy_config(logN=7, num_scales=4, num_special_primes=2,
                      scale_bits=21, buffer_bit_length=30)


# (config, decrypt-error bound): tests/test_engine.py's toy bound,
# tests/test_golden.py's logN14 bound, and the 30-bit bounds of
# tests/test_mode30.py (toy) and tests/test_full_presets.py (logN14_30)
CASES = {"toy": (_toy, 5e-5), "toy_s6": (_toy_s6, 5e-5),
         "logN14": (lambda: "logN14", 1e-3), "toy30": (_toy30, 1e-2),
         "logN14_30": (lambda: "logN14_30", 5e-3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_step_matches_jax_step(case):
    make_cfg, tol = CASES[case]
    jeng = JaxEngine(make_cfg(), seed=21, nonce=5)
    rng = np.random.default_rng(9)
    m1, m2 = (rng.uniform(-1, 1, jeng.num_slots) for _ in range(2))
    ca, cb = jeng.encodecrypt(m1), jeng.encodecrypt(m2)

    jstep = jax.jit(jsharded.make_mult_step(jeng, 0))
    want = jstep(ca.data[0], ca.data[1], cb.data[0], cb.data[1],
                 jsharded.prepare_step_ksk(jeng, 0),
                 jsharded.mult_step_params(jeng, 0))

    teng = TorchEngine(jeng.ckksCfg, device="cpu", seed=21)
    teng.sk = interop.from_jax(jeng.sk, device="cpu")
    teng.evk = interop.from_jax(jeng.evk, device="cpu")
    ta, tb = interop.from_jax(ca, device="cpu"), interop.from_jax(cb, device="cpu")
    step = tsharded.make_mult_step(teng, 0)
    ksk = tsharded.prepare_step_ksk(teng, 0)
    # the all-parts key form at the work level, cached on the evk
    assert ksk[1] is teng._ksk_parts_fused(teng.evk, 1)[1]
    got = step(ta.data[0], ta.data[1], tb.data[0], tb.data[1], ksk,
               tsharded.mult_step_params(teng, 0))
    for w, g in zip(want, got):
        assert g.dtype == teng.params.dtype
        assert np.array_equal(np.asarray(w), g.numpy())

    out = teng.decryptcode(teng.cc_mult(ta, tb), is_real=True)
    assert np.abs(out - m1 * m2).max() < tol


def test_port_rescale_matches_jax_rescale():
    """``CkksEngine.rescale`` on a JAX ciphertext carried across, twice in a
    row: canonical residues, so byte-identical at each level."""
    jeng = JaxEngine(_toy(), seed=21, nonce=5)
    teng = TorchEngine(jeng.ckksCfg, device="cpu", seed=21)
    m = np.random.default_rng(10).uniform(-1, 1, jeng.num_slots)
    jct = jeng.encodecrypt(m)
    tct = interop.from_jax(jct, device="cpu")
    for level in (1, 2):
        jct, tct = jeng.rescale(jct), teng.rescale(tct)
        assert jct.level == tct.level == level
        for w, g in zip(jct.data, tct.data):
            assert np.array_equal(np.asarray(w), g.numpy())
