"""tiberate_tpu_torch's CUDA kernels on the card (marked ``cuda``).

Every test here needs a GPU and skips without one.  The file imports no
jax, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports jax).  Tolerance: none —
each kernel must equal its plain torch version byte for byte, lazy
outputs included, and the engine's step on the card must equal the same
step on CPU tensors.
"""

import numpy as np
import pytest
import torch

from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.context.ntt_context import CkksParams
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import ntt_kernels as K

LEVEL = 1
BATCH = 2


def _cfg(logN):
    return toy_config(logN=logN, num_scales=4, num_special_primes=2,
                      scale_bits=30)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("logN", [4, 7, 10])
def test_kernels_match_plain_on_card(card, logN):
    tp = CkksParams(_cfg(logN), card)
    lp_ord, lp_sp = tp.lp(LEVEL, False), tp.lp(LEVEL, True)
    gen = torch.Generator().manual_seed(logN)

    def uni(lp, shape):
        x = torch.randint(0, 1 << 62, shape, generator=gen)
        return (x % lp.pack.q.cpu()[:, None]).to(card)

    C, C_sp, N = lp_ord.num_channels, lp_sp.num_channels, 1 << logN
    x = uni(lp_ord, (BATCH, C, N))
    y = [uni(lp_ord, (BATCH, C, N)) for _ in range(4)]
    keys = (uni(lp_ord, (C, N)), uni(lp_ord, (C, N)))
    acc = uni(lp_sp, (BATCH, C_sp, N))
    p0 = uni(lp_sp[C:], (BATCH, tp.S, N))
    ec, alphas = teng._parts_consts(tp, LEVEL)
    st = teng._parts_digits(x, tp.parts[LEVEL], lp_ord, ec.shape[-1])
    pkeys = tuple(torch.stack([uni(lp_sp, (C_sp, N))
                               for _ in range(ec.shape[0])])
                  for _ in range(2))
    pairs = [
        (K.ntt(x, lp_ord, True), K.ntt_plain(x, lp_ord, True)),
        (K.ntt(x, lp_ord, False), K.ntt_plain(x, lp_ord, False)),
        (K.intt(x, lp_ord, "mont"), K.intt_plain(x, lp_ord, "mont")),
        (K.intt(x, lp_ord, "exit"), K.intt_plain(x, lp_ord, "exit")),
        (K.intt(x, lp_ord, "exit_reduce"),
         K.intt_plain(x, lp_ord, "exit_reduce")),
        (K.ntt_keymul(x, lp_ord, keys[:1], True),
         K.ntt_keymul_plain(x, lp_ord, keys[:1], True)),
        (K.ntt_keymul(x, lp_ord, keys, False),
         K.ntt_keymul_plain(x, lp_ord, keys, False)),
        (K.intt_pdiv(acc, p0, lp_ord, tp.PiRs[LEVEL]),
         K.intt_pdiv_plain(acc, p0, lp_ord, tp.PiRs[LEVEL])),
        (K.ntt_tensor(*y, lp_ord), K.ntt_tensor_plain(*y, lp_ord)),
        (K.ntt_keymul_parts(st, ec, alphas, pkeys, lp_sp),
         K.ntt_keymul_parts_plain(st, ec, alphas, pkeys, lp_sp)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_wrappers_reject_bad_operands(card):
    tp = CkksParams(_cfg(7), card)
    lp = tp.lp(LEVEL, False)
    x = torch.zeros((lp.num_channels, 128), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        K.ntt(x.to(torch.int32), lp, True)
    with pytest.raises(ValueError):
        K.ntt(x.t().contiguous().t(), lp, True)
    with pytest.raises(ValueError):
        K.ntt(x[:-1], lp, True)


@pytest.mark.cuda
def test_engine_step_on_card_equals_cpu(card):
    """encodecrypt -> cc_mult -> decryptcode on the card; the step's bytes
    equal the CPU step's on the same ciphertexts and evk."""
    eng = teng.CkksEngine(_cfg(10), device=card, seed=5)
    rng = np.random.default_rng(3)
    m1, m2 = (rng.uniform(-1, 1, eng.num_slots) for _ in range(2))
    a, b = eng.encodecrypt(m1), eng.encodecrypt(m2)
    K.reset_launch_counts()
    out = eng.cc_mult(a, b)
    torch.cuda.synchronize()
    for name in ("intt", "intt_pdiv", "ntt_tensor", "ntt_keymul_parts"):
        assert K.LAUNCHES[name] > 0, name
    assert np.abs(eng.decryptcode(out, is_real=True) - m1 * m2).max() < 5e-5

    cpu = teng.CkksEngine(_cfg(10), device="cpu", seed=5)
    evk = eng.evk
    cpu.evk = type(evk)(
        data=tuple(tuple(t.cpu() for t in part) for part in evk.data),
        flags=evk._flags, level=evk.level,
    )
    ref = cpu.cc_mult(*(type(c)(data=tuple(d.cpu() for d in c.data),
                                level=c.level) for c in (a, b)))
    for g, r in zip(out.data, ref.data):
        assert torch.equal(g.cpu(), r)
