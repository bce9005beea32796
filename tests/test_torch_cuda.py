"""tiberate_tpu_torch's CUDA kernels on the card (marked ``cuda``).

Every test here needs a GPU and skips without one: the kernels against
their plain versions (the keyswitch-chain kernel with and without a skip
range), the chain step against the all-parts step, and the card's step
against the CPU's.  The file imports no jax, so it also runs on a machine
that has only torch:

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
from tiberate_tpu_torch.parallel import sharded
from tiberate_tpu_torch.typing import Ciphertext

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
@pytest.mark.parametrize("logN", [7, 10])
def test_ntt_keymul_accum_matches_plain_on_card(card, logN):
    """The chain kernel with no skip range and with each part's range of
    the S = 6 toy: accumulators updated in place, skipped rows untouched,
    byte-identical to the plain version."""
    tp = CkksParams(toy_config(logN=logN, num_scales=14,
                               num_special_primes=6, scale_bits=30), card)
    lp = tp.lp(LEVEL, True)
    C, N = lp.num_channels, 1 << logN
    gen = torch.Generator().manual_seed(100 + logN)

    def uni(shape, bound):
        x = torch.randint(0, 1 << 62, shape, generator=gen)
        return (x % bound.cpu()[:, None]).to(card)

    x = uni((BATCH, C, N), lp.pack.q)
    keys = (uni((C, N), lp.pack.q), uni((C, N), lp.pack.q))
    skips = [None] + [(p.lo, p.hi) for p in tp.parts[LEVEL]]
    for skip in skips:
        acc = (uni((BATCH, C, N), 2 * lp.pack.q),
               uni((BATCH, C, N), 2 * lp.pack.q))
        want = K.ntt_keymul_accum_plain(x, lp, keys,
                                        tuple(a.clone() for a in acc), skip)
        before = tuple(a.clone() for a in acc)
        got = K.ntt_keymul_accum(x, lp, keys, acc, skip)
        torch.cuda.synchronize()
        for g, a, w, b in zip(got, acc, want, before):
            assert g is a
            assert torch.equal(g, w), skip
            if skip is not None:
                assert torch.equal(g[..., skip[0] : skip[1], :],
                                   b[..., skip[0] : skip[1], :])


@pytest.mark.cuda
def test_chain_step_equals_parts_kernel_step_on_card(card):
    """The fused step through the per-part chain (13 parts at logN17, 4
    here) equals the step through the all-parts kernel, byte for byte;
    each route launches only its own keyswitch kernel."""
    eng = teng.CkksEngine(toy_config(logN=10, num_scales=14,
                                     num_special_primes=6, scale_bits=30),
                          device=card, seed=6)
    rng = np.random.default_rng(4)
    m1, m2 = (rng.uniform(-1, 1, (BATCH, eng.num_slots)) for _ in range(2))
    a = teng.stack_ciphertexts([eng.encodecrypt(m) for m in m1])
    b = teng.stack_ciphertexts([eng.encodecrypt(m) for m in m2])
    step = eng._fused_mult_step(0)
    ksk = sharded.prepare_step_ksk(eng, 0)
    prm = sharded.mult_step_params(eng, 0)
    outs = []
    for route in (prm, dict(prm, parts_fused=None)):
        K.reset_launch_counts()
        outs.append(step(a.data[0], a.data[1], b.data[0], b.data[1], ksk,
                         route))
        torch.cuda.synchronize()
        chain = route["parts_fused"] is None
        assert K.LAUNCHES["ntt_keymul_accum"] == (4 if chain else 0)
        assert K.LAUNCHES["ntt_keymul_parts"] == (0 if chain else 1)
    for k6, ch in zip(*outs):
        assert torch.equal(k6, ch)
    out = Ciphertext(data=outs[1], level=1)
    dec = np.stack([eng.decryptcode(ct, is_real=True)
                    for ct in teng.unstack_ciphertext(out)])
    assert np.abs(dec - m1 * m2).max() < 5e-5


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
