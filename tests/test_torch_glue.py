"""The cc_mult step's glue (``ops/glue_kernels.py``) against the JAX package.

Each glue wrapper takes its plain version on CPU tensors; here they are
held byte for byte against the JAX functions they replace, on the same
numpy inputs, at toy_config(logN=7, num_scales=6, num_special_primes=3)
in both lanes (62-bit int64, scale_bits 30; 30-bit int32, scale_bits 21):
at level 1 its keyswitch parts have alpha 2, 3 and 1, so a part's digits
run the whole Garner recurrence and two parts are zero-padded.

* G1 ``rescale`` (through ``_rescale_core``) against ``_rescale_core``,
  with rows below their rescaler, a rescaler of q - 1 and rescalers at
  ``round_at`` and either side of it;
* G2 ``parts_digits`` (through ``_parts_digits``) against ``_pre_extend``
  per part, the pad rows zero;
* G3 ``pdiv_p0`` through ``_pdiv_fused`` against the JAX ``_pdiv_fused``,
  run as the JAX package's own tests run its Pallas calls on the CPU
  (``pallas_mxu.INTERPRET``).

The CUDA kernels use the exact signed REDC of ``csrc/mont.cuh``; the
last two tests show that the plain versions' half-word REDC equals it on
every operand the glue can feed, at every preset.  The kernels against
the plain versions on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.context.ntt_context import CkksParams as JParams
from tiberate_tpu.engine import ckks_engine as jeng
from tiberate_tpu.ops import pallas_mxu
from tiberate_tpu_torch.config.ckks_config import CkksConfig
from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import glue_kernels as G
from tiberate_tpu_torch.ops import mont

torch.set_num_threads(1)

LEVEL = 1
BATCH = 2
LANES = {62: dict(scale_bits=30),
         30: dict(scale_bits=21, buffer_bit_length=30)}


@pytest.fixture(scope="module", params=sorted(LANES))
def params(request):
    cfg = toy_config(logN=7, num_scales=6, num_special_primes=3,
                     **LANES[request.param])
    jp = JParams(cfg)
    jp.enable_pallas_mxu()  # the JAX _pdiv_fused's Pallas tables
    return jp, TParams(cfg, "cpu")


def _uniform(rng, q, shape):
    """numpy residues uniform in [0, q_c) per channel (axis -2), in the
    lane's dtype (that of ``q``)."""
    dt = np.asarray(q).dtype
    q = np.asarray(q, dtype=np.int64)[:, None]
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % q
            ).astype(dt)


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def _q(lp):
    return np.asarray(lp.pack._2q[:, 0]) // 2


def _flat(x):
    """[B, rows, N] -> [rows, B N]: the JAX cores take one [rows, N]
    operand and are elementwise along N."""
    return jnp.asarray(np.concatenate(list(x), axis=-1))


def test_rescale_matches_jax(params):
    """G1: two ciphertext rows at level 0, one random, one adversarial
    (every kept row below its rescaler, rows at 0 and q - 1, a rescaler of
    q - 1 and at round_at - 1, round_at, round_at + 1), both roundings."""
    jp, tp = params
    jlp0 = jp.lp(LEVEL - 1, False)
    q = _q(jlp0)
    N = jp.N
    rng = np.random.default_rng(0)
    d = _uniform(rng, q, (BATCH, len(q), N))
    round_at = jp.q[LEVEL - 1] // 2
    adv = d[1]
    adv[0, : N // 2] = q[0] - 1
    adv[1:, : N // 4] = 0
    adv[1:, N // 4 : N // 2] = np.minimum(q[1:] - 1, q[0] - 2)[:, None]
    adv[0, N // 2 :] = np.resize(
        np.array([round_at - 1, round_at, round_at + 1, q[0] - 1]), N // 2)
    assert (adv[1:, : N // 2] < adv[0, : N // 2]).all()
    for exact in (True, False):
        got = teng._rescale_core(torch.from_numpy(d),
                                 tp.rescale_scales[LEVEL - 1],
                                 tp.lp(LEVEL, False), round_at, exact)
        want = jeng._rescale_core(_flat(d), jp.rescale_scales[LEVEL - 1],
                                  jp.lp(LEVEL, False), round_at, exact)
        assert _eq(want, torch.cat(list(got), dim=-1))


def test_parts_digits_match_jax_pre_extend(params):
    """G2: every part's digits equal the JAX _pre_extend's, zero-padded
    to amax rows; ``_pre_extend`` of one part is G2 of that part alone."""
    jp, tp = params
    jlp, tlp = jp.lp(LEVEL, False), tp.lp(LEVEL, False)
    parts = tp.parts[LEVEL]
    alphas = [p.alpha for p in parts]
    amax = max(alphas)
    assert 3 in alphas and min(alphas) < amax
    rng = np.random.default_rng(1)
    a = _uniform(rng, _q(jlp), (BATCH, jlp.num_channels, jp.N))
    a[1, :, ::2] = (_q(jlp) - 1)[:, None]
    a[1, :, 1::4] = 0
    st = teng._parts_digits(torch.from_numpy(a), parts, tlp, amax)
    assert tuple(st.shape) == (BATCH, len(parts), amax, jp.N)
    for p, (jpart, part) in enumerate(zip(jp.parts[LEVEL], parts)):
        lo, hi = part.lo, part.hi
        assert not st[:, p, part.alpha :].any()
        want = jeng._pre_extend(_flat(a[:, lo:hi]), jpart, jlp[lo:hi])
        assert _eq(want, torch.cat(list(st[:, p, : part.alpha]), dim=-1))
        one = teng._pre_extend(torch.from_numpy(a[:, lo:hi]), part,
                               tlp[lo:hi])
        assert torch.equal(one, st[:, p, : part.alpha])


def test_pdiv_fused_matches_jax(params, monkeypatch):
    """G3 through ``_pdiv_fused`` (K2 on the special rows, G3, K4) against
    the JAX ``_pdiv_fused`` on the same NTT-domain accumulator, handed to
    it in its u32-pair form; canonical ordinary rows, byte for byte."""
    monkeypatch.setattr(pallas_mxu, "INTERPRET", True)
    jp, tp = params
    jlp_sp = jp.lp(LEVEL, True)
    C_sp = jlp_sp.num_channels
    acc = _uniform(np.random.default_rng(2), 2 * _q(jlp_sp), (C_sp, jp.N))
    fwd = jlp_sp.pmxu_fwd
    u = acc.astype(np.int64).astype(np.uint64)
    pair = tuple(jnp.asarray(h.astype(np.uint32).reshape(C_sp, fwd.P1,
                                                         fwd.P2))
                 for h in (u & 0xFFFFFFFF, u >> 32))
    want = jax.jit(jeng._pdiv_fused, static_argnames="S")(
        pair, jlp_sp, jp.lp(LEVEL, False), jp.PiRs[LEVEL], S=jp.S)
    got = teng._pdiv_fused(torch.from_numpy(acc), tp.lp(LEVEL, True),
                           tp.lp(LEVEL, False), tp.PiRs[LEVEL], tp.S)
    assert _eq(want, got)


def test_engine_glue_goes_through_the_wrappers(params, monkeypatch):
    """``_rescale_core``, ``_parts_digits``, ``_pre_extend`` and
    ``_pdiv_fused`` call the glue wrappers (which launch the kernels on
    the card), once each."""
    _, tp = params
    calls = []
    for name in G.WRAPPERS:
        def counted(*args, _fn=getattr(G, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(G, name, counted)
    lp0, lp1 = tp.lp(LEVEL - 1, False), tp.lp(LEVEL, False)
    lp_sp = tp.lp(LEVEL, True)
    rng = np.random.default_rng(3)
    d = torch.from_numpy(_uniform(rng, lp0.pack.q.numpy(),
                                  (lp0.num_channels, tp.N)))
    teng._rescale_core(d, tp.rescale_scales[LEVEL - 1], lp1,
                       tp.q[LEVEL - 1] // 2)
    parts = tp.parts[LEVEL]
    teng._parts_digits(d[1:], parts, lp1, 3)
    teng._pre_extend(d[1:3], parts[0], lp1[0:2])
    acc = torch.from_numpy(_uniform(rng, lp_sp.pack.q.numpy(),
                                    (lp_sp.num_channels, tp.N)))
    teng._pdiv_fused(acc, lp_sp, lp1, tp.PiRs[LEVEL], tp.S)
    assert calls == ["rescale", "parts_digits", "parts_digits", "pdiv_p0"]


def test_rows_view_refuses_what_the_kernels_do_not_take():
    """The kernels read [B, rows, N] views: contiguous coefficients, rows
    N words apart, one batch stride.  Row slices and batch views pass;
    a transposed operand, a column slice and unfoldable leading
    dimensions are refused (the wrappers raise before any launch)."""
    x = torch.zeros((4, 3, 5, 16), dtype=torch.int64)
    assert G._rows_view(x[..., 1:, :], 4, "x") == (12, 80)
    assert G._rows_view(x[:, 1, 0:1, :], 1, "x") == (4, 240)
    assert G._rows_view(x[0, 0], 5, "x") == (1, 80)
    for bad, rows in ((x.transpose(-1, -2), 16), (x[..., :8], 5),
                      (x.transpose(0, 1), 5), (x[..., ::2, :], 3)):
        with pytest.raises(ValueError):
            G._rows_view(bad, rows, "x")
    with pytest.raises(ValueError):
        G.rescale(x.to("meta")[..., :1, :], x.to("meta")[..., 1:, :], None,
                  None, 0)


def _exact_redc(a, b, q, W):
    return mont.mont_mult_oracle(a, b, q, W)


@pytest.mark.parametrize("W", [62, 30])
def test_half_word_redc_is_exact_below_the_bound(W):
    """The plain versions' half-word REDC (``mont_mult_raw``) equals the
    exact signed REDC of ``csrc/mont.cuh`` for every operand of magnitude
    below 2^W and a constant below q, the largest prime of the lane's
    presets (60 bits, resp. 28): the glue kernels may take either."""
    q = CkksConfig.parse("logN15" if W == 62 else "logN15_30").q
    q = max(q)
    rng = np.random.default_rng(W)
    lim = (1 << W) - 1
    a = [lim, -lim, 0, 1, -1, q - 1, -(q - 1)]
    a += [int(v) for v in rng.integers(-lim, lim, 500, dtype=np.int64)]
    b = [q - 1, 1] + [int(v) for v in rng.integers(0, q, 505,
                                                   dtype=np.int64)]
    pack = mont.ModPack.from_q([q], R_bits=W)
    dt = mont.DTYPES[W]
    got = mont.mont_mult(torch.tensor(a, dtype=dt)[None],
                         torch.tensor(b[: len(a)], dtype=dt)[None], pack)
    want = [_exact_redc(x, y, q, W) for x, y in zip(a, b)]
    assert got[0].tolist() == want


def _part_ranges(P, S, lvl):
    """``CkksParams._build_parts``'s grouping: the ordinary primes [lvl,
    P - 1) in groups aligned to multiples of S, the base prime alone."""
    out, gi = [], lvl // S
    while gi * S < P - 1:
        glo, ghi = max(gi * S, lvl), min((gi + 1) * S, P - 1)
        if ghi > glo:
            out.append((glo, ghi))
        gi += 1
    return out + [(P - 1, P)]


def _garner_operand_bound(m, R):
    """The largest magnitude a REDC operand of ``_pre_extend`` can take on
    canonical residues of the primes ``m``: |REDC(x, c)| < |x| c / R + q
    for a constant c < q; digit i + 1 reduces a[i + 1] - rows[i + 1], and
    rows[r] gathers the reduced digits below it."""
    rows = [m[0]] * len(m)
    worst = 0
    for i in range(len(m) - 1):
        x = m[i + 1] + rows[i + 1]
        y = x * m[i + 1] // R + m[i + 1]
        worst = max(worst, x, y)
        for r in range(i + 2, len(m)):
            rows[r] += y * m[r] // R + m[r]
    return worst


def test_part_ranges_are_the_engines(params):
    jp, tp = params
    for lvl in range(len(tp.parts)):
        assert [(p.lo + lvl, p.hi + lvl) for p in tp.parts[lvl]] == \
            _part_ranges(tp.P, tp.S, lvl)


@pytest.mark.parametrize("preset", [
    "logN14", "logN15", "logN16", "logN17", "logN14_30", "logN15_30",
    "logN16_30", "logN17_30"])
def test_glue_operands_stay_below_the_bound(preset):
    """At every level of every preset, the Garner digits' REDC operands
    stay below 2^62 in the 62-bit lane and 2^30 in the 30-bit lane, as do
    the rescale's differences and the P-division's lazy rows (below
    2q)."""
    cfg = CkksConfig.parse(preset)
    W = cfg.buffer_bit_length
    q = list(cfg.q)
    P, S = cfg.num_scales + 1, cfg.num_special_primes
    worst = max(_garner_operand_bound(q[lo:hi], 1 << W)
                for lvl in range(cfg.num_scales)
                for lo, hi in _part_ranges(P, S, lvl))
    assert worst < 1 << W and 2 * max(q) < 1 << W
