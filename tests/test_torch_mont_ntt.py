"""tiberate_tpu_torch host layer and plain ops against the JAX package.

Same numpy-drawn inputs go through the jnp function and its torch twin.
Tolerance: none — everything is exact integer arithmetic, so every output
must be byte-identical (lazy [0, 2q) and signed representatives included).
"""

import json
import os

import numpy as np
import pytest
import torch

from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu_torch.ops import mont as tmont
from tiberate_tpu_torch.ops import ntt as tntt

torch.set_num_threads(1)

Q_LIST = [
    1152921504606844513,  # ~2^60 message-prime-like
    1099510054913,  # ~2^40 scale-prime-like
    576460752303421441,
]
R = 1 << 62


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


def _packs(qs):
    return jmont.ModPack.from_q(qs), tmont.ModPack.from_q(qs)


def _draw(qs, n, rng, lo_frac, hi_frac):
    return np.stack([
        rng.integers(int(lo_frac * q), int(hi_frac * q), size=n,
                     dtype=np.int64)
        for q in qs
    ])


@pytest.mark.parametrize("lo_frac,hi_frac", [(0.0, 2.0), (-1.0, 2.0),
                                             (-2.0, 2.0)])
def test_mont_ops_match_jnp(lo_frac, hi_frac):
    """mont_mult/enter/reduce/add/sub/reduce_2q/make_(un)signed on
    unsigned and signed representatives."""
    rng = np.random.default_rng(0)
    jp, tp = _packs(Q_LIST)
    a = _draw(Q_LIST, 4096, rng, lo_frac, hi_frac)
    b = _draw(Q_LIST, 4096, rng, 0.0, 2.0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    Rs = np.array([[R * R % q] for q in Q_LIST], dtype=np.int64)
    pairs = [
        (jmont.mont_mult(a, b, jp), tmont.mont_mult(ta, tb, tp)),
        (jmont.mont_mult(b, a, jp), tmont.mont_mult(tb, ta, tp)),
        (jmont.mont_enter(a, Rs, jp),
         tmont.mont_enter(ta, torch.from_numpy(Rs), tp)),
        (jmont.mont_reduce(a, jp), tmont.mont_reduce(ta, tp)),
        (jmont.mont_add(a, b, jp), tmont.mont_add(ta, tb, tp)),
        (jmont.mont_sub(a, b, jp), tmont.mont_sub(ta, tb, tp)),
        (jmont.reduce_2q(a, jp), tmont.reduce_2q(ta, tp)),
        (jmont.make_signed(a, jp), tmont.make_signed(ta, tp)),
        (jmont.make_unsigned(a, jp), tmont.make_unsigned(ta, tp)),
    ]
    for j, t in pairs:
        assert _eq(j, t)


def test_mont_mult_equals_exact_redc():
    """The 31-bit-half REDC equals the exact 128-bit Montgomery reduction
    the CUDA kernels compute (csrc/mont.cuh), on signed operands too."""
    rng = np.random.default_rng(1)
    _, tp = _packs(Q_LIST)
    a = _draw(Q_LIST, 256, rng, -2.0, 2.0)
    b = _draw(Q_LIST, 256, rng, -1.0, 1.0)
    got = tmont.mont_mult(torch.from_numpy(a), torch.from_numpy(b), tp)
    for c, q in enumerate(Q_LIST):
        want = [tmont.mont_mult_oracle(int(x), int(y), q)
                for x, y in zip(a[c], b[c])]
        assert got[c].tolist() == want


def test_tile_unsigned_matches_jnp():
    rng = np.random.default_rng(2)
    jp, tp = _packs(Q_LIST)
    x = rng.integers(-1000, 1000, size=(3, 64), dtype=np.int64)
    assert _eq(jmont.tile_unsigned(x, jp),
               tmont.tile_unsigned(torch.from_numpy(x), tp))


def _tables(logN, qs):
    psi, ipsi = tntt.make_psi_tables(qs, logN)
    jpsi, jipsi = jntt.make_psi_tables(qs, logN)
    assert psi == jpsi and ipsi == jipsi
    mont_form = lambda t: np.array(  # noqa: E731
        [[p * R % q for p in row] for row, q in zip(t, qs)], dtype=np.int64)
    N = 1 << logN
    Ninv = np.array([[pow(N, -1, q) * R % q] for q in qs], dtype=np.int64)
    Rs = np.array([[R * R % q] for q in qs], dtype=np.int64)
    return mont_form(psi), mont_form(ipsi), Ninv, Rs


@pytest.mark.parametrize("signed", [False, True])
def test_ntt_family_matches_jnp(signed):
    """ntt (signed path too), intt_core, intt, enter_ntt, intt_exit,
    intt_exit_reduce, on a batch of [C, N] polynomials."""
    from tiberate_tpu.utils.primes import find_the_next_prime

    logN = 7
    N = 1 << logN
    qs = [find_the_next_prime(2**60 - 1, 2 * N, up=False),
          find_the_next_prime(2**40 + 1, 2 * N, up=True)]
    jp, tp = _packs(qs)
    psi, ipsi, Ninv, Rs = _tables(logN, qs)
    rng = np.random.default_rng(3)
    lo = -0.5 if signed else 0.0
    x = np.stack([_draw(qs, N, rng, lo, 2.0) for _ in range(2)])
    u = np.stack([_draw(qs, N, rng, 0.0, 1.0) for _ in range(2)])
    t = torch.from_numpy
    tx, tu = t(x), t(u)
    tpsi, tipsi, tNinv, tRs = t(psi), t(ipsi), t(Ninv), t(Rs)
    assert _eq(jntt.ntt(x, psi, jp, signed=signed),
               tntt.ntt(tx, tpsi, tp, signed=signed))
    assert _eq(jntt.intt_core(x, ipsi, jp), tntt.intt_core(tx, tipsi, tp))
    assert _eq(jntt.intt(x, ipsi, Ninv, jp),
               tntt.intt(tx, tipsi, tNinv, tp))
    assert _eq(jntt.intt_exit(x, ipsi, Ninv, jp),
               tntt.intt_exit(tx, tipsi, tNinv, tp))
    assert _eq(jntt.intt_exit_reduce(x, ipsi, Ninv, jp),
               tntt.intt_exit_reduce(tx, tipsi, tNinv, tp))
    assert _eq(jntt.enter_ntt(u, Rs, psi, jp),
               tntt.enter_ntt(tu, tRs, tpsi, tp))


@pytest.mark.parametrize("preset", ["logN14", "logN15", "logN16"])
def test_prime_chains_match_golden(preset):
    """The port's own prime mining and caches give the pinned chains."""
    from tiberate_tpu_torch.config import CkksConfig

    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "presets.json")) as f:
        golden = json.load(f)[preset]
    cfg = CkksConfig.parse(preset)
    assert [int(x) for x in cfg.q] == golden["q"]
    assert cfg.num_special_primes == golden["num_special_primes"]
    assert cfg.scale_bits == golden["scale_bits"]


def test_params_match_jnp():
    """CkksParams tables and constants equal the JAX package's at a toy
    size, for every field the slice reads."""
    from tiberate_tpu.config.toy import toy_config
    from tiberate_tpu.context.ntt_context import CkksParams as JParams
    from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams

    cfg = toy_config(logN=7, num_scales=4, num_special_primes=2,
                     scale_bits=30)
    jp, tp = JParams(cfg), TParams(cfg, "cpu")
    for name in ("psi", "ipsi", "Ninv", "Rs", "Rs_scale", "mont_PR"):
        assert _eq(getattr(jp, name), getattr(tp, name)), name
    for lvl in range(jp.num_levels):
        assert _eq(jp.rescale_scales[lvl], tp.rescale_scales[lvl])
        assert _eq(jp.final_scalar[lvl], tp.final_scalar[lvl])
        for a, b in zip(jp.PiRs[lvl], tp.PiRs[lvl]):
            assert _eq(a, b)
        assert jp.parts_alloc[lvl] == tp.parts_alloc[lvl]
        for pj, pt in zip(jp.parts[lvl], tp.parts[lvl]):
            assert (pj.lo, pj.hi, pj.g0) == (pt.lo, pt.hi, pt.g0)
            if pj.alpha > 1:
                assert _eq(pj.Y_scalar, pt.Y_scalar)
                assert _eq(pj.L_enter, pt.L_enter)
    assert jp.corrections == tp.corrections
    assert _eq(jp.pack.ql, tp.pack.ql)


def test_cdt_matches_jax_tree():
    """The port's sorted CDT holds exactly the 128-bit node values of the
    JAX package's CDT search tree (sigma 3.2: nodes cdt[1..31])."""
    from tiberate_tpu.rng.discrete_gaussian_sampler import (
        build_CDT_binary_search_tree,
    )
    from tiberate_tpu_torch.rng.discrete_gaussian_sampler import build_CDT

    btree, size, _ = build_CDT_binary_search_tree(128, 3.2)
    tree = sorted(int(lo) | (int(hi) << 64) for lo, hi in btree)
    cdt = build_CDT(128, 3.2)
    assert cdt[0] == 0 and cdt == sorted(cdt)
    assert cdt[1 : size + 1] == tree
