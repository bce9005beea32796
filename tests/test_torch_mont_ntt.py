"""tiberate_tpu_torch host layer and plain ops against the JAX package.

Same numpy-drawn inputs go through the jnp function and its torch twin, in
both lanes: the 62-bit mode (int64, R = 2^62) and the 30-bit mode (int32,
R = 2^30, q < 2^28; the moduli of ``tests/test_mode30.py``).  Tolerance:
none — everything is exact integer arithmetic, so every output must be
byte-identical (lazy [0, 2q) and signed representatives included) and of
the lane's dtype.
"""

import json
import os

import numpy as np
import pytest
import torch

from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu.utils.primes import find_the_next_prime
from tiberate_tpu_torch.ops import mont as tmont
from tiberate_tpu_torch.ops import ntt as tntt

torch.set_num_threads(1)

# lane (R bits) -> moduli
Q_LISTS = {
    62: [
        1152921504606844513,  # ~2^60 message-prime-like
        1099510054913,  # ~2^40 scale-prime-like
        576460752303421441,
    ],
    30: [  # tests/test_mode30.py's 30-bit pack: a 28-bit and a 25-bit prime
        find_the_next_prime(2**28 - 1, 2 * 256, up=False),
        find_the_next_prime(2**25 + 1, 2 * 256, up=True),
    ],
}
DTYPES = {62: np.int64, 30: np.int32}
LANES = sorted(Q_LISTS)


def _eq(j, t):
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def _packs(qs, lane=62):
    return (jmont.ModPack.from_q(qs, R_bits=lane),
            tmont.ModPack.from_q(qs, R_bits=lane))


def _draw(qs, n, rng, lo_frac, hi_frac, lane=62):
    return np.stack([
        rng.integers(int(lo_frac * q), int(hi_frac * q), size=n,
                     dtype=np.int64)
        for q in qs
    ]).astype(DTYPES[lane])


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("lo_frac,hi_frac", [(0.0, 2.0), (-1.0, 2.0),
                                             (-2.0, 2.0)])
def test_mont_ops_match_jnp(lo_frac, hi_frac, lane):
    """mont_mult/enter/reduce/add/sub/reduce_2q/make_(un)signed on
    unsigned and signed representatives (in the 30-bit lane, signed a in
    (-2^29, 2^29))."""
    rng = np.random.default_rng(0)
    qs = Q_LISTS[lane]
    jp, tp = _packs(qs, lane)
    a = _draw(qs, 4096, rng, lo_frac, hi_frac, lane)
    b = _draw(qs, 4096, rng, 0.0, 2.0, lane)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    R = 1 << lane
    Rs = np.array([[R * R % q] for q in qs], dtype=DTYPES[lane])
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


@pytest.mark.parametrize("lane", LANES)
def test_mont_mult_equals_exact_redc(lane):
    """The half-word REDC equals the exact Montgomery reduction the CUDA
    kernels compute (csrc/mont.cuh: in 128 bits at R = 2^62, with one
    64-bit product at R = 2^30), on signed operands too."""
    rng = np.random.default_rng(1)
    qs = Q_LISTS[lane]
    _, tp = _packs(qs, lane)
    a = _draw(qs, 256, rng, -2.0, 2.0, lane)
    b = _draw(qs, 256, rng, -1.0, 1.0, lane)
    got = tmont.mont_mult(torch.from_numpy(a), torch.from_numpy(b), tp)
    for c, q in enumerate(qs):
        want = [tmont.mont_mult_oracle(int(x), int(y), q, R_bits=lane)
                for x, y in zip(a[c], b[c])]
        assert got[c].tolist() == want


@pytest.mark.parametrize("lane", LANES)
def test_tile_unsigned_matches_jnp(lane):
    """Signed int64 draws (sampler, codec) into the lane's residues."""
    rng = np.random.default_rng(2)
    jp, tp = _packs(Q_LISTS[lane], lane)
    x = rng.integers(-1000, 1000, size=(3, 64), dtype=np.int64)
    assert _eq(jmont.tile_unsigned(x, jp),
               tmont.tile_unsigned(torch.from_numpy(x), tp))


def _tables(logN, qs, lane):
    psi, ipsi = tntt.make_psi_tables(qs, logN)
    jpsi, jipsi = jntt.make_psi_tables(qs, logN)
    assert psi == jpsi and ipsi == jipsi
    R, dt = 1 << lane, DTYPES[lane]
    mont_form = lambda t: np.array(  # noqa: E731
        [[p * R % q for p in row] for row, q in zip(t, qs)], dtype=dt)
    N = 1 << logN
    Ninv = np.array([[pow(N, -1, q) * R % q] for q in qs], dtype=dt)
    Rs = np.array([[R * R % q] for q in qs], dtype=dt)
    return mont_form(psi), mont_form(ipsi), Ninv, Rs


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("signed", [False, True])
def test_ntt_family_matches_jnp(signed, lane):
    """ntt (signed path too), intt_core, intt, enter_ntt, intt_exit,
    intt_exit_reduce, on a batch of [C, N] polynomials."""
    logN = 7
    N = 1 << logN
    bits = {62: (60, 40), 30: (28, 25)}[lane]
    qs = [find_the_next_prime(2 ** bits[0] - 1, 2 * N, up=False),
          find_the_next_prime(2 ** bits[1] + 1, 2 * N, up=True)]
    jp, tp = _packs(qs, lane)
    psi, ipsi, Ninv, Rs = _tables(logN, qs, lane)
    rng = np.random.default_rng(3)
    lo = -0.5 if signed else 0.0
    x = np.stack([_draw(qs, N, rng, lo, 2.0, lane) for _ in range(2)])
    u = np.stack([_draw(qs, N, rng, 0.0, 1.0, lane) for _ in range(2)])
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


@pytest.mark.parametrize("lane", LANES)
def test_params_match_jnp(lane):
    """CkksParams tables and constants equal the JAX package's at a toy
    size, for every field the slice reads, in the lane's dtype."""
    from tiberate_tpu.config.toy import toy_config
    from tiberate_tpu.context.ntt_context import CkksParams as JParams
    from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams

    cfg = toy_config(logN=7, num_scales=4, num_special_primes=2,
                     scale_bits={62: 30, 30: 21}[lane],
                     buffer_bit_length=lane)
    jp, tp = JParams(cfg), TParams(cfg, "cpu")
    assert tp.pdc.dtype == tp.pack.q.dtype == tp.dtype
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


def test_negacyclic_ntt_oracle_matches_jax():
    """The O(N^2) oracle at logN 4 with a toy prime (q = 1 mod 32) on
    seeded coefficients, against the JAX package's, and the negacyclic
    product it diagonalises."""
    q, logN = 97, 4
    rng = np.random.default_rng(76)
    a, b = (rng.integers(0, q, 1 << logN).tolist() for _ in range(2))
    got = tntt.negacyclic_ntt_oracle(a, q, logN)
    assert got == jntt.negacyclic_ntt_oracle(a, q, logN)
    N = 1 << logN
    prod = [0] * N
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            k, sgn = (i + j) % N, (-1 if i + j >= N else 1)
            prod[k] = (prod[k] + sgn * x * y) % q
    fb = tntt.negacyclic_ntt_oracle(b, q, logN)
    assert tntt.negacyclic_ntt_oracle(prod, q, logN) == [
        x * y % q for x, y in zip(got, fb)]


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("extra_dims", [0, 1, 2])
def test_modpack_expand_matches_jax(lane, extra_dims):
    """``ModPack.expand``: each [C, 1] column gains ``extra_dims``
    singleton dims, with the JAX pack's shapes and values; the flat q and
    k the kernels read stay [C]."""
    jp, tp = _packs(Q_LISTS[lane], lane)
    je, te = jp.expand(extra_dims), tp.expand(extra_dims)
    if extra_dims == 0:
        assert te is tp
    for f in ("ql", "qh", "kl", "kh", "_2q"):
        assert getattr(te, f).shape == getattr(je, f).shape
        assert _eq(getattr(je, f), getattr(te, f))
    assert te.q.shape == te.k.shape == (len(Q_LISTS[lane]),)
