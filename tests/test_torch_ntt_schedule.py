"""The register-tiled NTT kernels' schedule, modelled on the CPU.

``tiberate_tpu_torch/csrc/ntt.cu`` runs each transform in two passes over
"lines" of 2^B coefficients (``ntt.cuh``, "Register-tiled core"): each
thread holds R words of a line in registers and transforms the bits of one
window per round, the line passing through shared memory between rounds.
This file rebuilds that schedule in numpy from the constants of the CUDA
source (``TT_RLOG``, ``TT_MAX_THREADS``, ...) parsed out of ``ntt.cuh``:
for every round, which element each (thread, register) slot holds, which
twiddle-table word each butterfly takes and which global twiddle fills
that word.  It runs the butterflies through that schedule on seeded
residues and holds the result to ``ops/ntt.py``'s transforms, and at
logN 10 to the JAX package's, bit for bit (tolerance: none, exact integer
arithmetic).  An index fault in the schedule shows here, before a card
runs it.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu.utils.primes import find_the_next_prime
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.context.ntt_context import CkksParams as TParams
from tiberate_tpu_torch.engine import ckks_engine as teng
from tiberate_tpu_torch.ops import mont as tmont
from tiberate_tpu_torch.ops import ntt as tntt
from tiberate_tpu_torch.ops import ntt_kernels as K

torch.set_num_threads(1)

_CUH = os.path.join(os.path.dirname(__file__), os.pardir,
                    "tiberate_tpu_torch", "csrc", "ntt.cuh")
with open(_CUH) as _f:
    CONST = {k: int(v) for k, v in re.findall(
        r"^#define (TT_[A-Z_]+)\s+(\d+)", _f.read(), re.M)}
RLOG, MAX_THREADS = CONST["TT_RLOG"], CONST["TT_MAX_THREADS"]
LINE_BYTES, CONTIG_THREADS = CONST["TT_LINE_BYTES"], CONST["TT_CONTIG_THREADS"]
PAD_SHIFT = CONST["TT_PAD_SHIFT"]
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
WORD = {62: 8, 30: 4}  # bytes of a lane's word
DTYPES = {62: torch.int64, 30: torch.int32}


class Sched:
    """``Sched<B, RL>``: the rounds of a line of 2^B words."""

    def __init__(self, B, RL):
        self.B, self.RL = B, RL
        self.R, self.T = 1 << RL, 1 << (B - RL)
        self.rounds = (B + RL - 1) // RL
        self.nbuf = min(self.rounds - 1, 2)

    def lo(self, fwd, k):
        B, RL = self.B, self.RL
        if fwd:
            return max(B - (k + 1) * RL, 0)
        return k * RL if (k + 1) * RL <= B else B - RL

    def bits(self, fwd, k):
        """The bits round k transforms, in the order it runs them."""
        if fwd:
            return list(range(self.B - 1 - k * self.RL, self.lo(True, k) - 1,
                              -1))
        return list(range(k * self.RL, min((k + 1) * self.RL, self.B)))


def slot(t, i, lo, rl):
    return ((t >> lo) << (lo + rl)) | (i << lo) | (t & ((1 << lo) - 1))


class Plan:
    """``Plan<W, LOGN>``: every launch constant of one transform."""

    def __init__(self, logN, lane):
        w = WORD[lane]
        self.L1 = logN // 2
        self.L2 = logN - self.L1
        self.N1, self.N2 = 1 << self.L1, 1 << self.L2
        self.TC = min(self.N2, LINE_BYTES // w)
        rl1 = min(RLOG, self.L1)
        while (self.TC << (self.L1 - rl1)) > MAX_THREADS:
            rl1 += 1
        self.S1 = Sched(self.L1, rl1)
        self.T1 = self.TC * self.S1.T
        self.smem1 = (self.N1 + self.S1.nbuf * self.N1 * self.TC) * w
        self.S2 = Sched(self.L2, min(RLOG, self.L2))
        self.TPC = self.S2.T
        self.CH = min(self.N1, max(1, CONTIG_THREADS // self.TPC))
        self.T2 = self.CH * self.TPC
        self.P2 = self.N2 + (self.N2 >> PAD_SHIFT)
        self.smem2 = self.CH * (self.N2 + self.S2.nbuf * self.P2) * w
        self.warp2 = self.TPC <= 32 and self.T2 >= 32


def _tables(logN, lane):
    N = 1 << logN
    bits = {62: (60, 40), 30: (28, 25)}[lane]
    qs = [find_the_next_prime(2 ** bits[0] - 1, 2 * N, up=False),
          find_the_next_prime(2 ** bits[1] + 1, 2 * N, up=True)]
    psi, ipsi = tntt.make_psi_tables(qs, logN)
    R = 1 << lane
    mont_form = lambda t: np.array(  # noqa: E731
        [[p * R % q for p in row] for row, q in zip(t, qs)],
        dtype=np.int64 if lane == 62 else np.int32)
    return qs, mont_form(psi), mont_form(ipsi)


def _line_tables(tw, plan, strided):
    """The per-line twiddle table each block stages: [C, lines, 2^B]
    (strided: one table for every column; contiguous: chunk j1's)."""
    if strided:
        return tw[:, None, : plan.N1]
    j = np.arange(1, plan.N2)
    s = np.floor(np.log2(j)).astype(np.int64)
    j1 = np.arange(plan.N1)[:, None]
    src = (1 << (plan.L1 + s)) + (j1 << s) + (j - (1 << s))
    out = torch.zeros((tw.shape[0], plan.N1, plan.N2), dtype=tw.dtype)
    out[..., 1:] = tw[:, torch.from_numpy(src)]
    return out


def _tile_add(a, b, q2):
    """mont.cuh's ``tile_add``: a + b, less 2q where that is >= 2q."""
    s = a + b
    d = s - q2
    return torch.where(d < 0, s, d)


def _tile_sub(a, b, q2):
    """mont.cuh's ``tile_sub``: a - b, plus 2q where that is < 0."""
    d = a - b
    return torch.where(d < 0, d + q2, d)


def _consts(pack, ndim):
    """The pack's (ql, qh, kl, kh, 2q), shaped [C, 1, ..., 1] for lines of
    ``ndim`` dimensions."""
    return tuple(c.reshape(-1, *[1] * (ndim - 1)) for c in (
        pack.ql, pack.qh, pack.kl, pack.kh, pack._2q))


def _redc(a, b, pack, ndim):
    ql, qh, kl, kh, _ = _consts(pack, ndim)
    return tmont.mont_mult_raw(a, b, ql, qh, kl, kh)


def _run_pass(lines, table, sched, fwd, pack, layout, fill=None):
    """The rounds of one pass on lines [C, M, L, 2^B] in place (M lines per
    twiddle table, tables [C, L, 2^B]): gather each round's registers, run
    its butterflies with the twiddle words the kernel reads, scatter back
    (the exchange).  ``fill(v, idx)`` replaces round 0's registers v
    [C, M, L, T, R], gathered at line elements idx [T, R], with what the
    kernel's load forms there (a prologue).  ``layout`` maps a line
    element to its shared-memory word; every exchange must be a bijection
    into one tile."""
    t = np.arange(sched.T)[:, None]
    i = np.arange(sched.R)[None, :]
    ql, qh, kl, kh, _2q = _consts(pack, 5)
    for k in range(sched.rounds):
        lo = sched.lo(fwd, k)
        idx = slot(t, i, lo, sched.RL)
        assert sorted(idx.ravel()) == list(range(1 << sched.B))
        if k:
            words = layout(slot(t, i, sched.lo(fwd, k - 1), sched.RL))
            assert len(set(words.ravel())) == words.size
        v = lines[..., torch.from_numpy(idx)]  # [C, M, L, T, R]
        if k == 0 and fill is not None:
            v = fill(v, idx)
        for b in sched.bits(fwd, k):
            j = b - lo
            lo_i = [n for n in range(sched.R) if not n & (1 << j)]
            hi_i = [n | (1 << j) for n in lo_i]
            e = idx[:, lo_i]
            tw_word = (1 << (sched.B - 1 - b)) + (e >> (b + 1))
            S = table[:, None, :, torch.from_numpy(tw_word)]  # [C,1,L,T,R/2]
            U, V = v[..., lo_i], v[..., hi_i]
            if fwd:
                V = tmont.mont_mult_raw(S, V, ql, qh, kl, kh)
                a, d = _tile_add(U, V, _2q), _tile_sub(U, V, _2q)
            else:
                a, d = _tile_add(U, V, _2q), _tile_sub(U, V, _2q)
                d = tmont.mont_mult_raw(S, d, ql, qh, kl, kh)
            v[..., lo_i], v[..., hi_i] = a, d
        lines[..., torch.from_numpy(idx)] = v


def _strided(grid, tw, plan, fwd, pack, fill=None):
    """The strided pass on grid [C, M, N1, N2] in place: each column is a
    line, all under the row's N1 twiddles."""
    C, M = grid.shape[:2]
    lines = grid.transpose(-1, -2).reshape(C, M * plan.N2, 1, plan.N1).clone()
    _run_pass(lines, _line_tables(tw, plan, True), plan.S1, fwd, pack,
              lambda e: e * plan.TC, fill)
    grid.copy_(lines.reshape(C, M, plan.N2, plan.N1).transpose(-1, -2))


def _contig(grid, table, plan, fwd, pack):
    """The contiguous pass on grid [C, M, N1, N2] in place: chunk j1 of
    every row under its table (``table`` [C, N1, N2], staged once)."""
    _run_pass(grid, table, plan.S2, fwd, pack,
              lambda e: e + (e >> PAD_SHIFT))


def model_transform(x, tw, pack, logN, lane, fwd):
    """The kernels' transform of x [C, N] (one batch row per channel)."""
    plan = Plan(logN, lane)
    C = x.shape[0]
    grid = x.reshape(C, 1, plan.N1, plan.N2).clone()
    table = _line_tables(tw, plan, False)
    if fwd:
        _strided(grid, tw, plan, True, pack)
        _contig(grid, table, plan, True, pack)
    else:
        _contig(grid, table, plan, False, pack)
        _strided(grid, tw, plan, False, pack)
    return grid.reshape(C, -1)


def _last_window_is_consecutive(plan):
    """After a forward contiguous pass thread t holds words tR .. tR+R-1
    (what the kernels' 16-byte key loads and stores assume)."""
    S2 = plan.S2
    t = np.arange(S2.T)[:, None]
    i = np.arange(S2.R)[None, :]
    got = slot(t, i, S2.lo(True, S2.rounds - 1), S2.RL)
    return np.array_equal(got, t * S2.R + i)


def _fold_redc(s, q, k, signed):
    """K6's one reduction of exact sums ``s`` (numpy object arrays, q and
    k broadcast against them): the high word H folded as H (2^64 mod q)
    + the low word, then its REDC, (x + m q) / 2^62 (``mont.cuh``: "Sums
    of products"); a signed sum's negative results take +q."""
    f = (1 << 64) % q
    x = (s >> 64) * f + (s & ((1 << 64) - 1))
    r = _exact_redc(x, q, k)
    return np.where(r < 0, r + q, r) if signed else r


def _exact_redc(x, q, k):
    """(x + m q) / 2^62, m = (x mod 2^62) k mod 2^62, on object arrays."""
    mask = (1 << 62) - 1
    return (x + ((x & mask) * k & mask) * q) >> 62


def _objects(t):
    return t.numpy().astype(object)


def model_keymul_parts(st, ec, alphas, keys, lp_sp, lane):
    """K6 as ``csrc/keyswitch.cu`` runs it, for st [B, n_parts, amax, N].

    Pass 1: each strided slot loads its digits of the part's alpha_p rows
    and forms the extension in registers, then the strided rounds run:
    in the 30-bit lane REDC(st_0 Rs) (+) sum_i REDC(st_i L_enter_i), in
    the 62-bit lane the exact sum of st_i L_enter_i (st_0 Rs first)
    reduced once into [0, 2q) (a part of alpha 1: its one REDC, brought
    into [0, 2q)).  Pass 2: one twiddle table per chunk for all parts;
    each part's chunk runs the contiguous rounds, in part order, and its
    two key products go into two accumulators: in the 30-bit lane REDCs
    added lazily from part 0's, in the 62-bit lane exact sums reduced
    once after the last part.  Part p's keys are read where ``keys[p]``
    = (k0, k1) lie, as the kernel reads them through its per-part
    pointer tables.  Returns the two accumulators [B, C_sp, N]."""
    B, n_parts, amax, N = st.shape
    if lane == 62:
        # the toys' sums run whole: one reduction a sum, no fold
        assert amax <= lp_sp.sum_runs[0] and n_parts <= lp_sp.sum_runs[1]
    plan = Plan(N.bit_length() - 1, lane)
    pk = lp_sp.pack
    C, M = pk.num_channels, B * n_parts
    assert _last_window_is_consecutive(plan)
    # the digit rows of every (b, p), as the strided pass's lines
    dig = st.reshape(M, amax, plan.N1, plan.N2).transpose(-1, -2).reshape(
        1, M, amax, plan.N2, 1, plan.N1)
    # ec [n_parts, C_sp, amax] -> the constant of each (c, b, p)
    cst = ec.permute(1, 0, 2)[:, None].expand(C, B, n_parts, amax).reshape(
        C, M, 1, 1, 1, 1, amax)
    active = (torch.arange(amax)[None, :]
              < alphas.repeat(B).long()[:, None])  # [M, amax]
    active = active.reshape(1, M, 1, 1, 1, 1, amax)
    q2 = _consts(pk, 6)[-1]
    qo = _objects(pk.q).reshape(C, 1, 1, 1, 1, 1)
    ko = _objects(pk.k).reshape(C, 1, 1, 1, 1, 1)

    def fill(v, idx):
        d = dig[..., torch.from_numpy(idx)]  # [1, M, amax, N2, 1, T, R]
        d = d.movedim(2, -1)  # [1, M, N2, 1, T, R, amax]
        if lane == 62:
            # digits and constants are zero past alpha: the sum runs over
            # amax; a part of alpha 1 keeps its one REDC
            prods = _objects(d) * _objects(cst)
            one = _exact_redc(prods[..., 0], qo, ko)
            one = np.where(one < 0, one + 2 * qo,
                           np.where(one < 2 * qo, one, one - 2 * qo))
            ext = _fold_redc(prods.sum(axis=-1), qo, ko, signed=True)
            single = (alphas.repeat(B) == 1).numpy().reshape(1, M, 1, 1, 1,
                                                             1)
            ext = np.where(single, one, ext)
            return torch.from_numpy(ext.astype(np.int64)).reshape(v.shape)
        prods = [_redc(d[..., a], cst[..., a], pk, 6) for a in range(amax)]
        ext = prods[0]
        for a in range(1, amax):
            ext = torch.where(active[..., a], _tile_add(ext, prods[a], q2),
                              ext)
        return ext.reshape(v.shape)

    tmp = torch.zeros((C, M, plan.N1, plan.N2), dtype=st.dtype)
    _strided(tmp, lp_sp.psi, plan, True, pk, fill)
    tmp = tmp.reshape(C, B, n_parts, plan.N1, plan.N2)
    table = _line_tables(lp_sp.psi, plan, False)
    acc = [None, None]
    for p in range(n_parts):
        X = tmp[:, :, p].clone()  # [C, B, N1, N2]
        _contig(X, table, plan, True, pk)
        for j in range(2):
            key = keys[p][j].reshape(C, 1, plan.N1, plan.N2)
            if lane == 62:
                prod = _objects(X) * _objects(key)
                acc[j] = prod if p == 0 else acc[j] + prod
                continue
            prod = _redc(X, key, pk, 4)
            acc[j] = prod if p == 0 else _tile_add(acc[j], prod,
                                                   _consts(pk, 4)[-1])
    if lane == 62:
        qo, ko = (_objects(t).reshape(C, 1, 1, 1) for t in (pk.q, pk.k))
        acc = [torch.from_numpy(_fold_redc(a, qo, ko, signed=False).astype(
            np.int64)) for a in acc]
    return tuple(a.reshape(C, B, N).transpose(0, 1) for a in acc)


def model_tensor(x0, x1, y0, y1, lp, lane):
    """K5 as ``csrc/tensor.cu`` runs it, for four [B, C, N] inputs.

    Pass 1: one strided launch over the four inputs, the x R entry in the
    load.  Pass 2: one twiddle table per chunk; the four lines run the
    contiguous rounds one after another, then d0 = REDC(X0 Y0), d1 =
    REDC(X0 Y1) (+) REDC(X1 Y0), d2 = REDC(X1 Y1).  Returns (d0, d1, d2)."""
    B, C, N = x0.shape
    plan = Plan(N.bit_length() - 1, lane)
    pk = lp.pack
    assert _last_window_is_consecutive(plan)
    grid = torch.stack([x0, x1, y0, y1]).permute(2, 0, 1, 3).reshape(
        C, 4 * B, plan.N1, plan.N2).clone()
    Rs = lp.Rs.reshape(C, 1, 1, 1, 1)
    _strided(grid, lp.psi, plan, True, pk,
             lambda v, idx: _redc(v, Rs, pk, 5))
    table = _line_tables(lp.psi, plan, False)
    lines = []
    for z in range(4):
        X = grid.reshape(C, 4, B, plan.N1, plan.N2)[:, z].clone()
        _contig(X, table, plan, True, pk)
        lines.append(X)
    X0, X1, Y0, Y1 = lines
    q2 = _consts(pk, 4)[-1]
    d = (_redc(X0, Y0, pk, 4),
         _tile_add(_redc(X0, Y1, pk, 4), _redc(X1, Y0, pk, 4), q2),
         _redc(X1, Y1, pk, 4))
    return tuple(t.reshape(C, B, N).transpose(0, 1) for t in d)


def _inputs(logN, lane, seed):
    qs, psi, ipsi = _tables(logN, lane)
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, 2 * q, size=1 << logN, dtype=np.int64)
                  for q in qs]).astype(psi.dtype)
    return qs, x, psi, ipsi


@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("lane", [62, 30])
@pytest.mark.parametrize("logN", [4, 7, 10, 15, 17])
def test_schedule_matches_plain_transform(logN, lane, fwd):
    """The schedule's transform equals ops/ntt.py's ``ntt`` (forward) or
    ``intt_core`` (inverse, before x N^-1) bit for bit."""
    qs, x, psi, ipsi = _inputs(logN, lane, seed=logN)
    pack = tmont.ModPack.from_q(qs, R_bits=lane)
    tx = torch.from_numpy(x)
    if fwd:
        want = tntt.ntt(tx, torch.from_numpy(psi), pack)
    else:
        want = tntt.intt_core(tx, torch.from_numpy(ipsi), pack)
    got = model_transform(tx, torch.from_numpy(psi if fwd else ipsi), pack,
                          logN, lane, fwd)
    assert got.dtype == DTYPES[lane]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("lane", [62, 30])
def test_schedule_matches_jax_transform(lane, fwd):
    """At logN 10 the schedule's transform equals the JAX package's
    ``tiberate_tpu.ops.ntt`` on the CPU, bit for bit."""
    logN = 10
    qs, x, psi, ipsi = _inputs(logN, lane, seed=99)
    jpack = jmont.ModPack.from_q(qs, R_bits=lane)
    tpack = tmont.ModPack.from_q(qs, R_bits=lane)
    want = np.asarray(jntt.ntt(x, psi, jpack) if fwd
                      else jntt.intt_core(x, ipsi, jpack))
    got = model_transform(torch.from_numpy(x),
                          torch.from_numpy(psi if fwd else ipsi), tpack,
                          logN, lane, fwd)
    assert want.dtype == got.numpy().dtype
    assert np.array_equal(want, got.numpy())


@functools.lru_cache(maxsize=None)
def _toy(logN, lane, S):
    """A toy parameter set: S special primes (S = 6: parts of alpha up to
    6, as logN17's); 25-bit scales for the 30-bit lane at logN >= 15."""
    if lane == 62:
        opts = dict(scale_bits=30)
    else:
        opts = dict(scale_bits=21 if logN < 15 else 25, buffer_bit_length=30)
    return TParams(toy_config(logN=logN, num_scales=4 if S == 2 else 14,
                              num_special_primes=S, **opts), "cpu")


def _residues(rng, pack, shape):
    """Uniform residues [..., C, N] of the pack's channels, its dtype."""
    q = [int(v) for v in pack.q.reshape(-1)]
    x = np.stack([rng.integers(0, qi, size=shape[:-2] + (shape[-1],))
                  for qi in q], axis=-2)
    return torch.from_numpy(x).to(pack.dtype)


# (logN, special primes) of the K5 / K6 cases; batch 2 below logN15
STEP_CASES = [(4, 2), (7, 2), (10, 2), (10, 6), (15, 2), (17, 2)]


@pytest.mark.parametrize("lane", [62, 30])
@pytest.mark.parametrize("logN,S", STEP_CASES)
def test_parts_schedule_matches_plain(logN, S, lane):
    """K6's two passes, modelled (the extension in the strided slots, one
    twiddle table for every part, register accumulators in part order),
    equal ``ntt_keymul_parts_plain``: bit for bit in the 30-bit lane; in
    the 62-bit lane, whose sums are exact and reduced once, residue for
    residue with every word in [0, 2q)."""
    tp = _toy(logN, lane, S)
    lp, lp_sp = tp.lp(1, False), tp.lp(1, True)
    rng = np.random.default_rng(1000 + logN)
    B, N = (2 if logN < 15 else 1), 1 << logN
    ec, alphas = teng._parts_consts(tp, 1)
    x = _residues(rng, lp.pack, (B, lp.num_channels, N))
    st = teng._parts_digits(x, tp.parts[1], lp, ec.shape[-1]).contiguous()
    # each part's (k0, k1): the level-1 rows of a level-0 key, in place
    full = tp.lp(0, True).pack
    keys = tuple(tuple(_residues(rng, full, (full.num_channels, N))[1:]
                       for _ in range(2))
                 for _ in range(ec.shape[0]))
    want = K.ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp)
    got = model_keymul_parts(st, ec, alphas, keys, lp_sp, lane)
    q = lp_sp.pack.q.long()[:, None]
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[lane]
        if lane == 30:
            assert torch.equal(g, w)
            continue
        assert bool(((g >= 0) & (g < 2 * q)).all())
        assert torch.equal(g % q, w % q)


@pytest.mark.parametrize("lane", [62, 30])
@pytest.mark.parametrize("logN,S", STEP_CASES)
def test_tensor_schedule_matches_plain(logN, S, lane):
    """K5's two passes, modelled (one strided launch over the four inputs
    with the x R entry, four lines a chunk under one table, the products),
    equal ``ntt_tensor_plain`` bit for bit."""
    lp = _toy(logN, lane, S).lp(1, False)
    rng = np.random.default_rng(2000 + logN)
    shape = ((2 if logN < 15 else 1), lp.num_channels, 1 << logN)
    xs = [_residues(rng, lp.pack, shape) for _ in range(4)]
    want = K.ntt_tensor_plain(*xs, lp)
    got = model_tensor(*xs, lp, lane)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[lane]
        assert torch.equal(g, w)


def _buffers_reused_safely(sched, barrier_at_end):
    """Several lines run one after another through one pair of exchange
    buffers (K5's four lines, K6's parts): every write of a buffer must
    follow a barrier that follows the last read of it.  Exchange k of a
    line writes buffer (k - 1) & 1, syncs, reads it back."""
    events = []
    for _ in range(3):
        for k in range(1, sched.rounds):
            b = (k - 1) & 1
            events += [("w", b), ("sync", None), ("r", b)]
        if barrier_at_end:
            events.append(("sync", None))
    last_read, synced = {}, {}
    for n, (kind, b) in enumerate(events):
        if kind == "sync":
            synced = {buf: True for buf in last_read}
        elif kind == "r":
            last_read[b], synced[b] = n, False
        elif b in last_read and not synced[b]:
            return False
    return True


@pytest.mark.parametrize("lane", [62, 30])
def test_plans_fit_the_card(lane):
    """Every size the wrappers accept (logN 4..17) launches blocks the
    card takes: at most MAX_THREADS threads and 227 KB of shared memory;
    the grids cover every column and chunk once; a warp-synced chunk lies
    within one warp; the contiguous tile's padded words stay inside it."""
    for logN in range(4, 18):
        p = Plan(logN, lane)
        assert p.N2 % p.TC == 0 and p.N1 % p.CH == 0
        assert p.T1 <= MAX_THREADS and p.T2 <= MAX_THREADS
        assert max(p.smem1, p.smem2) <= SMEM_LIMIT
        # K5's pass 2 keeps two transformed lines beside the chunks
        assert p.smem2 + 2 * p.T2 * p.S2.R * WORD[lane] <= SMEM_LIMIT
        assert p.S1.rounds <= 3 and p.S2.rounds <= 3
        assert p.S1.RL <= p.L1 and p.S2.RL <= p.L2
        if p.warp2:
            assert 32 % p.TPC == 0 and p.T2 % 32 == 0
        e = np.arange(p.N2)
        assert (e + (e >> PAD_SHIFT)).max() < p.P2
        # fwd_chunk ends a line with a barrier only where its rounds use
        # one buffer; without it two rounds would race, three never do
        assert _buffers_reused_safely(p.S2, p.S2.rounds == 2)
        assert _buffers_reused_safely(p.S2, False) == (p.S2.rounds != 2)
