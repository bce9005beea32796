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

import os
import re

import numpy as np
import pytest
import torch

from tiberate_tpu.ops import mont as jmont
from tiberate_tpu.ops import ntt as jntt
from tiberate_tpu.utils.primes import find_the_next_prime
from tiberate_tpu_torch.ops import mont as tmont
from tiberate_tpu_torch.ops import ntt as tntt

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


def _run_pass(lines, table, sched, fwd, pack, layout):
    """The rounds of one pass on lines [C, n_lines, 2^B] in place: gather
    each round's registers, run its butterflies with the twiddle words
    the kernel reads, scatter back (the exchange).  ``layout`` maps a
    line element to its shared-memory word; every exchange must be a
    bijection into one tile."""
    C = lines.shape[0]
    t = np.arange(sched.T)[:, None]
    i = np.arange(sched.R)[None, :]
    ql, qh, kl, kh, _2q = (c.reshape(C, 1, 1, 1) for c in (
        pack.ql, pack.qh, pack.kl, pack.kh, pack._2q))
    for k in range(sched.rounds):
        lo = sched.lo(fwd, k)
        idx = slot(t, i, lo, sched.RL)
        assert sorted(idx.ravel()) == list(range(1 << sched.B))
        if k:
            words = layout(slot(t, i, sched.lo(fwd, k - 1), sched.RL))
            assert len(set(words.ravel())) == words.size
        v = lines[..., torch.from_numpy(idx)]  # [C, lines, T, R]
        for b in sched.bits(fwd, k):
            j = b - lo
            lo_i = [n for n in range(sched.R) if not n & (1 << j)]
            hi_i = [n | (1 << j) for n in lo_i]
            e = idx[:, lo_i]
            tw_word = (1 << (sched.B - 1 - b)) + (e >> (b + 1))
            S = torch.gather(
                table.expand(C, lines.shape[1], -1), 2,
                torch.from_numpy(tw_word.ravel()).expand(
                    C, lines.shape[1], -1)).reshape(
                C, lines.shape[1], *tw_word.shape)
            U, V = v[..., lo_i], v[..., hi_i]
            if fwd:
                V = tmont.mont_mult_raw(S, V, ql, qh, kl, kh)
                a, d = U + V, U + _2q - V
                a = torch.where(a < _2q, a, a - _2q)
                d = torch.where(d < _2q, d, d - _2q)
            else:
                a, d = U + V, U + _2q - V
                a = torch.where(a < _2q, a, a - _2q)
                d = torch.where(d < _2q, d, d - _2q)
                d = tmont.mont_mult_raw(S, d, ql, qh, kl, kh)
            v[..., lo_i], v[..., hi_i] = a, d
        lines[..., torch.from_numpy(idx)] = v


def model_transform(x, tw, pack, logN, lane, fwd):
    """The kernels' transform of x [C, N] (one batch row per channel)."""
    plan = Plan(logN, lane)
    C = x.shape[0]
    grid = x.reshape(C, plan.N1, plan.N2).clone()

    def strided():
        lines = grid.transpose(1, 2).contiguous()  # [C, N2 columns, N1]
        _run_pass(lines, _line_tables(tw, plan, True), plan.S1, fwd, pack,
                  lambda e: e * plan.TC)
        grid.copy_(lines.transpose(1, 2))

    def contig():
        _run_pass(grid, _line_tables(tw, plan, False), plan.S2, fwd, pack,
                  lambda e: e + (e >> PAD_SHIFT))

    for step in ((strided, contig) if fwd else (contig, strided)):
        step()
    return grid.reshape(C, -1)


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
        assert p.S1.rounds <= 3 and p.S2.rounds <= 3
        assert p.S1.RL <= p.L1 and p.S2.RL <= p.L2
        if p.warp2:
            assert 32 % p.TPC == 0 and p.T2 % 32 == 0
        e = np.arange(p.N2)
        assert (e + (e >> PAD_SHIFT)).max() < p.P2
