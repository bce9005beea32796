"""Coefficient-axis-sharded negacyclic NTT over a mesh axis.

The torch counterpart of ``tiberate_tpu/parallel/coef_sharded.py``.  The N
axis is sharded contiguously over D = 2^d shards.  The first d
Cooley-Tukey stages pair elements across shards: partner blocks are
exchanged by :func:`mesh.ppermute` and both sides compute their half
(torch ops, twiddles from :func:`_cross_stage_twiddle`):

    stage s < d:   partner = shard ^ (D >> (s + 1))

Every later stage is shard-local, and runs on the Hopper kernels unchanged
at logN - d.  At a local stage with m' groups a shard, shard i reads the
twiddle ``psi[(D + i) m' + j']`` for its group j', so the table
``psi_i[m' + j'] = psi[(D + i) m' + j']`` (:func:`local_table`) makes the
local stages an ordinary transform of N/D points: K1 (``ntt``), K3 and K5
run them with that table.  The inverse mirrors the schedule: K2 runs the
local Gentleman-Sande stages with ``ipsi_i`` and its N^-1 fold set to R
(a Montgomery multiply by R is the identity, bit for bit, in both lanes),
then the cross stages run in reverse and N^-1 is folded in last.  The
outputs are the unsharded ``ops.ntt`` bytes, lazy representatives
included.
"""

import dataclasses

import torch

from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.parallel import mesh as meshlib


def _log2(D: int) -> int:
    d = D.bit_length() - 1
    if 1 << d != D:
        raise ValueError(f"axis size {D} must be a power of two")
    return d


def local_table(table, D: int, i: int):
    """Shard ``i``'s twiddle table [C, N/D] for the local stages:
    ``out[m' + j'] = table[(D + i) m' + j']`` for every power of two m' <
    N/D (entry 0, unread, is ``table[0]``)."""
    n_loc = table.shape[-1] // D
    out = torch.empty((table.shape[0], n_loc), dtype=table.dtype,
                      device=table.device)
    out[:, 0] = table[:, 0]
    m = 1
    while m < n_loc:
        out[:, m:2 * m] = table[:, (D + i) * m:(D + i + 1) * m]
        m *= 2
    return out


def local_pack(lp, D: int, i: int):
    """The LevelPack of shard ``i``'s local stages: ``psi`` / ``ipsi`` its
    local tables, ``Rs`` and ``Ninv`` set to R (so the kernels' x R entry
    and N^-1 fold leave the words as they are)."""
    bits = mont.NBITS if lp.pack.dtype == torch.int64 else mont.NBITS_30
    one = torch.full_like(lp.Ninv, 1 << bits)
    return dataclasses.replace(
        lp, psi=local_table(lp.psi, D, i), ipsi=local_table(lp.ipsi, D, i),
        Ninv=one, Rs=one)


def _cross_stage_twiddle(table, s, i, N, N_loc):
    """The twiddle column [C, 1] of cross stage ``s`` on shard ``i``: at
    stage s (m = 2^s <= D/2 groups of 2t = N/m elements) a shard lies in
    one group, m + (i N_loc) // 2t."""
    m = 1 << s
    t = N >> (s + 1)
    g = m + (i * N_loc) // (2 * t)
    return table[:, g:g + 1]


def _cross(blocks, mesh, axis, tables, forward):
    """The cross-shard stages of every block: ``tables[coord]`` = (full
    LevelPack of the block's rows, ...) on the coordinate's device."""
    D = mesh.extent(axis)
    d = _log2(D)
    stages = range(d) if forward else range(d - 1, -1, -1)
    for s in stages:
        half = D >> (s + 1)
        other = meshlib.ppermute(blocks, mesh, axis,
                                 [(j, j ^ half) for j in range(D)])
        nxt = {}
        for coord, x in blocks.items():
            lp = tables[coord][0]
            pk = lp.pack
            i = mesh.index(coord, axis)
            N_loc = x.shape[-1]
            S = _cross_stage_twiddle(lp.psi if forward else lp.ipsi, s, i,
                                     N_loc * D, N_loc)
            if forward:   # U' = U + S V, V' = U - S V
                if i & half == 0:
                    nxt[coord] = mont.mont_add(
                        x, mont.mont_mult(S, other[coord], pk), pk)
                else:
                    nxt[coord] = mont.mont_sub(
                        other[coord], mont.mont_mult(S, x, pk), pk)
            else:         # U' = U + V, V' = S (U - V)
                if i & half == 0:
                    nxt[coord] = mont.mont_add(x, other[coord], pk)
                else:
                    nxt[coord] = mont.mont_mult(
                        mont.mont_sub(other[coord], x, pk), S, pk)
        blocks = nxt
    return blocks


def ntt_cross(blocks: dict, mesh, axis: str, tables: dict) -> dict:
    """The forward cross-shard stages; the caller runs the local stages
    (K1, K3 or K5 with ``tables[coord][1]``, :func:`local_pack`)."""
    return _cross(blocks, mesh, axis, tables, forward=True)


def ntt_block(blocks: dict, mesh, axis: str, tables: dict) -> dict:
    """Coefficient-sharded forward NTT of [..., C, N/D] blocks (Montgomery
    domain, no entry): cross stages, then K1 on the local stages.
    ``tables[coord]`` = (full LevelPack of the block's rows, its
    :func:`local_pack`), on the coordinate's device.  Bit-identical to the
    unsharded ``ops.ntt.ntt``."""
    blocks = ntt_cross(blocks, mesh, axis, tables)
    return {c: kern.ntt(x.contiguous(), tables[c][1], enter=False)
            for c, x in blocks.items()}


def intt_block(blocks: dict, mesh, axis: str, tables: dict,
               epilogue: str = "mont") -> dict:
    """Coefficient-sharded inverse NTT (see :func:`ntt_block`): K2 on the
    local stages with the N^-1 fold set to R, the cross stages in reverse,
    then N^-1; ``epilogue`` "mont" keeps R (``ops.ntt.intt``),
    "exit_reduce" leaves canonical [0, q) rows (``intt_exit_reduce``)."""
    blocks = {c: kern.intt(x.contiguous(), tables[c][1], "mont")
              for c, x in blocks.items()}
    blocks = _cross(blocks, mesh, axis, tables, forward=False)
    out = {}
    for c, x in blocks.items():
        lp = tables[c][0]
        x = mont.mont_mult(x, lp.Ninv, lp.pack)
        if epilogue == "exit_reduce":
            x = mont.reduce_2q(mont.mont_reduce(x, lp.pack), lp.pack)
        elif epilogue != "mont":
            raise ValueError(f"unknown epilogue {epilogue!r}")
        out[c] = x
    return out


def coef_tables(lp, mesh, axis: str) -> dict:
    """coordinate -> (lp, :func:`local_pack` of it), on the coordinate's
    device, for blocks that hold every row of ``lp``."""
    D = mesh.extent(axis)
    out = {}
    for c in mesh.coords():
        full = lp.to(mesh.device(c))
        out[c] = (full, local_pack(full, D, mesh.index(c, axis)))
    return out


def make_coef_sharded_ntt(lp, logN: int, mesh, axis: str = "coef"):
    """(ntt_fn, intt_fn) over ShardedArrays [..., C, N] with N sharded on
    ``axis``: the forward NTT and the Montgomery-staying inverse of
    ``ops.ntt`` (no entry, no exit), bit-identical to them."""
    if lp.psi.shape[-1] != 1 << logN:
        raise ValueError(f"tables of N={lp.psi.shape[-1]}, logN={logN}")
    tables = coef_tables(lp, mesh, axis)

    def _spec(x):
        return (None,) * (x.ndim - 1) + (axis,)

    def _blocks(x):
        return meshlib.reshard(x, _spec(x)).blocks

    def _wrap(blocks, x):
        return meshlib.ShardedArray(blocks, mesh, _spec(x), x.shape, x.dtype)

    def ntt_fn(x):
        return _wrap(ntt_block(_blocks(x), mesh, axis, tables), x)

    def intt_fn(x):
        return _wrap(intt_block(_blocks(x), mesh, axis, tables), x)

    return ntt_fn, intt_fn
