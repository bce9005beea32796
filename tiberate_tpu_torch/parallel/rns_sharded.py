"""RNS-channel-sharded key switching over a mesh axis.

The torch counterpart of ``tiberate_tpu/parallel/rns_sharded.py``: the
ordinary channels are sharded over the ``rns`` axis, ``ro = C_ord / D``
rows a shard.  Per switch, per shard (the JAX ``shard_fn``):

1. one tiled :func:`mesh.all_gather` of the ordinary channels;
2. every part's mixed-radix digits, computed replicated (``_pre_extend``);
3. the extension onto the shard's ``ro`` ordinary rows plus the special
   rows (``_extend`` with the part's constants restricted to those rows);
4. the forward NTT with both evk products, summed over the parts: K3
   (``ntt_keymul`` for the first part, ``ntt_keymul_accum`` after it) on
   the shard's rows;
5. a local P-division epilogue (``_pdiv_fused``: K2 on the special rows,
   K4 ``intt_pdiv`` on the shard's ordinary rows).

The kernels take a modulus, twiddle row and key row per channel, so a
shard's rows need no kernel of their own: a LevelPack of those rows
(``lp[rows]``) is all they read.  (The JAX package splits each shard's
rows into head and tail blocks for the static group shapes of its Mosaic
kernels; the CUDA kernels have no such constraint, so there is no split.)

``scatter_special`` round-robins the special rows over the shards (padded
with duplicates when S < D) and adds one small all_gather of their
canonical rows before the epilogue.  ``coef_axis`` also shards the
coefficients: the transforms' cross-shard stages exchange blocks by
``ppermute`` (:mod:`parallel.coef_sharded`), the local stages run on K3 and
K2, and the P-division runs as torch ops on the canonical rows, as in the
JAX package; it forces the replicated special rows.

Collectives per switch: one all_gather (two with ``scatter_special``),
plus the coef axis' ppermutes.  Outputs are ``eng.create_switcher``'s
bytes.
"""

import dataclasses
import types
from typing import NamedTuple

import torch

from tiberate_tpu_torch.engine.ckks_engine import (
    _extend,
    _pdiv_fused,
    _pre_extend,
)
from tiberate_tpu_torch.ops import glue_kernels as glue
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.parallel import coef_sharded as cs
from tiberate_tpu_torch.parallel import mesh as meshlib


class RnsKsk(NamedTuple):
    """A key-switching key laid out for the sharded switcher
    (``prepare_ksk``): per live part, (k0, k1), each a dict coordinate ->
    the key rows that shard's kernels read, [ro + special rows, N / D_coef],
    on its device (its ordinary rows, then its special rows)."""

    keys: tuple


def _rows_part(part, rows, device):
    """``part`` for ``_extend`` at level 0 over the global channel indices
    ``rows``, on ``device``."""
    if part.L_enter is not None:
        part = dataclasses.replace(part, L_enter=part.L_enter[:, rows])
    return part.to(device)


def make_rns_sharded_switcher(eng, level: int, mesh, axis: str = "rns",
                              scatter_special: bool = False,
                              coef_axis: str | None = None):
    """``switcher(a, ksk) -> (c0, c1)`` with the ordinary channels sharded
    over ``axis``: ``a`` a ShardedArray [..., C_ord, N] (coefficient
    domain, [0, q)), ``ksk`` the key's ``.data`` or its
    :func:`prepare_ksk` form; returns ShardedArrays of the canonical
    ordinary rows in ``a``'s layout (rows over ``axis``).  The channel
    count must divide the axis size."""
    lp_ord = eng._lp(level, False)
    lp_sp = eng._lp(level, True)
    parts = tuple(eng.params.parts[level])
    alloc = tuple(eng.params.parts_alloc[level])
    PiRs = tuple(eng.params.PiRs[level])
    S = eng.params.S
    C_ord = lp_ord.num_channels
    D = mesh.extent(axis)
    if C_ord % D:
        raise ValueError(f"ordinary channel count {C_ord} must divide the "
                         f"{axis!r} axis size {D}")
    ro = C_ord // D
    if coef_axis is not None and mesh.extent(coef_axis) <= 1:
        coef_axis = None
    if coef_axis is not None:
        scatter_special = False
    rps = -(-S // D) if scatter_special else S
    src = [i if i < S else i % S for i in range(D * rps)]
    Dc = mesh.extent(coef_axis) if coef_axis else 1
    N_loc = eng.params.N // Dc

    tables = {}
    for coord in mesh.coords():
        r = mesh.index(coord, axis)
        dev = mesh.device(coord)
        ords = list(range(r * ro, (r + 1) * ro))
        sps = ([C_ord + j for j in src[r * rps:(r + 1) * rps]]
               if scatter_special else list(range(C_ord, C_ord + S)))
        own = ords + sps
        lp_rows = lp_sp[own].to(dev)
        t = types.SimpleNamespace(
            own=own,
            cols=slice(mesh.index(coord, coef_axis) * N_loc,
                       (mesh.index(coord, coef_axis) + 1) * N_loc),
            lp_rows=lp_rows,
            lp_o=lp_sp[ords].to(dev),
            lp_spec=lp_sp[C_ord:].to(dev),
            PiRs=tuple(p[ords + list(range(C_ord, C_ord + S))].to(dev)
                       for p in PiRs),
            parts=tuple(p.to(dev) for p in parts),
            plp=tuple(lp_ord[p.lo:p.hi].to(dev) for p in parts),
            parts_rows=tuple(_rows_part(p, [level + j for j in own], dev)
                             for p in parts),
            coef=((lp_rows, cs.local_pack(lp_rows, Dc,
                                          mesh.index(coord, coef_axis)))
                  if coef_axis else None),
        )
        tables[coord] = t

    def prepare_ksk(ksk_parts_full):
        """The key's rows for every shard (:class:`RnsKsk`): each live
        part's two components at the level, restricted to the shard's rows
        and coefficient block, contiguous on its device."""
        keys = []
        for g in alloc:
            pair = []
            for k in ksk_parts_full[g]:
                if isinstance(k, meshlib.ShardedArray):
                    k = k.gather()
                full = k[level:]
                pair.append({c: full[t.own][:, t.cols].contiguous()
                             .to(mesh.device(c))
                             for c, t in tables.items()})
            keys.append(tuple(pair))
        return RnsKsk(tuple(keys))

    def switcher(a, ksk, tables_=None):
        """``tables_`` (default: :attr:`switcher.tables`) the per-shard
        tables, as ``mult_step_params`` carries them."""
        T = tables_ if tables_ is not None else tables
        if not isinstance(ksk, RnsKsk):
            ksk = prepare_ksk(ksk)
        spec = a.spec[:-2] + (axis, coef_axis)
        a = meshlib.reshard(a, spec)
        # 1. the state broadcast: the ordinary channels, gathered once
        full = meshlib.all_gather(a.blocks, mesh, axis, dim=-2)
        acc = {}
        for k, part in enumerate(parts):
            # 2. digits (replicated), 3. extension onto the shard's rows
            ext = {}
            for c, x in full.items():
                t = T[c]
                st = _pre_extend(x[..., part.lo:part.hi, :], t.parts[k],
                                 t.plp[k])
                ext[c] = _extend(st, t.parts_rows[k], t.lp_rows, 0)
            if coef_axis:
                ext = cs.ntt_cross(ext, mesh, coef_axis,
                                   {c: T[c].coef for c in ext})
            # 4. NTT and both key products, summed over the parts (K3)
            for c, e in ext.items():
                t = T[c]
                lp = t.coef[1] if coef_axis else t.lp_rows
                keys = (ksk.keys[k][0][c], ksk.keys[k][1][c])
                if k == 0:
                    acc[c] = kern.ntt_keymul(e.contiguous(), lp, keys,
                                             enter=False)
                else:
                    kern.ntt_keymul_accum(e.contiguous(), lp, keys, acc[c],
                                          None)
        # 5. the P-division epilogue, local to each shard
        out0, out1 = {}, {}
        if coef_axis:
            d = cs.intt_block({c: torch.stack(v) for c, v in acc.items()},
                              mesh, coef_axis, {c: T[c].coef for c in acc},
                              "exit_reduce")
            for c, dc in d.items():
                t = T[c]
                res = []
                for x in dc:
                    p0 = glue.pdiv_p0(x[..., ro:, :], t.lp_spec, t.PiRs, ro,
                                      S)
                    res.append(kern.pdiv_plain(x[..., :ro, :], p0, t.lp_o,
                                               t.PiRs))
                out0[c], out1[c] = res
        elif scatter_special:
            sp = {c: kern.intt(torch.stack([v[..., ro:, :] for v in acc[c]]),
                               T[c].lp_rows[ro:], "exit_reduce")
                  for c in acc}
            sp = meshlib.all_gather(sp, mesh, axis, dim=-2)
            for c, v in acc.items():
                t = T[c]
                out0[c], out1[c] = (
                    kern.intt_pdiv(x, glue.pdiv_p0(sp[c][i][..., :S, :],
                                                   t.lp_spec, t.PiRs, ro,
                                                   S),
                                   t.lp_o, t.PiRs)
                    for i, x in enumerate(v))
        else:
            for c, v in acc.items():
                t = T[c]
                out0[c], out1[c] = (_pdiv_fused(x, t.lp_rows, t.lp_o,
                                                t.PiRs, S) for x in v)
        return tuple(meshlib.ShardedArray(o, mesh, spec, a.shape, a.dtype)
                     for o in (out0, out1))

    switcher.tables = tables
    switcher.prepare_ksk = prepare_ksk
    switcher.scatter_special = scatter_special
    return switcher
