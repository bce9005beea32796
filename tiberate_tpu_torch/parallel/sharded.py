"""The fused multiply step: rescale -> tensor product -> relinearize.

The torch counterpart of ``tiberate_tpu/parallel/sharded.py``
(``make_mult_step`` / ``mult_step_params`` / ``prepare_step_ksk``).  A
batch of ciphertexts is the leading dimension of the step's operands.

Single device: the step's key argument is the K6 key form,
:func:`prepare_step_ksk`'s ``eng._ksk_parts_fused(ksk, work_level)``, and
all keyswitch parts run in one ``ntt_keymul_parts`` kernel at every logN
(the JAX package takes its per-part chain from logN17 up, a VMEM limit of
its Pallas kernel that the H100 kernel does not have; both give the same
bytes).  ``prm`` holds only the work level's constants, as in the JAX
package's split.

On an engine mesh (``CkksEngine(mesh=)``) whose ``rns`` axis divides the
work level's ordinary channels, the step runs per shard: each shard
rescales into its own rows (the rescaled rows are whole on every shard of
a level-0 input; a sharded input is first gathered once, counted), runs K5
and K2 on them, and the relinearization goes through the sharded
keyswitch (:mod:`parallel.rns_sharded`: one all_gather).  A ``coef`` axis
that divides N shards the coefficients too: the transforms' cross-shard
stages exchange blocks by ppermute (:mod:`parallel.coef_sharded`) and the
local stages run on K5 and K2.  Otherwise the mesh takes the single-device
route.  ``TIBERATE_SCATTER_SPECIAL=0/1`` overrides the special-row mode,
as in the JAX package (default: scattered past two rns shards, without a
coef axis).
"""

import os

import torch

from tiberate_tpu_torch.engine.ckks_engine import (
    _ccmult_tensor_core,
    _decrypt_double_core,
    _relin_core,
    _rescale_core,
)
from tiberate_tpu_torch.ops import glue_kernels as glue
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.parallel import coef_sharded as cs
from tiberate_tpu_torch.parallel import mesh as meshlib
from tiberate_tpu_torch.utils import trace


def _rns_axis(eng, work_level):
    """"rns" when the engine mesh's rns axis (> 1 shard) divides the work
    level's ordinary channel count, else None."""
    mesh = getattr(eng, "mesh", None)
    if mesh is None or "rns" not in mesh.shape:
        return None
    D = mesh.shape["rns"]
    if D <= 1 or eng._lp(work_level, False).num_channels % D:
        return None
    return "rns"


def _coef_axis(eng):
    """"coef" when the engine mesh's coef axis (> 1 shard) divides N."""
    mesh = getattr(eng, "mesh", None)
    if mesh is None or "coef" not in mesh.shape:
        return None
    if mesh.shape["coef"] <= 1 or eng.params.N % mesh.shape["coef"]:
        return None
    return "coef"


def _cached(eng, key, make):
    if key not in eng._mesh_cache:
        eng._mesh_cache[key] = make()
    return eng._mesh_cache[key]


def _rns_switcher(eng, work_level, axis, caxis=None):
    """The sharded keyswitch of the engine mesh at ``work_level``, cached
    on the engine per level and special-row mode."""
    from tiberate_tpu_torch.parallel.rns_sharded import (
        make_rns_sharded_switcher,
    )

    D = eng.mesh.shape[axis]
    env = os.environ.get("TIBERATE_SCATTER_SPECIAL")
    scatter = (D > 2 and caxis is None) if env is None else env == "1"
    return _cached(
        eng, ("switcher", work_level, axis, caxis, scatter),
        lambda: make_rns_sharded_switcher(eng, work_level, eng.mesh,
                                          axis=axis, scatter_special=scatter,
                                          coef_axis=caxis))


def _coef_cores(eng, level, caxis, raxis):
    """Per coordinate of the engine mesh: (the ordinary rows' LevelPack of
    the block at ``level``, its coef-local pack or None), on the
    coordinate's device, for blocks laid out (.., raxis, caxis)."""
    def make():
        mesh = eng.mesh
        lp = eng._lp(level, False)
        D = mesh.extent(raxis) if raxis else 1
        ro = lp.num_channels // D
        out = {}
        for c in mesh.coords():
            r = mesh.index(c, raxis) if raxis else 0
            rows = lp[r * ro:(r + 1) * ro].to(mesh.device(c))
            out[c] = (rows, cs.local_pack(rows, mesh.extent(caxis),
                                          mesh.index(c, caxis))
                      if caxis else None)
        return out
    return _cached(eng, ("cores", level, caxis, raxis), make)


def _spec(x, raxis, caxis):
    return x.spec[:-2] + (raxis, caxis)


def rescale_sharded(eng, x, level, spec, exact_rounding=True):
    """``eng.rescale``'s rows of a ShardedArray at ``level``, laid out by
    ``spec``: each shard computes its own rows of the result from the
    dropped row and its rows of the input (an input sharded along the
    rows is gathered once first)."""
    whole = meshlib.reshard(x, spec[:-2] + (None, spec[-1]))
    shape = x.shape[:-2] + (x.shape[-2] - 1, x.shape[-1])
    out = meshlib.ShardedArray({}, x.mesh, spec, shape, x.dtype)
    round_at = eng.params.q[level] // 2
    for c, blk in whole.blocks.items():
        r0, r1 = out.rows(c)
        dev = x.mesh.device(c)
        out.blocks[c] = glue.rescale(
            blk[..., 0:1, :], blk[..., 1 + r0:1 + r1, :],
            eng.params.rescale_scales[level][r0:r1].to(dev),
            eng._block_lp(level + 1, False, r0, r1, dev), round_at,
            exact_rounding)
    return out


def intt_sharded(eng, xs, level, raxis, caxis):
    """K2 ("exit_reduce") of NTT-domain ShardedArrays laid out (.., raxis,
    caxis) at ``level``: per block, or coefficient-sharded (one pass of
    cross stages for all of ``xs``).  Returns dicts coordinate -> block."""
    T = _coef_cores(eng, level, caxis, raxis)
    if caxis is None:
        return [{c: kern.intt(b, T[c][0], "exit_reduce")
                 for c, b in x.blocks.items()} for x in xs]
    st = cs.intt_block({c: torch.stack([x.blocks[c] for x in xs])
                        for c in xs[0].blocks}, eng.mesh, caxis, T,
                       "exit_reduce")
    return [{c: v[i] for c, v in st.items()} for i in range(len(xs))]


def relin_sharded(eng, d0, d1, d2, level, rksk, raxis, caxis, tables=None):
    """relinearize on the mesh: NTT-domain ShardedArrays d0, d1, d2 at
    ``level`` -> (ct0, ct1) ShardedArrays: K2 per shard, the sharded
    keyswitch of d2, the sum."""
    sw = _rns_switcher(eng, level, raxis, caxis)
    spec = _spec(d0, raxis, caxis)
    ds = [meshlib.reshard(d, spec) for d in (d0, d1, d2)]
    e0, e1, e2 = intt_sharded(eng, ds, level, raxis, caxis)
    c0, c1 = sw(meshlib.ShardedArray(e2, eng.mesh, spec, d2.shape, d2.dtype),
                rksk, tables)
    T = _coef_cores(eng, level, caxis, raxis)
    return tuple(
        meshlib.ShardedArray(
            {c: mont.reduce_2q(e[c] + cc.blocks[c], T[c][0].pack)
             for c in e}, eng.mesh, spec, d2.shape, d2.dtype)
        for e, cc in ((e0, c0), (e1, c1)))


def rns_ksk(eng, ksk, level):
    """``ksk`` laid out for the engine mesh's switcher at ``level``
    (:class:`rns_sharded.RnsKsk`), cached on the key."""
    axis, caxis = _rns_axis(eng, level), _coef_axis(eng)
    sw = _rns_switcher(eng, level, axis, caxis)
    cache = eng._key_cache(ksk, "_rns_ksk")
    key = (id(eng.mesh), level, sw.scatter_special, caxis)
    if key not in cache:
        cache[key] = sw.prepare_ksk(tuple(ksk.data))
    return cache[key]


def prepare_step_ksk(eng, level: int = 0, pre_rescale: bool = True,
                     ksk=None, rns_shard=None):
    """The ksk argument for :func:`make_mult_step`'s step function, from
    ``ksk`` (default: the engine's evk), cached on the key.

    Engine-mesh rns mode: the key laid out for the sharded switcher
    (:class:`rns_sharded.RnsKsk`).  Otherwise the all-parts key form the
    step's keyswitch reads (``eng._ksk_parts_fused`` at the work
    level)."""
    work_level = level + 1 if pre_rescale else level
    ksk = ksk or eng.evk
    if rns_shard in (None, True) and _rns_axis(eng, work_level):
        return rns_ksk(eng, ksk, work_level)
    return eng._ksk_parts_fused(ksk, work_level)


def mult_step_params(eng, level: int = 0, pre_rescale: bool = True,
                     ksk=None, rns_shard=None):
    """The parameter dict for :func:`make_mult_step`'s step function: the
    work level's constants, no key form (that is :func:`prepare_step_ksk`;
    ``ksk`` is taken for the JAX package's signature and not read).  On
    the engine mesh (rns mode), ``rns_tables`` holds the sharded switcher's
    per-shard tables."""
    work_level = level + 1 if pre_rescale else level
    axis = (_rns_axis(eng, work_level)
            if rns_shard in (None, True) else None)
    return dict(
        rescale_scale=(eng.params.rescale_scales[level] if pre_rescale
                       else None),
        lp_ord=eng._lp(work_level, False),
        lp_sp=eng._lp(work_level, True),
        parts=tuple(eng.params.parts[work_level]),
        PiRs=tuple(eng.params.PiRs[work_level]),
        rns_tables=(_rns_switcher(eng, work_level, axis,
                                  _coef_axis(eng)).tables
                    if axis else None),
    )


def make_mult_step(eng, level: int = 0, pre_rescale: bool = True,
                   rns_shard=None):
    """Returns step_fn(a0, a1, b0, b1, ksk, prm) -> (ct0, ct1).

    ``a*``/``b*``: [..., C, N] ciphertext rows at ``level`` (ShardedArrays
    on an engine mesh in rns mode; plain tensors are laid out first); the
    result is at ``level + 1`` with ``pre_rescale``, else at ``level``.
    ``ksk`` from :func:`prepare_step_ksk`; ``prm`` from
    :func:`mult_step_params`.  ``rns_shard=False`` forces the single-device
    route, traced as the spans ``step.rescale``, ``step.tensor`` and
    ``step.relin``.
    """
    S = eng.ckksCfg.num_special_primes
    round_at = eng.params.q[level] // 2
    work_level = level + 1 if pre_rescale else level
    axis = (_rns_axis(eng, work_level)
            if rns_shard in (None, True) else None)

    if axis is None:
        def step(a0, a1, b0, b1, ksk, prm):
            lp = prm["lp_ord"]
            if pre_rescale:
                rs = prm["rescale_scale"]
                with trace.annotate("step.rescale"):
                    a0, a1, b0, b1 = (_rescale_core(x, rs, lp, round_at)
                                      for x in (a0, a1, b0, b1))
            with trace.annotate("step.tensor"):
                d0, d1, d2 = _ccmult_tensor_core(a0, a1, b0, b1, lp)
            with trace.annotate("step.relin"):
                return _relin_core(d0, d1, d2, ksk, prm["parts"],
                                   prm["lp_sp"], lp, prm["PiRs"], S)
        return step

    caxis = _coef_axis(eng)
    mesh = eng.mesh

    def mesh_step(a0, a1, b0, b1, ksk, prm):
        xs = [eng._as_sharded(x) for x in (a0, a1, b0, b1)]
        spec = _spec(xs[0], axis, caxis)
        if pre_rescale:
            xs = [rescale_sharded(eng, x, level, spec) for x in xs]
        else:
            xs = [meshlib.reshard(x, spec) for x in xs]
        T = _coef_cores(eng, work_level, caxis, axis)
        if caxis is None:
            d = {c: _ccmult_tensor_core(*(x.blocks[c] for x in xs), T[c][0])
                 for c in T}
        else:
            # enter, the cross stages of all four at once, then K5 on the
            # local stages (its x R entry is the identity there)
            ent = {c: torch.stack([mont.mont_enter(x.blocks[c], T[c][0].Rs,
                                                   T[c][0].pack)
                                   for x in xs]) for c in T}
            ent = cs.ntt_cross(ent, mesh, caxis, T)
            d = {c: kern.ntt_tensor(*v.unbind(0), T[c][1])
                 for c, v in ent.items()}
        shape = xs[0].shape
        d0, d1, d2 = (meshlib.ShardedArray({c: v[i] for c, v in d.items()},
                                           mesh, spec, shape, xs[0].dtype)
                      for i in range(3))
        return relin_sharded(eng, d0, d1, d2, work_level, ksk, axis, caxis,
                             prm["rns_tables"])

    return mesh_step


def make_encdec_roundtrip(eng, level: int = 0):
    """Returns the decrypt-side step ``step(ct0, ct1, sk) -> scaled``
    ([..., 1, N] signed, rounded) at ``level``, ``sk`` the secret key's
    rows at the level ([C, N], as the JAX step takes them); ShardedArray
    operands are gathered onto the mesh's first device."""
    lp = eng._lp(level, False)
    C = lp.num_channels

    def step(ct0, ct1, sk):
        ct0, ct1, sk = (x.gather() if isinstance(x, meshlib.ShardedArray)
                        else x for x in (ct0, ct1, sk))
        scaled, _ = _decrypt_double_core(
            ct0, ct1, sk, lp, eng.params.base_lp(),
            eng.params.final_scalar[level], eng._rounding_half,
            base_at=C - 1, final_round=True,
        )
        return scaled

    return step
