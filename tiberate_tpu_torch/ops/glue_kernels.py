"""The cc_mult step's glue and the engine's elementwise ops as Hopper
kernels: wrappers and plain versions.

The elementwise work around the NTT kernels, which XLA fuses inside the
JAX package's jitted code, runs here as one kernel each (``csrc/glue.cu``):

====  ====================  ==============================================
G1    :func:`rescale`       drop the top channel: ``_rescale_core``
G2    :func:`parts_digits`  every keyswitch part's mixed-radix digits,
                            zero-padded (K6's operand): ``_pre_extend``
G3    :func:`pdiv_p0`       the special rows each P-division subtracts:
                            the special-row phase of ``_pdiv_fused``
G4    :func:`mont_scalar`   the product by one constant a channel, then
                            ``reduce_2q``: ``_mont_scalar_core``
      :func:`mod_add`,      the lazy add / subtract, then ``reduce_2q``:
      :func:`mod_sub`       ``_cc_add_core``, ``_cc_sub_core``
====  ====================  ==============================================

As in :mod:`~tiberate_tpu_torch.ops.ntt_kernels`: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises, any other
device raises; the lane comes from the level pack's dtype; every launch
adds one to ``ntt_kernels.LAUNCHES`` (one count for every kernel of the
port) under the wrapper's name, ``_30`` appended in the 30-bit lane.

Inputs may be views: each is ``[..., rows, N]`` with contiguous
coefficients, its rows N words apart and its leading dimensions one
stride (``x.view(-1, rows, N)`` must not copy), as ``d[..., 1:, :]`` or a
shard's row block is.  G4's two operands broadcast along their leading
dimensions (one ciphertext against a stack: batch stride 0), and G4
checks its operands on every device, so that a CPU run refuses what the
kernel would.  Outputs are new contiguous tensors.  The kernels run the
plain versions' REDCs and selects in the same order on the same
operands, so their outputs are bit-identical.
"""

import ctypes

import torch

from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.ops.ntt_kernels import (
    LANES,
    _check,
    _done,
    _entry,
    _on_cpu,
    _ptr,
    _stream,
)

WRAPPERS = ("rescale", "parts_digits", "pdiv_p0", "mont_scalar", "mod_add",
            "mod_sub")
LAUNCHES = kern.LAUNCHES
LAUNCHES.update(dict.fromkeys(
    (name + sfx for sfx in LANES.values() for name in WRAPPERS), 0))

_MAXA = 8   # TT_GLUE_MAXA: most digits a part has
_MAXS = 8   # TT_GLUE_MAXS: most special primes
_PART = 2 + 3 * _MAXA + _MAXA * _MAXA  # TT_GLUE_PART: table words a part
_MAX_GRID = 65535


def _rows_view(x, rows, name):
    """(B, batch stride) of ``x`` [..., rows, N] as the kernels read it."""
    if x.dim() < 2 or x.shape[-2] != rows:
        raise ValueError(f"{name}: expected [..., {rows}, N], got "
                         f"{tuple(x.shape)}")
    N = x.shape[-1]
    if N < 1 or x.stride(-1) != 1 or (rows > 1 and x.stride(-2) != N):
        raise ValueError(f"{name}: coefficients must be contiguous and rows "
                         f"N words apart (strides {x.stride()})")
    try:
        v = x.view(-1, rows, N)
    except RuntimeError as e:
        raise ValueError(f"{name}: leading dimensions of strides "
                         f"{x.stride()} do not fold into one") from e
    B = v.shape[0]
    if not 1 <= B <= _MAX_GRID:
        raise ValueError(f"{name}: batch of {B}; the kernels take 1 to "
                         f"{_MAX_GRID}")
    return B, v.stride(0)


def _check_views(device, dtype, **tensors):
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")


# ----------------------------------------------------------------------
# G1 — rescale.
# ----------------------------------------------------------------------


def rescale_plain(rescaler, rows, rescale_scale, lp_next, round_at,
                  exact_rounding=True):
    data = rows - rescaler
    data = mont.mont_mult(data, rescale_scale, lp_next.pack)
    if exact_rounding:
        data = data + (rescaler > round_at).to(data.dtype)
    # REDC of a signed difference can land marginally below zero
    data = mont.make_unsigned(data, lp_next.pack)
    return mont.reduce_2q(data, lp_next.pack)


def rescale(rescaler, rows, rescale_scale, lp_next, round_at,
            exact_rounding=True):
    """``rows`` [..., c, N] less the dropped channel ``rescaler`` [..., 1,
    N], times its ``rescale_scale`` [c, 1] (REDC), rounded up where the
    rescaler exceeds ``round_at`` (``exact_rounding``): canonical [0, q)
    rows of ``lp_next`` [..., c, N]."""
    if _on_cpu(rows):
        return rescale_plain(rescaler, rows, rescale_scale, lp_next,
                             round_at, exact_rounding)
    pack = lp_next.pack
    c = pack.num_channels
    B, rows_bs = _rows_view(rows, c, "rows")
    N = rows.shape[-1]
    if tuple(rescaler.shape) != (*rows.shape[:-2], 1, N):
        raise ValueError(f"rescaler shape {tuple(rescaler.shape)} does not "
                         f"match rows {tuple(rows.shape)}")
    _, resc_bs = _rows_view(rescaler, 1, "rescaler")
    if tuple(rescale_scale.shape) != (c, 1):
        raise ValueError(f"rescale_scale shape {tuple(rescale_scale.shape)}"
                         f" != {(c, 1)}")
    _check_views(rows.device, pack.dtype, rows=rows, rescaler=rescaler)
    _check(rows.device, pack.dtype, rescale_scale=rescale_scale, q=pack.q,
           k=pack.k)
    out = torch.empty((*rows.shape[:-2], c, N), dtype=rows.dtype,
                      device=rows.device)
    rc = _entry("tt_rescale", pack)(
        _ptr(rows), rows_bs, _ptr(rescaler), resc_bs, _ptr(out), B, c, N,
        _ptr(rescale_scale), _ptr(pack.q), _ptr(pack.k), int(round_at),
        int(bool(exact_rounding)), _stream(rows.device),
    )
    _done(rc, "rescale", pack)
    return out


# ----------------------------------------------------------------------
# G2 — keyswitch digits.
# ----------------------------------------------------------------------


def pre_extend_plain(a_part, part, plp):
    """Mixed-radix (Garner) digits of one part's residues: ``a_part``
    [..., alpha, N] in [0, q) -> [..., alpha, N] signed digits."""
    alpha = part.alpha
    pk = plp.pack
    rows = [a_part[..., 0, :]] * alpha
    for i in range(alpha - 1):
        ql, qh = pk.ql[i + 1], pk.qh[i + 1]
        kl, kh = pk.kl[i + 1], pk.kh[i + 1]
        y = a_part[..., i + 1, :] - rows[i + 1]
        y = mont.mont_mult_raw(y, part.Y_scalar[i], ql, qh, kl, kh)
        rows[i + 1] = y
        if i + 2 < alpha:
            suffix = pk[i + 2 : alpha]
            ynew = mont.mont_mult_raw(
                y[..., None, :], part.L_scalar[i],
                suffix.ql, suffix.qh, suffix.kl, suffix.kh,
            )
            for j, r in enumerate(range(i + 2, alpha)):
                rows[r] = rows[r] + ynew[..., j, :]
    return torch.stack(rows, dim=-2)


def parts_digits_plain(a, parts, lp, amax, lo_base=0):
    sts = []
    for part in parts:
        lo, hi = part.lo - lo_base, part.hi - lo_base
        st = pre_extend_plain(a[..., lo:hi, :], part, lp[lo:hi])
        if part.alpha < amax:
            pad = st.new_zeros((*st.shape[:-2], amax - part.alpha,
                                st.shape[-1]))
            st = torch.cat([st, pad], dim=-2)
        sts.append(st)
    return torch.stack(sts, dim=-3)


def _digits_table_rows(parts, lp, lo_base):
    """G2's constants, one row of ``_PART`` words a part: lo, alpha, then
    the part's q, k, Y_scalar and L_scalar (``L[i][r]`` at ``i * _MAXA +
    r``, the suffix pack's row r), zero where unused."""
    q, k = lp.pack.q.tolist(), lp.pack.k.tolist()
    out = []
    for part in parts:
        lo, alpha = part.lo - lo_base, part.alpha
        row = [0] * _PART
        row[0], row[1] = part.lo, alpha
        row[2:2 + alpha] = q[lo:lo + alpha]
        row[2 + _MAXA:2 + _MAXA + alpha] = k[lo:lo + alpha]
        ys = [] if part.Y_scalar is None else part.Y_scalar[:, 0].tolist()
        row[2 + 2 * _MAXA:2 + 2 * _MAXA + len(ys)] = ys
        for i, col in enumerate(part.L_scalar):
            base = 2 + 3 * _MAXA + i * _MAXA + i + 2
            vals = col[:, 0].tolist()
            row[base:base + len(vals)] = vals
        out.append(row)
    return out


# (device, q and k pointers, lo_base, the parts' ids) -> (q, k, parts,
# table): holding q, k and the parts keeps those pointers and ids from
# being reused by other tensors while the entry lives
_TABLES = {}
_TABLES_MAX = 256


def digits_table(parts, lp, lo_base=0):
    """G2's constants for ``parts`` over ``lp``'s rows (whose row 0 is the
    parts' row ``lo_base``), on ``lp``'s device: built from the host once
    and cached, as ``ec`` is per level."""
    q, k = lp.pack.q, lp.pack.k
    key = (q.device, q.data_ptr(), k.data_ptr(), lo_base, *map(id, parts))
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.clear()
        tab = torch.tensor(_digits_table_rows(parts, lp, lo_base),
                           dtype=lp.pack.dtype, device=q.device)
        hit = _TABLES[key] = (q, k, tuple(parts), tab)
    return hit[-1]


def parts_digits(a, parts, lp, amax, lo_base=0):
    """Every part's mixed-radix digits, zero-padded to ``amax`` rows:
    ``a`` [..., C, N] canonical residues, ``lp`` the level pack of its
    rows, each part's rows ``part.lo - lo_base`` on; returns [...,
    n_parts, amax, N] (the ``ntt_keymul_parts`` operand).  With one part
    and ``lo_base = part.lo`` it is ``_pre_extend`` of that part."""
    if _on_cpu(a):
        return parts_digits_plain(a, parts, lp, amax, lo_base)
    pack = lp.pack
    if any(p.alpha > amax for p in parts) or not 1 <= amax <= _MAXA:
        raise ValueError(f"amax={amax} must hold every part's alpha and "
                         f"be at most {_MAXA}")
    if any(p.lo < lo_base or p.hi - lo_base > pack.num_channels
           for p in parts):
        raise ValueError("a part's rows lie outside the level pack")
    C = a.shape[-2] if a.dim() >= 2 else 0
    if C != pack.num_channels:
        raise ValueError(f"a has {C} rows, the level pack "
                         f"{pack.num_channels}")
    B, a_bs = _rows_view(a, C, "a")
    if not 1 <= len(parts) <= _MAX_GRID:
        raise ValueError(f"{len(parts)} parts")
    N = a.shape[-1]
    tab = digits_table(parts, lp, lo_base)
    _check_views(a.device, pack.dtype, a=a)
    _check(a.device, pack.dtype, table=tab)
    st = torch.empty((*a.shape[:-2], len(parts), amax, N), dtype=a.dtype,
                     device=a.device)
    rc = _entry("tt_parts_digits", pack)(
        _ptr(a), a_bs, _ptr(st), B, len(parts), amax, N, _ptr(tab), lo_base,
        _stream(a.device),
    )
    _done(rc, "parts_digits", pack)
    return st


# ----------------------------------------------------------------------
# G3 — the special rows of the P-division.
# ----------------------------------------------------------------------


def pdiv_p0_plain(cur, lp_spec, PiRs, C, S):
    """The successive division replayed on the special rows alone; only
    the rows a later division reads are updated."""
    rows = []
    for i in range(S):
        top = S - 1 - i
        rows.append(cur[..., top, :])
        if top:
            pk = lp_spec.pack[:top]
            upd = mont.mont_sub(cur[..., :top, :], cur[..., top:top + 1, :],
                                pk)
            cur = mont.mont_mult(upd, PiRs[i][C:C + top], pk)
    return torch.stack(rows, dim=-2)


def pdiv_p0(cur, lp_spec, PiRs, C, S):
    """The plain rows the successive P-division subtracts, in division
    order [..., S, N], from the canonical coefficient-domain special rows
    ``cur`` [..., S, N] (``lp_spec`` their pack, ``PiRs`` the level's
    division columns, whose special rows start at ``C``)."""
    if _on_cpu(cur):
        return pdiv_p0_plain(cur, lp_spec, PiRs, C, S)
    pack = lp_spec.pack
    if not 1 <= S <= _MAXS or pack.num_channels != S:
        raise ValueError(f"S={S} special rows with a pack of "
                         f"{pack.num_channels}: at most {_MAXS}, equal")
    B, cur_bs = _rows_view(cur, S, "cur")
    N = cur.shape[-1]
    cols = PiRs[: S - 1]
    _check_views(cur.device, pack.dtype, cur=cur)
    _check(cur.device, pack.dtype, q=pack.q, k=pack.k,
           **{f"PiRs[{i}]": col for i, col in enumerate(cols)})
    for i, col in enumerate(cols):
        if col.dim() != 2 or col.shape[0] < C + S or col.shape[1] != 1:
            raise ValueError(f"PiRs[{i}] shape {tuple(col.shape)}: want "
                             f"[>= {C + S}, 1]")
    # PiRs[i][C:], without making the views
    ptrs = (ctypes.c_void_p * _MAXS)(
        *(col.data_ptr() + C * col.element_size() for col in cols))
    p0 = torch.empty((*cur.shape[:-2], S, N), dtype=cur.dtype,
                     device=cur.device)
    rc = _entry("tt_pdiv_p0", pack)(
        _ptr(cur), cur_bs, _ptr(p0), B, S, N, ctypes.addressof(ptrs),
        _ptr(pack.q), _ptr(pack.k), _stream(cur.device),
    )
    _done(rc, "pdiv_p0", pack)
    return p0


# ----------------------------------------------------------------------
# G4 — the engine's modular add, subtract and product by a column.
# ----------------------------------------------------------------------

_MODEW_OPS = {"mont_scalar": 0, "mod_add": 1, "mod_sub": 2}  # TT_MONT_SCALAR..


def mont_scalar_plain(d, col, lp):
    return mont.reduce_2q(mont.mont_mult(d, col, lp.pack), lp.pack)


def mod_add_plain(a, b, lp):
    return mont.reduce_2q(mont.mont_add(a, b, lp.pack), lp.pack)


def mod_sub_plain(a, b, lp):
    return mont.reduce_2q(mont.mont_sub(a, b, lp.pack), lp.pack)


def _broadcast_leading(x, y):
    """The shape two operands of shapes ``x`` and ``y`` [..., C, N]
    broadcast to along their leading dimensions (torch's rule; C and N
    must agree)."""
    if len(x) < 2 or x[-2:] != y[-2:]:
        raise ValueError(f"a {x} and b {y}: only leading dimensions "
                         f"broadcast")
    n = max(len(x), len(y))
    lead = []
    for i, j in zip((1,) * (n - len(x)) + x[:-2], (1,) * (n - len(y)) + y[:-2]):
        if i != j and 1 not in (i, j):
            raise ValueError(f"a {x} and b {y} do not broadcast")
        lead.append(j if i == 1 else i)
    return (*lead, *x[-2:])


def _modew_geometry(pack, a, b=None, col=None):
    """G4's operands, checked on any device: (output shape, B, batch
    strides of ``a``, ``b`` and ``col``).  ``a`` and ``b`` are [..., C, N]
    (C the pack's channels) and broadcast along their leading dimensions;
    each, broadcast to the output, must fold into [B, C, N] with one batch
    stride, 0 where it repeats.  ``col`` is [C, 1], or [B, C, 1] for ``a``
    [B, C, N]."""
    C = pack.num_channels
    dev = a.device
    _check_views(dev, pack.dtype, a=a,
                 **{n: t for n, t in (("b", b), ("col", col))
                    if t is not None})
    _check(dev, pack.dtype, q=pack.q, k=pack.k)
    shape = tuple(a.shape)
    if b is not None and tuple(b.shape) != shape:
        shape = _broadcast_leading(shape, tuple(b.shape))
    B, a_bs = _rows_view(a if a.shape == shape else a.expand(shape), C, "a")
    b_bs = 0
    if b is not None:
        b_bs = _rows_view(b if b.shape == shape else b.expand(shape), C,
                          "b")[1]
    col_bs = 0
    if col is not None:
        if tuple(col.shape) == (C, 1):
            col_bs = 0
        elif len(shape) == 3 and tuple(col.shape) == (B, C, 1):
            col_bs = C
        else:
            raise ValueError(f"col shape {tuple(col.shape)}: want {(C, 1)}"
                             f" or [B, {C}, 1] for a [B, {C}, N]")
    return shape, B, a_bs, b_bs, col_bs


def _modew(op, pack, a, b, col, geometry):
    shape, B, a_bs, b_bs, col_bs = geometry
    if col is not None:
        col = col.contiguous()
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    rc = _entry("tt_modew", pack)(
        _MODEW_OPS[op], _ptr(a), a_bs, _ptr(b), b_bs, _ptr(out), B,
        pack.num_channels, shape[-1], _ptr(col), col_bs, _ptr(pack.q),
        _ptr(pack.k), _stream(a.device),
    )
    _done(rc, op, pack)
    return out


def mont_scalar(d, col, lp):
    """``d`` [..., C, N] in [0, q) times ``col`` (REDC), canonical in [0,
    q): one constant in [0, q) a channel ([C, 1]), or a channel and
    stacked ciphertext ([B, C, 1] for ``d`` [B, C, N])."""
    geometry = _modew_geometry(lp.pack, d, col=col)
    if _on_cpu(d):
        return mont_scalar_plain(d, col, lp)
    return _modew("mont_scalar", lp.pack, d, None, col, geometry)


def mod_add(a, b, lp):
    """``a + b`` mod q, canonical in [0, q), for ``a`` and ``b`` [..., C,
    N] in [0, 2q), broadcast along their leading dimensions."""
    geometry = _modew_geometry(lp.pack, a, b)
    if _on_cpu(a):
        return mod_add_plain(a, b, lp)
    return _modew("mod_add", lp.pack, a, b, None, geometry)


def mod_sub(a, b, lp):
    """``a - b`` mod q, canonical in [0, q), for ``a`` and ``b`` [..., C,
    N] in [0, 2q), broadcast along their leading dimensions."""
    geometry = _modew_geometry(lp.pack, a, b)
    if _on_cpu(a):
        return mod_sub_plain(a, b, lp)
    return _modew("mod_sub", lp.pack, a, b, None, geometry)
