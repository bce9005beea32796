"""The Hopper kernels of the cc_mult path: wrappers and plain versions.

Each TPU kernel of ``tiberate_tpu/ops/pallas_mxu.py`` on the path has a
wrapper here and a plain torch version beside it:

========  =====================  ===========================================
kernel    wrapper                what it computes
========  =====================  ===========================================
K1        :func:`ntt`            forward NTT, optional x R entry
K2        :func:`intt`           inverse NTT x N^-1, "mont"/"exit"/
                                 "exit_reduce"
K3        :func:`ntt_keymul`     forward NTT, then one or two key products
K3 accum  :func:`ntt_keymul_accum` one part of the mesh's chain: forward
                                 NTT, both key products added in place
                                 into two accumulators, a skip range of
                                 channels passed through
K4        :func:`intt_pdiv`      inverse NTT + P-division, canonical
K5        :func:`ntt_tensor`     four enter-NTTs + the ciphertext tensor
                                 product
K6        :func:`ntt_keymul_parts` all keyswitch parts: signed-digit basis
                                 extension, NTT, both evk products, part-sum
========  =====================  ===========================================

A wrapper dispatches on the device of its input: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel (built from ``csrc/`` at
first use, :mod:`tiberate_tpu_torch.ops.cuda_build`); any other device
raises.  There is no fallback from a CUDA tensor to the plain version.

Each kernel has two lanes, chosen by the dtype of the level pack: int64
operands (R = 2^62) launch the 62-bit entry point, int32 operands
(R = 2^30, the 30-bit mode) the ``_30`` one.  An operand whose dtype is
not the pack's raises; nothing is converted.  Every launch adds one to
:data:`LAUNCHES` under the wrapper's name, with ``_30`` appended for the
30-bit lane (:func:`_done`, where every kernel of the port counts).  Each
wrapper here launches two CUDA kernels, the transform's strided and
contiguous passes (``_PASSES``); the glue's and the CSPRNG's one.  While
a span of :mod:`tiberate_tpu_torch.utils.trace` is open, those CUDA
kernels, or on a CPU tensor those the plain version stands in for, are
counted in the open spans, and the first stamps the root span.

The kernels run the plain versions' butterflies, twiddles, operand order
and lazy reductions, so their outputs are bit-identical to the plain
versions, lazy outputs included.  One exception: K6's 62-bit lane sums
its products exactly and reduces each sum once, so its lazy accumulators
equal the plain version's residue for residue, in [0, 2q), and
everything canonical downstream of them byte for byte.
"""

import math
from typing import NamedTuple

import torch

from tiberate_tpu_torch.ops import cuda_build, mont
from tiberate_tpu_torch.ops import ntt as ntt_ops
from tiberate_tpu_torch.utils import trace

WRAPPERS = ("ntt", "intt", "ntt_keymul", "ntt_keymul_accum", "intt_pdiv",
            "ntt_tensor", "ntt_keymul_parts")
# storage dtype -> suffix of the lane's C entry points and launch counts
LANES = {torch.int64: "", torch.int32: "_30"}
LAUNCHES = dict.fromkeys(
    (name + sfx for sfx in LANES.values() for name in WRAPPERS), 0)

_PASSES = 2  # CUDA kernels a launch of one of the WRAPPERS runs
_INTT_EPILOGUES = {"mont": 0, "exit": 1, "exit_reduce": 2}
_MAX_ROWS = 65535  # a launch's grid.y: one block row per polynomial row
_EPI_PDIV = 3


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Dispatch and checks.
# ----------------------------------------------------------------------


def _on_cpu(x, kernels=1) -> bool:
    """True for a CPU tensor: the wrapper runs its plain version in the
    place of ``kernels`` CUDA kernels, which the open trace spans count."""
    if x.device.type == "cpu":
        if trace._root is not None:
            trace._launched(kernels)
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device} (cpu or cuda)")
    return False


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lane(pack):
    """The lane suffix of a pack's storage dtype ("" or "_30")."""
    if pack.dtype not in LANES:
        raise TypeError(f"no kernel lane for dtype {pack.dtype}")
    return LANES[pack.dtype]


def _entry(name, pack):
    """The lane's C entry point: ``name`` (62-bit) or ``name + "_30"``."""
    return getattr(cuda_build.lib(), name + _lane(pack))


def _done(rc, name, pack=None):
    """Raise on a failed launch; count a good one under ``name``, with the
    lane's suffix where the kernel has lanes (``pack``)."""
    key = name if pack is None else name + _lane(pack)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    if trace._root is not None:
        trace._launched(_PASSES if name in WRAPPERS else 1)


def _check(device, dtype, **tensors):
    """Every operand on ``device``, of the lane's storage ``dtype`` (int32
    for ``alphas`` in both lanes) and contiguous — the kernels take raw
    pointers."""
    for name, t in tensors.items():
        if t is None:
            continue
        want = torch.int32 if name == "alphas" else dtype
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(rows):
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} polynomial rows in one launch; the "
                         f"kernels take at most {_MAX_ROWS}")


def _geometry(x, C):
    """(rows, logN) of a [..., C, N] operand; N a power of two in 2^4..2^17."""
    if x.dim() < 2 or x.shape[-2] != C:
        raise ValueError(f"expected [..., {C}, N], got {tuple(x.shape)}")
    N = x.shape[-1]
    logN = N.bit_length() - 1
    if N != 1 << logN or not 4 <= logN <= 17:
        raise ValueError(f"N={N} must be a power of two in [2^4, 2^17]")
    rows = math.prod(x.shape[:-1])
    _check_rows(rows)
    return rows, logN


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------
# K1 — forward NTT.
# ----------------------------------------------------------------------


def ntt_plain(x, lp, enter: bool):
    if enter:
        return ntt_ops.enter_ntt(x, lp.Rs, lp.psi, lp.pack)
    return ntt_ops.ntt(x, lp.psi, lp.pack)


def ntt(x, lp, enter: bool):
    """Forward NTT of ``x`` [..., C, N] (``enter``: x R first)."""
    if _on_cpu(x, _PASSES):
        return ntt_plain(x, lp, enter)
    C = lp.num_channels
    rows, logN = _geometry(x, C)
    _check(x.device, lp.pack.dtype, x=x, q=lp.pack.q, k=lp.pack.k,
           psi=lp.psi, Rs=lp.Rs)
    out = torch.empty_like(x)
    rc = _entry("tt_ntt_fwd", lp.pack)(
        _ptr(x), _ptr(out), None, rows, C, logN, _ptr(lp.pack.q),
        _ptr(lp.pack.k), _ptr(lp.psi), _ptr(lp.Rs) if enter else None,
        None, None, 0, _stream(x.device),
    )
    _done(rc, "ntt", lp.pack)
    return out


# ----------------------------------------------------------------------
# K2 — inverse NTT.
# ----------------------------------------------------------------------


def intt_plain(x, lp, epilogue: str):
    if epilogue == "mont":
        return ntt_ops.intt(x, lp.ipsi, lp.Ninv, lp.pack)
    if epilogue == "exit":
        return ntt_ops.intt_exit(x, lp.ipsi, lp.Ninv, lp.pack)
    if epilogue == "exit_reduce":
        return ntt_ops.intt_exit_reduce(x, lp.ipsi, lp.Ninv, lp.pack)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def intt(x, lp, epilogue: str):
    """Inverse NTT x N^-1 of ``x`` [..., C, N]; ``epilogue`` "mont" keeps
    R, "exit" strips it, "exit_reduce" also reduces to [0, q)."""
    if _on_cpu(x, _PASSES):
        return intt_plain(x, lp, epilogue)
    if epilogue not in _INTT_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    C = lp.num_channels
    rows, logN = _geometry(x, C)
    _check(x.device, lp.pack.dtype, x=x, q=lp.pack.q, k=lp.pack.k,
           ipsi=lp.ipsi, Ninv=lp.Ninv)
    out = torch.empty_like(x)
    rc = _entry("tt_ntt_inv", lp.pack)(
        _ptr(x), _ptr(out), rows, C, C, logN, _ptr(lp.pack.q),
        _ptr(lp.pack.k), _ptr(lp.ipsi), _ptr(lp.Ninv),
        _INTT_EPILOGUES[epilogue], None, None, 0, _stream(x.device),
    )
    _done(rc, "intt", lp.pack)
    return out


# ----------------------------------------------------------------------
# K3 — forward NTT fused with key multiplies.
# ----------------------------------------------------------------------


def ntt_keymul_plain(x, lp, keys, enter: bool):
    X = ntt_plain(x, lp, enter)
    return tuple(mont.mont_mult(X, key, lp.pack) for key in keys)


def ntt_keymul(x, lp, keys, enter: bool):
    """``t_i = NTT(x) * keys[i] * R^-1`` for one or two ``[C, N]`` keys
    (NTT-domain, Montgomery form)."""
    if _on_cpu(x, _PASSES):
        return ntt_keymul_plain(x, lp, keys, enter)
    if len(keys) not in (1, 2):
        raise ValueError("ntt_keymul takes one or two keys")
    C = lp.num_channels
    rows, logN = _geometry(x, C)
    key0 = keys[0]
    key1 = keys[1] if len(keys) == 2 else None
    for key in keys:
        if tuple(key.shape) != tuple(x.shape[-2:]):
            raise ValueError(f"key shape {tuple(key.shape)} != [C, N]")
    _check(x.device, lp.pack.dtype, x=x, q=lp.pack.q, k=lp.pack.k,
           psi=lp.psi, Rs=lp.Rs, key0=key0, key1=key1)
    out0 = torch.empty_like(x)
    out1 = torch.empty_like(x) if key1 is not None else None
    rc = _entry("tt_ntt_fwd", lp.pack)(
        _ptr(x), _ptr(out0), _ptr(out1), rows, C, logN, _ptr(lp.pack.q),
        _ptr(lp.pack.k), _ptr(lp.psi), _ptr(lp.Rs) if enter else None,
        _ptr(key0), _ptr(key1), len(keys), _stream(x.device),
    )
    _done(rc, "ntt_keymul", lp.pack)
    return (out0,) if key1 is None else (out0, out1)


def _skip_bounds(skip, C):
    """(lo, hi) of a channel skip range; None skips nothing (0, 0)."""
    if skip is None:
        return 0, 0
    lo, hi = skip
    if not 0 <= lo < hi <= C:
        raise ValueError(f"skip range {skip} must satisfy 0 <= lo < hi <= {C}")
    return lo, hi


def ntt_keymul_accum_plain(x, lp, keys, acc, skip):
    """``mont_add(acc_i, mont_mult(ntt(x), k_i))`` on the channels outside
    ``skip``, written into ``acc`` in place; returns ``acc``."""
    C = lp.num_channels
    lo, hi = _skip_bounds(skip, C)
    for a, b in ((0, lo), (hi, C)):
        if a == b:
            continue
        lps = lp[a:b]
        X = ntt_plain(x[..., a:b, :], lps, enter=False)
        for ac, key in zip(acc, keys):
            ac[..., a:b, :] = mont.mont_add(
                ac[..., a:b, :], mont.mont_mult(X, key[a:b], lps.pack),
                lps.pack)
    return acc


def ntt_keymul_accum(x, lp, keys, acc, skip):
    """One part of the per-part keyswitch chain (the mesh switcher's,
    :mod:`tiberate_tpu_torch.parallel.rns_sharded`).

    ``x`` [..., C, N] the part's basis extension (Montgomery form, no x R
    entry); ``keys`` the part's two evk rows, each [C, N]; ``acc`` two
    lazy [0, 2q) accumulators shaped like ``x``, updated IN PLACE:
    ``acc_i = acc_i (+) REDC(NTT(x) * k_i)`` on every channel outside
    ``skip`` = (lo, hi) (None: all channels).  The skipped channels' rows
    stay as they were and are not transformed, for a caller that seeded
    those rows' products into ``acc`` itself.  Returns ``acc``.
    """
    if _on_cpu(x, _PASSES):
        return ntt_keymul_accum_plain(x, lp, keys, acc, skip)
    C = lp.num_channels
    rows, logN = _geometry(x, C)
    lo, hi = _skip_bounds(skip, C)
    if len(keys) != 2 or len(acc) != 2:
        raise ValueError("ntt_keymul_accum takes two keys and two "
                         "accumulators")
    key0, key1 = keys
    acc0, acc1 = acc
    for key in keys:
        if tuple(key.shape) != tuple(x.shape[-2:]):
            raise ValueError(f"key shape {tuple(key.shape)} != [C, N]")
    for a in acc:
        if a.shape != x.shape:
            raise ValueError(f"accumulator shape {tuple(a.shape)} != "
                             f"{tuple(x.shape)}")
    _check(x.device, lp.pack.dtype, x=x, q=lp.pack.q, k=lp.pack.k,
           psi=lp.psi, key0=key0, key1=key1, acc0=acc0, acc1=acc1)
    tmp = torch.empty_like(x)
    rc = _entry("tt_ntt_keymul_accum", lp.pack)(
        _ptr(x), _ptr(tmp), _ptr(acc0), _ptr(acc1), rows, C, logN,
        _ptr(lp.pack.q), _ptr(lp.pack.k), _ptr(lp.psi), _ptr(key0),
        _ptr(key1), lo, hi, _stream(x.device),
    )
    _done(rc, "ntt_keymul_accum", lp.pack)
    return acc


# ----------------------------------------------------------------------
# K4 — inverse NTT fused with the P-division.
# ----------------------------------------------------------------------


def pdiv_plain(d, p0, lp_ord, PiRs):
    """The successive rescale of ``_switcher_body`` on canonical
    coefficient-domain ordinary rows ``d`` [..., C, N]: enter, S x
    (subtract P0, multiply P^-1), exit, reduce."""
    C = lp_ord.num_channels
    pk = lp_ord.pack
    d = mont.mont_enter(d, lp_ord.Rs, pk)
    for i in range(p0.shape[-2]):
        P0 = mont.mont_enter(p0[..., i : i + 1, :], lp_ord.Rs, pk)
        d = mont.mont_sub(d, P0, pk)
        d = mont.mont_mult(d, PiRs[i][:C], pk)
    return mont.reduce_2q(mont.mont_reduce(d, pk), pk)


def intt_pdiv_plain(acc, p0, lp_ord, PiRs):
    """iNTT-exit of the ordinary rows, then :func:`pdiv_plain`."""
    C = lp_ord.num_channels
    d = intt_plain(acc[..., :C, :], lp_ord, "exit_reduce")
    return pdiv_plain(d, p0, lp_ord, PiRs)


def intt_pdiv(acc, p0, lp_ord, PiRs):
    """Divide a keyswitch accumulator by P: ``acc`` [..., C_in, N], C_in >=
    C (NTT domain; only its first C rows, the ordinary ones, are read: the
    rest are its special rows, all S of them or a shard's share), ``p0``
    [..., S, N] the
    plain special rows of the successive division, in division order.
    Returns canonical [0, q) ordinary rows [..., C, N].

    The kernel evaluates the division in its affine form with
    ``lp_ord.pdc`` (see ``CkksParams``); the plain version runs the
    successive chain with ``PiRs``.  Both give the canonical residue.
    """
    if _on_cpu(acc, _PASSES):
        return intt_pdiv_plain(acc, p0, lp_ord, PiRs)
    C = lp_ord.num_channels
    S = p0.shape[-2]
    C_in = acc.shape[-2]
    if C_in < C or lp_ord.pdc.shape[-1] != 1 + S:
        raise ValueError("acc must carry at least C rows and pdc 1 + S "
                         "columns")
    rows_in, logN = _geometry(acc, C_in)
    B = rows_in // C_in
    if tuple(p0.shape) != (*acc.shape[:-2], S, acc.shape[-1]):
        raise ValueError(f"p0 shape {tuple(p0.shape)} does not match acc")
    _check(acc.device, lp_ord.pack.dtype, acc=acc, p0=p0, q=lp_ord.pack.q,
           k=lp_ord.pack.k, ipsi=lp_ord.ipsi, Ninv=lp_ord.Ninv,
           pdc=lp_ord.pdc)
    out = torch.empty((*acc.shape[:-2], C, acc.shape[-1]),
                      dtype=acc.dtype, device=acc.device)
    rc = _entry("tt_ntt_inv", lp_ord.pack)(
        _ptr(acc), _ptr(out), B * C, C, C_in, logN, _ptr(lp_ord.pack.q),
        _ptr(lp_ord.pack.k), _ptr(lp_ord.ipsi), _ptr(lp_ord.Ninv),
        _EPI_PDIV, _ptr(p0), _ptr(lp_ord.pdc), S, _stream(acc.device),
    )
    _done(rc, "intt_pdiv", lp_ord.pack)
    return out


# ----------------------------------------------------------------------
# K5 — tensor product.
# ----------------------------------------------------------------------


def ntt_tensor_plain(x0, x1, y0, y1, lp):
    pk = lp.pack
    x0 = ntt_plain(x0, lp, enter=True)
    x1 = ntt_plain(x1, lp, enter=True)
    y0 = ntt_plain(y0, lp, enter=True)
    y1 = ntt_plain(y1, lp, enter=True)
    d0 = mont.mont_mult(x0, y0, pk)
    d1 = mont.mont_add(
        mont.mont_mult(x0, y1, pk), mont.mont_mult(x1, y0, pk), pk
    )
    d2 = mont.mont_mult(x1, y1, pk)
    return d0, d1, d2


def ntt_tensor(x0, x1, y0, y1, lp):
    """Enter-NTT all four and return ``(x0y0, x0y1 + x1y0, x1y1)``."""
    if _on_cpu(x0, _PASSES):
        return ntt_tensor_plain(x0, x1, y0, y1, lp)
    C = lp.num_channels
    rows, logN = _geometry(x0, C)
    for t in (x1, y0, y1):
        if t.shape != x0.shape:
            raise ValueError("ntt_tensor operands must share one shape")
    _check(x0.device, lp.pack.dtype, x0=x0, x1=x1, y0=y0, y1=y1,
           q=lp.pack.q, k=lp.pack.k, psi=lp.psi, Rs=lp.Rs)
    tmp = torch.empty((4, *x0.shape), dtype=x0.dtype, device=x0.device)
    d0, d1, d2 = (torch.empty_like(x0) for _ in range(3))
    rc = _entry("tt_ntt_tensor", lp.pack)(
        _ptr(x0), _ptr(x1), _ptr(y0), _ptr(y1), _ptr(tmp), _ptr(d0),
        _ptr(d1), _ptr(d2), rows, C, logN, _ptr(lp.pack.q), _ptr(lp.pack.k),
        _ptr(lp.psi), _ptr(lp.Rs), _stream(x0.device),
    )
    _done(rc, "ntt_tensor", lp.pack)
    return d0, d1, d2


# ----------------------------------------------------------------------
# K6 — all keyswitch parts.
# ----------------------------------------------------------------------


def ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp, tables=None):
    """Per part: basis extension of the digits (``_extend``), NTT, both
    key products; parts summed with ``mont_add`` in part order.
    ``tables`` is the kernel's and is not read here."""
    pk = lp_sp.pack
    d0 = d1 = None
    for p, ((k0, k1), alpha) in enumerate(zip(keys, alphas.tolist())):
        ext = mont.mont_enter(st[..., p, 0:1, :], ec[p, :, 0:1], pk)
        for i in range(1, alpha):
            Y = mont.mont_mult(st[..., p, i : i + 1, :], ec[p, :, i : i + 1],
                               pk)
            ext = mont.mont_add(ext, Y, pk)
        ext = ntt_plain(ext, lp_sp, enter=False)
        t0 = mont.mont_mult(ext, k0, pk)
        t1 = mont.mont_mult(ext, k1, pk)
        if d0 is None:
            d0, d1 = t0, t1
        else:
            d0 = mont.mont_add(d0, t0, pk)
            d1 = mont.mont_add(d1, t1, pk)
    return d0, d1


class KeyTables(NamedTuple):
    """K6's key operand in place: the parts' base pointers, on the host
    (``ptrs``: one (k0, k1) pair a part) and as the two [n_parts] int64
    tables the kernel reads (``k0p``, ``k1p``, on the keys' device)."""

    ptrs: tuple
    k0p: torch.Tensor
    k1p: torch.Tensor


def key_tables(keys) -> KeyTables:
    """The pointer tables of ``keys`` (a tuple over parts of (k0, k1)
    views).  They point into the views' storage: a holder keeps the views
    alive beside them."""
    ptrs = tuple((k0.data_ptr(), k1.data_ptr()) for k0, k1 in keys)
    dev = keys[0][0].device
    k0p, k1p = (torch.tensor([pp[i] for pp in ptrs], dtype=torch.int64,
                             device=dev) for i in range(2))
    return KeyTables(ptrs, k0p, k1p)


def _check_part_keys(keys, n_parts, C_sp, N, device, dtype):
    """Each part's (k0, k1): a [C_sp, N] view with contiguous rows, of the
    lane's dtype, on ``device``, 16-byte aligned (the kernel's vector
    loads)."""
    if len(keys) != n_parts:
        raise ValueError(f"{len(keys)} key parts for {n_parts} digit parts")
    views = {f"key part {p} k{i}": key for p, pair in enumerate(keys)
             for i, key in enumerate(pair)}
    _check(device, dtype, **views)
    for name, key in views.items():
        if tuple(key.shape) != (C_sp, N):
            raise ValueError(f"{name} shape {tuple(key.shape)} != "
                             f"{(C_sp, N)}")
        if key.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def sum_runs(q) -> tuple[int, int]:
    """How long K6's sums run in the 62-bit lane over moduli ``q`` (Python
    ints): the most digits pass 1 sums before it reduces, and the most
    parts pass 2 adds to a sum between two folds, such that a sum's high
    word H keeps H (q - 1) + 2^64 <= q 2^62 for every modulus
    (``mont.cuh``, "Sums of products"), the bound under which its fold
    and REDC land in [0, 2q).  Pass 1 sums digits (any int64) times
    constants in [0, q): |H| <= ceil(run (q - 1) / 2).  Pass 2 starts a
    run from 0 or from a fold, at most (2^64 - 1) q, and each part adds a
    word in [0, 2q) times a key in [0, q).  Below 2^60 they are at least
    7 and 23; capped at 2^30 (an int of the kernel)."""
    digits = parts = 1 << 30
    for qi in q:
        h = ((qi << 62) - (1 << 64)) // (qi - 1)  # the largest H
        digits = min(digits, 2 * h // (qi - 1))
        parts = min(parts, (((h + 1) << 64) - 1 - ((1 << 64) - 1) * qi)
                    // ((2 * qi - 1) * (qi - 1)))
    if min(digits, parts) < 1:
        raise ValueError(f"moduli of {max(q).bit_length()} bits leave no "
                         f"room for K6's sums in the 62-bit lane")
    return digits, parts


def ntt_keymul_parts(st, ec, alphas, keys, lp_sp, tables=None):
    """The whole keyswitch part loop.

    st: [..., n_parts, amax, N] signed mixed-radix digits (zero-padded to
    ``amax``); ec: [n_parts, C_sp, amax] extension constants (``Rs``, then
    the part's ``L_enter`` rows); alphas: [n_parts] int32 digit counts;
    keys: a tuple over parts of (k0, k1), each a [C_sp, N] view that the
    kernel reads in place; tables: their :func:`key_tables` (built here
    when None; callers that switch with one key many times cache them).
    Returns the two lazy accumulators, each [..., C_sp, N].

    The 62-bit lane sums each output word's products exactly, in 128
    bits, in runs of ``lp_sp.sum_runs`` (:func:`sum_runs`), and reduces
    once: its accumulators lie in [0, 2q) and equal the plain version's
    residue for residue, not word for word (the plain version reduces
    every product).
    """
    if _on_cpu(st, _PASSES):
        return ntt_keymul_parts_plain(st, ec, alphas, keys, lp_sp)
    C_sp = lp_sp.num_channels
    n_parts, amax, N = st.shape[-3:]
    if tuple(ec.shape) != (n_parts, C_sp, amax):
        raise ValueError(f"ec shape {tuple(ec.shape)} != "
                         f"{(n_parts, C_sp, amax)}")
    if tuple(alphas.shape) != (n_parts,):
        raise ValueError("alphas must hold one count per part")
    _check_part_keys(keys, n_parts, C_sp, N, st.device, lp_sp.pack.dtype)
    if tables is None:
        tables = key_tables(keys)
    elif tables.ptrs != tuple((k0.data_ptr(), k1.data_ptr())
                              for k0, k1 in keys):
        raise ValueError("key tables do not point at these keys")
    lead = st.shape[:-3]
    B = math.prod(lead)
    _check_rows(B * n_parts * C_sp)
    _, logN = _geometry(keys[0][0], C_sp)
    _check(st.device, lp_sp.pack.dtype, st=st, ec=ec, alphas=alphas,
           q=lp_sp.pack.q, k=lp_sp.pack.k, psi=lp_sp.psi, fold=lp_sp.fold)
    _check(st.device, torch.int64, k0p=tables.k0p, k1p=tables.k1p)
    tmp = torch.empty((B, n_parts, C_sp, N), dtype=st.dtype,
                      device=st.device)
    acc0 = torch.empty((*lead, C_sp, N), dtype=st.dtype, device=st.device)
    acc1 = torch.empty_like(acc0)
    rc = _entry("tt_ntt_keymul_parts", lp_sp.pack)(
        _ptr(st), _ptr(ec), _ptr(alphas), _ptr(tmp), _ptr(tables.k0p),
        _ptr(tables.k1p), _ptr(acc0), _ptr(acc1), B, n_parts, amax, C_sp,
        logN, _ptr(lp_sp.pack.q), _ptr(lp_sp.pack.k), _ptr(lp_sp.psi),
        _ptr(lp_sp.fold), *lp_sp.sum_runs, _stream(st.device),
    )
    _done(rc, "ntt_keymul_parts", lp_sp.pack)
    return acc0, acc1
