"""The stacked linear op's modular matrix product as a Hopper kernel:
wrapper and plain version.

:func:`matmul` computes, for both polynomials of a stack of F_in
ciphertexts ``x`` [F_in, C, N] at one level,

    out[j] = (acc[j] +) sum_i W[i, j] x[i]  mod q_c

with one signed integer weight ``W[i, j]`` for every channel (``csrc/
matmul.cu``).  The weights reach it once, as :func:`weight_limbs`: L
balanced limbs of ``LIMB_BITS`` bits, ``W = sum_l w_l 2^(21 l)``, each
``w_l`` in [-2^20, 2^20], as float64 on the device (L = 1 for ``|W| <=
2^20``, 2 below about 2^41, 3 up to ``MAX_WEIGHT``, about 2^62: any
weight of a 62-bit word).  The kernel sums limb products exactly
in float64 and reduces each output word once; a sum longer than
:func:`matmul_run` input features runs in pieces, each piece's output the
next one's accumulator.

As in :mod:`~tiberate_tpu_torch.ops.ntt_kernels`: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises, any other
device raises; the lane comes from the level pack's dtype; every launch
adds one to ``ntt_kernels.LAUNCHES`` under ``matmul`` (``matmul_30`` in
the 30-bit lane), and the plain version counts one kernel a piece in the
open trace spans.  The operands are checked on every device, so that a
CPU run refuses what the kernel would.  The output is canonical in [0,
q) and unique, so the kernel's bytes are the plain version's.
"""

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

WRAPPERS = ("matmul",)
LAUNCHES = kern.LAUNCHES
LAUNCHES.update(dict.fromkeys(
    (name + sfx for sfx in LANES.values() for name in WRAPPERS), 0))

LIMB_BITS = 21                     # TT_MM_LB: bits of a limb
_HALF = 1 << (LIMB_BITS - 1)
MAX_LIMBS = 3                      # TT_MM_L: most limbs of a weight
_TILE_N = 64                       # TT_MM_TN: N a multiple of it


def limb_max(L: int) -> int:
    """The largest positive weight L balanced limbs hold: the top limb
    2^20, each lower one 2^20 - 1 (the least is ``-limb_max(L) - 1`` and
    below)."""
    return sum((_HALF - (l < L - 1)) << (LIMB_BITS * l) for l in range(L))


MAX_WEIGHT = limb_max(MAX_LIMBS)   # 2^62 + 2^41 - 2^20 - 1


def matmul_run(L: int) -> int:
    """The most input features one kernel sums before it reduces: a sum
    of shift s takes at most L limb products a feature (a residue has at
    least two limbs), each below 2^21 x 2^20 in magnitude, and must stay
    an integer below 2^53, exact in float64 (4096 at L = 1, 2048 at L =
    2, 1365 at L = 3)."""
    return ((1 << 53) - 1) // (L * ((1 << LIMB_BITS) - 1) * _HALF)


def weight_limbs(weights: torch.Tensor) -> torch.Tensor:
    """Signed integer weights ``W`` [F_in, F_out] (int64) -> their balanced
    limbs [L, F_in, F_out] float64 on the same device, with the fewest L
    (1 to 3) whose top limb lies in [-2^20, 2^20]; raises past
    ``MAX_WEIGHT``."""
    if weights.dim() != 2 or weights.dtype != torch.int64:
        raise ValueError(f"weights must be int64 [F_in, F_out], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    for L in range(1, MAX_LIMBS + 1):
        limbs, r = [], weights
        for _ in range(L - 1):
            lo = ((r + _HALF) & ((1 << LIMB_BITS) - 1)) - _HALF
            limbs.append(lo)
            r = (r - lo) >> LIMB_BITS
        if bool(((r >= -_HALF) & (r <= _HALF)).all()):   # no abs(-2^63)
            return torch.stack([*limbs, r]).to(torch.float64)
    raise ValueError(f"a weight integer of {int(weights.abs().max())} "
                     f"exceeds {MAX_WEIGHT}, the most {MAX_LIMBS} limbs of "
                     f"{LIMB_BITS} bits hold")


def _geometry(x0, x1, wl, lp, acc):
    """The operands, checked on any device: (F_in, F_out, L, C, N)."""
    pack = lp.pack
    C = pack.num_channels
    for name, t in (("x0", x0), ("x1", x1)):
        if t.dim() != 3 or t.shape[1] != C:
            raise ValueError(f"{name}: expected [F_in, {C}, N], got "
                             f"{tuple(t.shape)}")
        if t.device != x0.device or t.dtype != pack.dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{pack.dtype} on {x0.device}")
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError(f"{name}: coefficients must be contiguous and "
                             f"rows N words apart (strides {t.stride()})")
    if x1.shape != x0.shape or x1.stride() != x0.stride():
        raise ValueError(f"x1 {tuple(x1.shape)} / {x1.stride()} is not laid "
                         f"out as x0 {tuple(x0.shape)} / {x0.stride()}")
    F_in, _, N = x0.shape
    if N % _TILE_N:
        raise ValueError(f"N = {N}: the kernel takes multiples of {_TILE_N}")
    if (wl.dim() != 3 or wl.dtype != torch.float64 or wl.shape[1] != F_in
            or not 1 <= wl.shape[0] <= MAX_LIMBS or wl.device != x0.device
            or not wl.is_contiguous()):
        raise ValueError(f"weight limbs: expected contiguous float64 [1..."
                         f"{MAX_LIMBS}, {F_in}, F_out] on {x0.device}, got "
                         f"{wl.dtype} {tuple(wl.shape)} on {wl.device}")
    F_out = wl.shape[2]
    if acc is not None:
        for name, t in zip(("acc0", "acc1"), acc):
            if tuple(t.shape) != (F_out, C, N) or not t.is_contiguous():
                raise ValueError(f"{name}: expected contiguous "
                                 f"{(F_out, C, N)}, got {tuple(t.shape)}")
            if t.device != x0.device or t.dtype != pack.dtype:
                raise TypeError(f"{name}: {t.dtype} on {t.device}")
    _check(x0.device, pack.dtype, q=pack.q, k=pack.k, fold=lp.fold,
           Rs=lp.Rs)
    return F_in, F_out, wl.shape[0], C, N


def _mulmod_const(r, consts, lp):
    """``r`` [..., C, N] int64 in [0, q) times one python int a channel,
    mod q, canonical (int64)."""
    pack = lp.pack
    q = [int(v) for v in pack.q.tolist()]
    if pack.dtype == torch.int64:
        col = torch.tensor([(c % p) * (1 << 62) % p for c, p in
                            zip(consts, q)], dtype=torch.int64,
                           device=r.device)[:, None]
        return mont.reduce_2q(mont.mont_mult(r, col, pack), pack)
    col = torch.tensor([c % p for c, p in zip(consts, q)],
                       dtype=torch.int64, device=r.device)[:, None]
    return r * col % pack.q.long()[:, None]


def matmul_plain(x0, x1, wl, lp, acc=None):
    """The exact residues in int64: the residue's three 21-bit limbs times
    the weight's limbs summed by ``einsum`` (each sum below 2^63 for any
    F_in below 2^21), each sum taken mod q, times 2^(21 s) mod q and
    added mod q."""
    F_in, F_out, L, C, N = _geometry(x0, x1, wl, lp, acc)
    q = lp.pack.q.long()[:, None]
    w = wl.to(torch.int64)
    mask = (1 << LIMB_BITS) - 1
    outs = []
    for p, x in enumerate((x0, x1)):
        xs = x.long()
        total = (torch.zeros((F_out, C, N), dtype=torch.int64)
                 if acc is None else acc[p].long())
        for a in range(3):
            xa = (xs >> (LIMB_BITS * a)) & mask
            for b in range(L):
                s = torch.remainder(torch.einsum("ij,icn->jcn", w[b], xa), q)
                shift = 1 << (LIMB_BITS * (a + b))
                total = torch.remainder(
                    total + _mulmod_const(s, [shift] * C, lp), q)
        outs.append(total.to(x.dtype))
    if acc is not None:
        for a_t, o in zip(acc, outs):
            a_t.copy_(o)
        return tuple(acc)
    return tuple(outs)


def matmul(x0, x1, wl, lp, acc=None):
    """``(acc +) sum_i W[i, j] x[i]`` mod q for both polynomials: ``x0``,
    ``x1`` [F_in, C, N] canonical residues of ``lp``'s channels (rows N
    words apart, one feature stride: a stacked ciphertext's data), ``wl``
    the weights' limbs [L, F_in, F_out] (:func:`weight_limbs`, on the
    device), ``acc`` None or a pair of contiguous [F_out, C, N] canonical
    accumulators, which it updates in place and returns.  Returns (out0,
    out1) [F_out, C, N], canonical in [0, q)."""
    F_in, F_out, L, C, N = _geometry(x0, x1, wl, lp, acc)
    run = matmul_run(L)
    pieces = range(0, F_in, run)
    if _on_cpu(x0, len(pieces)):
        return matmul_plain(x0, x1, wl, lp, acc)
    pack = lp.pack
    out = acc or tuple(torch.empty((F_out, C, N), dtype=x0.dtype,
                                   device=x0.device) for _ in range(2))
    x_fs, w_ls = x0.stride(0), wl.stride(0)
    word, wword = x0.element_size(), wl.element_size()
    for i, k0 in enumerate(pieces):
        k = min(run, F_in - k0)
        prev = acc if i == 0 else out
        rc = _entry("tt_matmul", pack)(
            x0.data_ptr() + k0 * x_fs * word, x1.data_ptr() + k0 * x_fs * word,
            x_fs, wl.data_ptr() + k0 * F_out * wword, w_ls, L, k, F_out,
            _ptr(prev[0]) if prev else None, _ptr(prev[1]) if prev else None,
            _ptr(out[0]), _ptr(out[1]), C, N, _ptr(pack.q), _ptr(pack.k),
            _ptr(lp.fold), _ptr(lp.Rs), _stream(x0.device),
        )
        _done(rc, "matmul", pack)
    return tuple(out)
