"""The stacked linear op's modular matrix product as a Hopper kernel:
wrapper and plain version.

:func:`matmul` computes, for both polynomials of a stack of F_in
ciphertexts ``x`` [F_in, C, N] at one level,

    out[j] = (acc[j] +) sum_i W[i, j] x[i]  mod q_c

with one signed integer weight ``W[i, j]`` for every channel (``csrc/
matmul.cu``).  The weights reach it once, as :func:`weight_limbs`: L
balanced signed bytes, ``W = sum_b w_b 2^(8 b)``, each ``w_b`` in [-128,
127], as int8 [L, F_in, F_out] on the device, laid out F_in fastest (the
tensor cores' A operand, K-major), with the fewest L that hold them (5 for
weights below about 2^39, 8 up to ``MAX_WEIGHT``, above 2^62: any weight
of a 62-bit word).  The kernel multiplies them by the residues' bytes on
the int8 tensor cores, sums the products of each shift class exactly in
int32 and reduces each output word once; a sum longer than
:func:`matmul_run` input features runs in pieces, each piece's output the
next one's accumulator.

As in :mod:`~tiberate_tpu_torch.ops.ntt_kernels`: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises, any other
device raises; the lane comes from the level pack's dtype; every launch
adds one to ``ntt_kernels.LAUNCHES`` under ``matmul`` (``matmul_30`` in
the 30-bit lane), the int8 products it issues to :data:`INT8_PRODUCTS`
and the modular products it computes to :data:`MOD_PRODUCTS`, under the
same name; the plain version counts one kernel a piece in the open trace
spans.  The operands are checked on every device, so that a CPU run
refuses what the kernel would.  The output is canonical in [0, q) and
unique, so the kernel's bytes are the plain version's.
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
# The engagement counters, under the launch counts' names: int8 products
# (multiply-adds on the tensor cores) the launches issue, reckoned from
# the shapes, the channels' residue bytes and L, and the modular products
# they compute; their ratio is the int8 products a modular product
# (``fhebench/roofline/ffn.py`` counts the same).
INT8_PRODUCTS = dict.fromkeys(
    (name + sfx for sfx in LANES.values() for name in WRAPPERS), 0)
MOD_PRODUCTS = dict.fromkeys(INT8_PRODUCTS, 0)

LIMB_BITS = 8                      # bits of a weight limb
MAX_LIMBS = 8                      # TT_MM_L: most limbs of a weight
_TERM = 255 * 128                  # the largest |limb product|
_TILE_N = 32                       # TT_MM_TN: N a multiple of it
_TILE_J = 64                       # TT_MM_TJ: outputs a block
_STAGE = 64                        # TT_MM_TK: input features a stage


def limb_max(L: int) -> int:
    """The largest weight L balanced bytes hold: 127 in every byte."""
    return 127 * ((1 << (LIMB_BITS * L)) - 1) // 255


def limb_min(L: int) -> int:
    """The least weight L balanced bytes hold: -128 in every byte."""
    return -128 * ((1 << (LIMB_BITS * L)) - 1) // 255


MAX_WEIGHT = limb_max(MAX_LIMBS)   # 127 (2^64 - 1) / 255, about 2^62.99


def matmul_run(L: int) -> int:
    """The most input features one kernel sums before it reduces: a sum
    of shift class s takes at most min(L, 8) byte products a feature (a
    residue has at most 8 bytes), each at most 255 x 128 in magnitude, and
    must stay below 2^31, an int32 (13,158 at L = 5, 8,224 at L = 8)."""
    return ((1 << 31) - 1) // (min(L, MAX_LIMBS) * _TERM)


def residue_bytes(q: int) -> int:
    """Bytes the kernel takes of a residue of modulus ``q``."""
    return (int(q).bit_length() + 7) // 8


def weight_limbs(weights: torch.Tensor) -> torch.Tensor:
    """Signed integer weights ``W`` [F_in, F_out] (int64) -> their balanced
    bytes as int8 [L, F_in, F_out] on the same device, stored F_in fastest
    (the transpose of a contiguous [L, F_out, F_in]), with the fewest L (1
    to 8) whose top byte lies in [-128, 127]; raises past
    ``MAX_WEIGHT``."""
    if weights.dim() != 2 or weights.dtype != torch.int64:
        raise ValueError(f"weights must be int64 [F_in, F_out], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if bool((weights > MAX_WEIGHT).any()):
        raise ValueError(f"a weight integer of {int(weights.max())} exceeds "
                         f"{MAX_WEIGHT}, the most {MAX_LIMBS} limbs of "
                         f"{LIMB_BITS} bits hold")
    half = 1 << (LIMB_BITS - 1)
    limbs, r = [], weights.t()
    while True:
        if bool(((r >= -half) & (r < half)).all()):
            limbs.append(r)
            return torch.stack(limbs).to(torch.int8).transpose(1, 2)
        lo = ((r + half) & ((1 << LIMB_BITS) - 1)) - half
        limbs.append(lo)
        r = (r - lo) >> LIMB_BITS   # below MAX_WEIGHT + 128: no overflow


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
    if (wl.dim() != 3 or wl.dtype != torch.int8 or wl.shape[1] != F_in
            or not 1 <= wl.shape[0] <= MAX_LIMBS or wl.device != x0.device):
        raise ValueError(f"weight limbs: expected int8 [1...{MAX_LIMBS}, "
                         f"{F_in}, F_out] on {x0.device}, got {wl.dtype} "
                         f"{tuple(wl.shape)} on {wl.device}")
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


_PLAIN_BITS = 21   # the plain version's limbs: products below 2^41


def matmul_plain(x0, x1, wl, lp, acc=None):
    """The exact residues in int64: the weights put back together from
    their bytes and split again into balanced 21-bit limbs, the residue
    into 21-bit limbs, one ``einsum`` a pair of limbs (each sum below 2^63
    for any F_in below 2^21), each sum taken mod q, times 2^(21 s) mod q
    and added mod q."""
    F_in, F_out, L, C, N = _geometry(x0, x1, wl, lp, acc)
    q = lp.pack.q.long()[:, None]
    r = sum(wl[b].long() << (LIMB_BITS * b) for b in range(L))
    half, mask = 1 << (_PLAIN_BITS - 1), (1 << _PLAIN_BITS) - 1
    ws = []
    while len(ws) == 0 or bool((r != 0).any()):
        lo = ((r + half) & mask) - half
        ws.append(lo)
        r = (r - lo) >> _PLAIN_BITS
    parts = -(-int(q.max()).bit_length() // _PLAIN_BITS)
    outs = []
    for p, x in enumerate((x0, x1)):
        xs = x.long()
        total = (torch.zeros((F_out, C, N), dtype=torch.int64)
                 if acc is None else acc[p].long())
        for a in range(parts):
            xa = (xs >> (_PLAIN_BITS * a)) & mask
            for b, w in enumerate(ws):
                s = torch.remainder(torch.einsum("ij,icn->jcn", w, xa), q)
                shift = 1 << (_PLAIN_BITS * (a + b))
                total = torch.remainder(
                    total + _mulmod_const(s, [shift] * C, lp), q)
        outs.append(total.to(x.dtype))
    if acc is not None:
        for a_t, o in zip(acc, outs):
            a_t.copy_(o)
        return tuple(acc)
    return tuple(outs)


_BYTES = {}   # id(q) -> (q, its channels' residue bytes), read once


def _channel_bytes(q):
    """Residue bytes a channel, from the host's copy of ``q`` (the first
    call for a pack reads it from the device)."""
    hit = _BYTES.get(id(q))
    if hit is None or hit[0] is not q:
        hit = _BYTES[id(q)] = (q, [residue_bytes(v) for v in q.tolist()])
    return hit[1]


def matmul(x0, x1, wl, lp, acc=None):
    """``(acc +) sum_i W[i, j] x[i]`` mod q for both polynomials: ``x0``,
    ``x1`` [F_in, C, N] canonical residues of ``lp``'s channels (rows N
    words apart, one feature stride: a stacked ciphertext's data), ``wl``
    the weights' bytes [L, F_in, F_out] (:func:`weight_limbs`, on the
    device; the kernel reads them F_in fastest, and other strides are
    copied so first), ``acc`` None or a pair of contiguous [F_out, C, N] canonical
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
    wk = wl.transpose(1, 2).contiguous()   # [L, F_out, F_in]
    x_fs, w_ls = x0.stride(0), wk.stride(0)
    word = x0.element_size()
    key = "matmul" + LANES[pack.dtype]
    xl = sum(_channel_bytes(pack.q))
    rows = -(-F_out // _TILE_J) * _TILE_J
    for i, k0 in enumerate(pieces):
        k = min(run, F_in - k0)
        prev = acc if i == 0 else out
        rc = _entry("tt_matmul", pack)(
            x0.data_ptr() + k0 * x_fs * word, x1.data_ptr() + k0 * x_fs * word,
            x_fs, wk.data_ptr() + k0, w_ls, F_in, L, k, F_out,
            _ptr(prev[0]) if prev else None, _ptr(prev[1]) if prev else None,
            _ptr(out[0]), _ptr(out[1]), C, N, _ptr(pack.q), _ptr(pack.k),
            _ptr(lp.fold), _ptr(lp.Rs), _stream(x0.device),
        )
        _done(rc, "matmul", pack)
        INT8_PRODUCTS[key] += (xl * L * -(-k // _STAGE) * _STAGE * rows
                               * 2 * N)
        MOD_PRODUCTS[key] += k * F_out * 2 * N * C
    return tuple(out)
