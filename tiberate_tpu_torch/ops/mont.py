"""Branchless Montgomery modular arithmetic on ``int64`` / ``int32`` RNS
tensors.

The torch counterpart of ``tiberate_tpu/ops/mont.py``: half-word REDC and
the lazy ``[0, 2q)`` representative convention, in two modes chosen by the
dtype of the :class:`ModPack` constants, as in the JAX package:

* 62-bit: int64 storage, 31-bit halves, ``R = 2^62``;
* 30-bit: int32 storage, 15-bit halves, ``R = 2^30`` (q < 2^28).

Torch ``int64``/``int32`` multiply, add and ``<<`` wrap, ``>>`` is
arithmetic and comparisons are signed, exactly as in jnp, so every function
here is bit-identical to its jnp twin on any input, including the negative
representatives the engine feeds through REDC (rescale differences, signed
basis-extension digits).

Every REDC here equals the exact Montgomery reduction
``(a*b + m*q) >> W`` with ``m = ((a*b) mod 2^W) * k mod 2^W`` and
``W = 62`` or ``30``, computed without overflow (128-bit, resp. 64-bit,
products) — the form the CUDA kernels use (``csrc/mont.cuh``).

All functions operate on tensors shaped ``[..., C, N]`` with per-channel
constants shaped ``[C, 1]``.
"""

from dataclasses import dataclass

import torch

HALF_BITS = 31
NBITS = 62
LB_MASK = (1 << HALF_BITS) - 1
FB_MASK = (1 << NBITS) - 1

HALF_BITS_30 = 15
NBITS_30 = 30
LB_MASK_30 = (1 << HALF_BITS_30) - 1
FB_MASK_30 = (1 << NBITS_30) - 1

# storage dtype <-> R bits
DTYPES = {NBITS: torch.int64, NBITS_30: torch.int32}


def _mode(ql):
    """(half_bits, lb_mask, fb_mask) from the constant dtype."""
    if ql.dtype == torch.int32:
        return HALF_BITS_30, LB_MASK_30, FB_MASK_30
    return HALF_BITS, LB_MASK, FB_MASK


@dataclass(frozen=True)
class ModPack:
    """Per-channel Montgomery constants, each shaped ``[C, 1]``, in the
    storage dtype (int64 at R = 2^62, int32 at R = 2^30).

    ``ql/qh/kl/kh/_2q`` are the jnp ModPack's fields; ``q`` and ``k`` are the
    unsplit modulus and ``-q^-1 mod R``, flattened to ``[C]``, which the
    CUDA kernels read.
    """

    ql: torch.Tensor
    qh: torch.Tensor
    kl: torch.Tensor
    kh: torch.Tensor
    _2q: torch.Tensor
    q: torch.Tensor
    k: torch.Tensor

    @property
    def num_channels(self):
        return self.ql.shape[0]

    @property
    def dtype(self):
        return self.ql.dtype

    def __getitem__(self, sl):
        """Select channels: a slice or a list of channel indices."""
        return ModPack(*(getattr(self, f)[sl] for f in _PACK_FIELDS))

    def to(self, device):
        return ModPack(*(getattr(self, f).to(device) for f in _PACK_FIELDS))

    def expand(self, extra_dims: int):
        """Append singleton dims to the [C, 1] columns for broadcasting
        against [..., C, N, ...]; the flat ``q`` and ``k`` stay [C]."""
        if extra_dims == 0:
            return self
        idx = (Ellipsis,) + (None,) * extra_dims
        return ModPack(*(getattr(self, f)[idx] for f in _SPLIT_FIELDS),
                       q=self.q, k=self.k)

    @classmethod
    def from_q(cls, q_list, R_bits=NBITS, device="cpu"):
        """Build from a list of python-int moduli (R_bits: 62 or 30)."""
        q = [int(x) for x in q_list]
        R = 1 << R_bits
        half = R_bits // 2
        mask = (1 << half) - 1
        dt = DTYPES[R_bits]
        k = [(R * pow(R, -1, qi) - 1) // qi for qi in q]

        def flat(v):
            return torch.tensor(v, dtype=dt, device=device)

        return cls(
            ql=flat([qi & mask for qi in q]).reshape(-1, 1),
            qh=flat([qi >> half for qi in q]).reshape(-1, 1),
            kl=flat([ki & mask for ki in k]).reshape(-1, 1),
            kh=flat([ki >> half for ki in k]).reshape(-1, 1),
            _2q=flat([qi << 1 for qi in q]).reshape(-1, 1),
            q=flat(q),
            k=flat(k),
        )


_SPLIT_FIELDS = ("ql", "qh", "kl", "kh", "_2q")
_PACK_FIELDS = (*_SPLIT_FIELDS, "q", "k")


def _split(x, half=HALF_BITS, mask=LB_MASK):
    # Arithmetic right shift, bitwise mask — exactly the CUDA split.
    return x & mask, x >> half


def mont_mult_raw(a, b, ql, qh, kl, kh):
    """Core REDC: returns ``a*b*R^-1`` with the lazy [0,2q) bound."""
    half, mask, fb = _mode(ql)
    al, ah = _split(a, half, mask)
    bl, bh = _split(b, half, mask)

    alpha = ah * bh
    beta = ah * bl + al * bh
    gamma = al * bl

    gammal, gammah = _split(gamma, half, mask)
    betal, betah = _split(beta, half, mask)

    upper = gammal * kh
    upper = upper + (gammah + betal) * kl
    upper = upper << half
    s = (upper + gammal * kl) & fb

    sl, sh = _split(s, half, mask)
    sqb = sh * ql + sl * qh
    sqbl, sqbh = _split(sqb, half, mask)

    carry = (gamma + sl * ql) >> half
    carry = (carry + betal + sqbl) >> half

    return alpha + betah + sqbh + carry + sh * qh


def mont_reduce_raw(x, ql, qh, kl, kh):
    """REDC of a single operand: returns ``x * R^-1`` (exit Montgomery)."""
    half, mask, fb = _mode(ql)
    xl, xh = _split(x, half, mask)
    xkb = xh * kl + xl * kh
    s = ((xkb << half) + xl * kl) & fb

    sl, sh = _split(s, half, mask)
    sqb = sh * ql + sl * qh
    sqbl, sqbh = _split(sqb, half, mask)
    carry = (x + sl * ql) >> half
    carry = (carry + sqbl) >> half

    return sqbh + carry + sh * qh


def mont_mult(a, b, pack: ModPack):
    return mont_mult_raw(a, b, pack.ql, pack.qh, pack.kl, pack.kh)


def mont_enter(a, Rs, pack: ModPack):
    """a -> a * R, with Rs = R^2 mod q per channel (``[C, 1]``)."""
    return mont_mult_raw(a, Rs, pack.ql, pack.qh, pack.kl, pack.kh)


def mont_reduce(a, pack: ModPack):
    return mont_reduce_raw(a, pack.ql, pack.qh, pack.kl, pack.kh)


def mont_add(a, b, pack: ModPack):
    """Lazy modular add: inputs in [0,2q), output in [0,2q)."""
    s = a + b
    return torch.where(s < pack._2q, s, s - pack._2q)


def mont_sub(a, b, pack: ModPack):
    """Lazy modular sub: inputs in [0,2q), output in [0,2q)."""
    s = a + pack._2q - b
    return torch.where(s < pack._2q, s, s - pack._2q)


def reduce_2q(a, pack: ModPack):
    """[0, 2q) -> [0, q) (signed compare)."""
    q = pack._2q >> 1
    return torch.where(a < q, a, a - q)


def make_signed(a, pack: ModPack):
    """[0, q) -> centered representative in (-q/2, q/2]."""
    q = pack._2q >> 1
    q_half = q >> 1
    return torch.where(a <= q_half, a, a - q)


def make_unsigned(a, pack: ModPack):
    """Centered representative -> [0, q)."""
    q = pack._2q >> 1
    return torch.where(a < 0, a + q, a)


def tile_unsigned(a, pack: ModPack):
    """Broadcast a signed ``[..., N]`` polynomial (values in (-q, q)) into
    unsigned ``[..., C, N]`` RNS residues, in the pack's storage dtype (the
    CSPRNG's and codec's int64 draws are cast, as the JAX package does)."""
    q = pack._2q >> 1
    a = torch.as_tensor(a).to(device=q.device, dtype=pack.dtype)[
        ..., None, :
    ]
    tiled = a.expand(*a.shape[:-2], pack.num_channels, a.shape[-1])
    return torch.where(tiled < 0, tiled + q, tiled)


def mont_mult_oracle(a: int, b: int, q: int, R_bits: int = NBITS) -> int:
    """Exact REDC with python ints; the same representative as mont_mult."""
    R = 1 << R_bits
    k = (R * pow(R, -1, q) - 1) // q
    x = a * b
    s = (x * k) % R
    t = x + s * q
    assert t % R == 0
    return t >> R_bits
