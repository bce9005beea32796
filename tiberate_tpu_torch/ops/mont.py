"""Branchless Montgomery modular arithmetic on ``int64`` RNS tensors.

The torch counterpart of ``tiberate_tpu/ops/mont.py`` (62-bit mode):
31-bit-half REDC with ``R = 2^62`` and the lazy ``[0, 2q)`` representative
convention.  Torch ``int64`` multiply and add wrap mod 2^64, ``>>`` is
arithmetic and comparisons are signed, exactly as in jnp, so every function
here is bit-identical to its jnp twin on any input, including the negative
representatives the engine feeds through REDC (rescale differences, signed
basis-extension digits).

Every REDC here equals the exact Montgomery reduction
``(a*b + m*q) >> 62`` with ``m = ((a*b) mod 2^62) * k mod 2^62`` computed in
128-bit integers — the form the CUDA kernels use (``csrc/mont.cuh``).

All functions operate on tensors shaped ``[..., C, N]`` with per-channel
constants shaped ``[C, 1]``.
"""

from dataclasses import dataclass

import torch

HALF_BITS = 31
NBITS = 62
LB_MASK = (1 << HALF_BITS) - 1
FB_MASK = (1 << NBITS) - 1


@dataclass(frozen=True)
class ModPack:
    """Per-channel Montgomery constants, each shaped ``[C, 1]`` int64.

    ``ql/qh/kl/kh/_2q`` are the jnp ModPack's fields; ``q`` and ``k`` are the
    unsplit modulus and ``-q^-1 mod 2^62``, flattened to ``[C]``, which the
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

    def __getitem__(self, sl):
        """Slice the channel axis."""
        return ModPack(*(getattr(self, f)[sl] for f in _PACK_FIELDS))

    @classmethod
    def from_q(cls, q_list, device="cpu"):
        """Build from a list of python-int moduli."""
        q = [int(x) for x in q_list]
        R = 1 << NBITS
        mask = LB_MASK
        k = [(R * pow(R, -1, qi) - 1) // qi for qi in q]

        def col(v):
            return torch.tensor(v, dtype=torch.int64, device=device).reshape(
                -1, 1
            )

        return cls(
            ql=col([qi & mask for qi in q]),
            qh=col([qi >> HALF_BITS for qi in q]),
            kl=col([ki & mask for ki in k]),
            kh=col([ki >> HALF_BITS for ki in k]),
            _2q=col([qi << 1 for qi in q]),
            q=torch.tensor(q, dtype=torch.int64, device=device),
            k=torch.tensor(k, dtype=torch.int64, device=device),
        )


_PACK_FIELDS = ("ql", "qh", "kl", "kh", "_2q", "q", "k")


def _split(x):
    # Arithmetic right shift, bitwise mask — exactly the CUDA split.
    return x & LB_MASK, x >> HALF_BITS


def mont_mult_raw(a, b, ql, qh, kl, kh):
    """Core REDC: returns ``a*b*R^-1`` with the lazy [0,2q) bound."""
    al, ah = _split(a)
    bl, bh = _split(b)

    alpha = ah * bh
    beta = ah * bl + al * bh
    gamma = al * bl

    gammal, gammah = _split(gamma)
    betal, betah = _split(beta)

    upper = gammal * kh
    upper = upper + (gammah + betal) * kl
    upper = upper << HALF_BITS
    s = (upper + gammal * kl) & FB_MASK

    sl, sh = _split(s)
    sqb = sh * ql + sl * qh
    sqbl, sqbh = _split(sqb)

    carry = (gamma + sl * ql) >> HALF_BITS
    carry = (carry + betal + sqbl) >> HALF_BITS

    return alpha + betah + sqbh + carry + sh * qh


def mont_reduce_raw(x, ql, qh, kl, kh):
    """REDC of a single operand: returns ``x * R^-1`` (exit Montgomery)."""
    xl, xh = _split(x)
    xkb = xh * kl + xl * kh
    s = ((xkb << HALF_BITS) + xl * kl) & FB_MASK

    sl, sh = _split(s)
    sqb = sh * ql + sl * qh
    sqbl, sqbh = _split(sqb)
    carry = (x + sl * ql) >> HALF_BITS
    carry = (carry + sqbl) >> HALF_BITS

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
    unsigned ``[..., C, N]`` RNS residues."""
    q = pack._2q >> 1
    a = torch.as_tensor(a).to(device=q.device, dtype=torch.int64)[
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
