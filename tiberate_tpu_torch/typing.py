"""Typed CKKS data structures (the slice's subset).

The torch counterpart of ``tiberate_tpu/typing.py``: the same ``FLAGS``
bitflags and ``DataStruct`` fields (``data``, flags, ``level``, ``misc``),
with ``data`` holding tensors shaped ``[..., C, N]`` in the storage dtype
(int64, or int32 in the 30-bit mode).  Operator sugar,
plaintext caches and save/load come with later slices of the port.
"""

from collections import defaultdict
from enum import Flag, auto


class FLAGS(Flag):
    NTT_STATE = auto()
    MONTGOMERY_STATE = auto()
    INCLUDE_SPECIAL = auto()
    NEED_RESCALE = auto()
    NEED_RELINERIZE = auto()

    def dumps(self) -> str:
        return ",".join(flag.name for flag in FLAGS if self & flag)

    @classmethod
    def loads(cls, s: str) -> "FLAGS":
        if not s:
            return cls(0)
        flags = cls(0)
        for name in s.split(","):
            flags |= cls[name]
        return flags

    def __repr__(self):
        return self.dumps()

    __str__ = __repr__


def _default_none():
    return None


class DataStruct:
    def __init__(self, data, *, flags=None, level: int, **kwargs):
        self.data = data
        self._flags = flags if isinstance(flags, FLAGS) else FLAGS(0)
        for f in flags if isinstance(flags, list) else ():
            self._flags |= f
        self.level = level
        self.misc = defaultdict(_default_none)
        self.misc.update(kwargs)

    def has_flag(self, flag: FLAGS) -> bool:
        return bool(self._flags & flag)

    @classmethod
    def wrap(cls, another: "DataStruct", **kwargs):
        return cls(
            data=another.data,
            flags=another._flags,
            level=another.level,
            **{**another.misc, **kwargs},
        )

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(flags={self._flags}, "
            f"level={self.level}, misc={dict(self.misc)})"
        )

    __str__ = __repr__


class Ciphertext(DataStruct):
    """(ct0, ct1), each [..., C, N] canonical residues."""


class CiphertextTriplet(DataStruct):
    """(d0, d1, d2) of a tensor product before relinearization, each
    [..., C, N] in the NTT and Montgomery state."""


class SecretKey(DataStruct):
    pass


class PublicKey(DataStruct):
    """(pk0, a).  ``misc["a_seed"]``: the seed ``a`` was drawn from
    (``create_public_key(a_seed=)``), else None; a compressed key
    (``misc["compressed"]``) holds ``(pk0,)`` alone."""


class KeySwitchKey(DataStruct):
    """One (pk0, pk1) pair of [P+S, N] tensors per decomposition part.
    ``misc["a_seed"]``: the seed every part's ``pk1`` was drawn from
    (``create_key_switching_key(a_seed=)``), else None; a compressed key
    (``misc["compressed"]``) holds each part's ``pk0`` alone."""


class EvaluationKey(KeySwitchKey):
    """The relinearization key (a key-switching key from s^2 to s)."""
