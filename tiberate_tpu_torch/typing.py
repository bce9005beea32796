"""Typed CKKS data structures.

The torch counterpart of ``tiberate_tpu/typing.py``: the same ``FLAGS``
bitflags and ``DataStruct`` fields (``data``, flags, ``level``, ``misc``),
with ``data`` holding tensors shaped ``[..., C, N]`` in the storage dtype
(int64, or int32 in the 30-bit mode); ``Plaintext`` with its per-level,
per-op encoded cache; the key classes, rotation and conjugation keys
included.  Operator sugar, the default-engine registry and save/load come
with a later slice of the port.
"""

from collections import defaultdict
from enum import Flag, auto

import numpy as np
import torch


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


class Plaintext(DataStruct):
    """Raw message + per-level, per-op encoded cache: ``cache[level][op]``
    (op "pc_add" or "pc_mult") holds the engine's prepared row."""

    def __init__(self, m, *, cache=None, padding=True, scale=None, **kwargs):
        if isinstance(m, torch.Tensor):
            m = m.cpu().numpy()
        elif isinstance(m, (int, float, complex)):
            m = np.array([m])
        elif isinstance(m, list):
            m = np.asarray(m)
        if not isinstance(m, np.ndarray):
            raise TypeError(f"Unsupported message type: {type(m)}")
        if m.ndim != 1:
            raise ValueError(f"Plaintext source must be 1-D, got {m.ndim}-D")
        self.src = m
        self.data = cache if cache is not None else defaultdict(dict)
        self.misc = defaultdict(_default_none)
        self.misc.update(kwargs)
        self.misc["padding"] = padding
        self.misc["scale"] = scale

    def __neg__(self):
        return Plaintext(-self.src)

    @property
    def padding(self):
        return self.misc.get("padding")

    @property
    def scale(self):
        return self.misc.get("scale")

    @scale.setter
    def scale(self, value):
        self.misc["scale"] = value

    @property
    def cache(self):
        return self.data

    @cache.setter
    def cache(self, value):
        self.data = value

    def clone(self):
        return Plaintext(self.src, cache=self.data)

    def __repr__(self):
        return (
            f"Plaintext(len={len(self.src)}, "
            f"cached levels={list(self.data.keys())})"
        )

    @property
    def level(self):
        raise NotImplementedError("Plaintext does not have a level.")


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


class RotationKey(KeySwitchKey):
    """A key-switching key from the rotated secret key; ``misc["delta"]``
    is its slot offset."""

    @property
    def delta(self):
        return self.misc.get("delta")


class GaloisKey(DataStruct):
    """The power-of-2 rotation keys (deltas 1, 2, ..., 2^(logN-2)) as a
    list of :class:`RotationKey`."""


class ConjugationKey(KeySwitchKey):
    """A key-switching key from the conjugated secret key."""
