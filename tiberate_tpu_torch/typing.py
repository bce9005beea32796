"""Typed CKKS data structures with operator sugar.

The torch counterpart of ``tiberate_tpu/typing.py``: the same ``FLAGS``
bitflags and ``DataStruct`` fields (``data``, flags, ``level``, ``misc``),
with ``data`` holding tensors shaped ``[..., C, N]`` in the storage dtype
(int64, or int32 in the 30-bit mode); ``Plaintext`` with its per-level,
per-op encoded cache; ``Ciphertext`` / ``CiphertextTriplet`` with the
python operator sugar, dispatched through a process-wide default-engine
registry; the key classes in the JAX package's hierarchy.

``save`` / ``load`` write and read the JAX package's format: an ``np.savez``
archive with a json ``__header__`` (class, flags, level, the scalar
``misc`` entries, the tree structure as the string jax prints for it, the
leaf count) and one ``leaf_{i}`` array per tensor, so a file written by
either package loads in the other.
"""

import json
import os
from collections import defaultdict
from enum import Flag, auto
from typing import Any

import numpy as np
import torch

# Process-wide default-engine registry (``tiberate_tpu/typing.py:27-52``):
# the first engine of each logN, and every engine by its hash, so a data
# structure dispatches to the engine that made it while that one is alive.
# Both dicts hold strong references, as the JAX package's do.
_default_engines: dict[int, Any] = {}
_engines_by_hash: dict[str, Any] = {}


def register_default_engine(logN: int, engine, overwrite=False):
    if overwrite or logN not in _default_engines:
        _default_engines[logN] = engine
    h = getattr(engine, "hash", None)
    if h is not None:
        _engines_by_hash[h] = engine


def get_default_engine(logN: int, creator_hash=None):
    if creator_hash is not None and creator_hash in _engines_by_hash:
        return _engines_by_hash[creator_hash]
    if logN not in _default_engines:
        raise RuntimeError(
            f"No default engine for logN {logN}. Create an engine for this "
            f"logN first."
        )
    return _default_engines[logN]


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


def _flatten(data):
    """(leaves, structure) of nested tuples / lists / dicts of tensors, in
    jax's leaf order; ``f"PyTreeDef({structure})"`` is the string that
    ``str(jax.tree_util.tree_flatten(data)[1])`` gives."""
    if data is None:
        return [], "None"
    if isinstance(data, (tuple, list)):
        parts = [_flatten(d) for d in data]
        leaves = [leaf for p, _ in parts for leaf in p]
        body = ", ".join(s for _, s in parts)
        if isinstance(data, list):
            return leaves, f"[{body}]"
        return leaves, f"({body},)" if len(data) == 1 else f"({body})"
    if isinstance(data, dict):
        parts = [(k, _flatten(data[k])) for k in sorted(data)]
        leaves = [leaf for _, (p, _) in parts for leaf in p]
        body = ", ".join(f"{k!r}: {s}" for k, (_, s) in parts)
        return leaves, "{" + body + "}"
    return [data], "*"


def _clone_tree(data):
    if isinstance(data, torch.Tensor):
        return data.clone()
    if isinstance(data, (tuple, list)):
        return type(data)(_clone_tree(d) for d in data)
    if isinstance(data, dict):
        return {k: _clone_tree(v) for k, v in data.items()}
    return data


class DataStruct:
    def __init__(self, data, *, flags=None, level: int, **kwargs):
        self.data = data
        self._flags = flags if isinstance(flags, FLAGS) else FLAGS(0)
        for f in flags if isinstance(flags, list) else ():
            self._flags |= f
        self.level = level
        self.misc = defaultdict(_default_none)
        self.misc.update(kwargs)

    # --- flags ---------------------------------------------------------

    def has_flag(self, flag: FLAGS) -> bool:
        return bool(self._flags & flag)

    def set_flag(self, flag: FLAGS):
        self._flags |= flag

    def rm_flag(self, flag: FLAGS):
        self._flags &= ~flag

    def toggle_flag(self, flag: FLAGS):
        self._flags ^= flag

    @property
    def flags(self):
        return [f for f in FLAGS if self.has_flag(f)]

    @flags.setter
    def flags(self, value):
        self._flags = FLAGS(0)
        for f in value:
            self.set_flag(f)

    # --- structure -----------------------------------------------------

    def clone(self):
        """A copy whose tensors are copies (``.clone()``, on their
        device); ``misc`` is copied shallowly."""
        return self.__class__(
            data=_clone_tree(self.data),
            flags=self._flags,
            level=self.level,
            **self.misc,
        )

    @classmethod
    def wrap(cls, another: "DataStruct", **kwargs):
        return cls(
            data=another.data,
            flags=another._flags,
            level=another.level,
            **{**another.misc, **kwargs},
        )

    # --- serialization (the JAX package's npz + json header) -----------

    def save(self, path: str):
        leaves, treedef = _flatten(self.data)
        arrays = {f"leaf_{i}": x.detach().cpu().numpy()
                  for i, x in enumerate(leaves)}
        header = {
            "class": self.__class__.__name__,
            "flags": self._flags.dumps(),
            "level": self.level,
            "misc": {
                k: v for k, v in self.misc.items()
                if isinstance(v, (str, int, float, bool, type(None)))
            },
            "treedef": f"PyTreeDef({treedef})",
            "num_leaves": len(leaves),
        }
        np.savez(path, __header__=json.dumps(header), **arrays)

    @classmethod
    def load(cls, path: str, device="cuda"):
        """A file of :meth:`save` (either package's) -> the structure, its
        leaves on ``device`` in their stored dtype.  As in the JAX package,
        a structure of more than one leaf comes back as a flat tuple of
        them (a key's part pairs are not rebuilt), one leaf as itself."""
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["__header__"]))
            leaves = [
                torch.from_numpy(z[f"leaf_{i}"]).to(device)
                for i in range(header["num_leaves"])
            ]
        data = tuple(leaves) if len(leaves) > 1 else leaves[0]
        klass = _CLASS_REGISTRY.get(header["class"], cls)
        return klass(
            data=data,
            flags=FLAGS.loads(header["flags"]),
            level=header["level"],
            **header["misc"],
        )

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(flags={self._flags}, "
            f"level={self.level}, misc={dict(self.misc)})"
        )

    __str__ = __repr__

    @property
    def _default_engine(self):
        return get_default_engine(
            self.misc["logN"], self.misc.get("creator_hash")
        )


# ================== #
# Message type alias #
# ================== #

VectorMessageType = (np.ndarray, list, torch.Tensor)
ScalarMessageType = (int, float, complex)


# ================== #
#  Plaintext cache   #
# ================== #


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


# ================== #
#  Cipher structures #
# ================== #


class Ciphertext(DataStruct):
    """(ct0, ct1), each [..., C, N] canonical residues.  The operators run
    the engine that made it (the registry): ``+ - *`` with a ciphertext, a
    triplet (relinearized first), a scalar, a :class:`Plaintext` or a
    vector; ``>>`` / ``<<`` rotate by slots; ``**`` is :meth:`pow`."""

    def __add__(self, other):
        engine = self._default_engine
        if isinstance(other, Ciphertext):
            return engine.cc_add_double(self, other)
        if isinstance(other, CiphertextTriplet):
            return engine.cc_add_double(self, engine.relinearize(other))
        if isinstance(other, ScalarMessageType):
            return engine.add_scalar(self, other)
        if isinstance(other, Plaintext):
            return engine.pc_add(other, self)
        if isinstance(other, VectorMessageType):
            return engine.pc_add(Plaintext(other), self)
        raise TypeError(f"Unsupported type for addition: {type(other)}")

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        engine = self._default_engine
        if isinstance(other, Ciphertext):
            return engine.cc_sub_double(self, other)
        if isinstance(other, CiphertextTriplet):
            return engine.cc_sub_double(self, engine.relinearize(other))
        if isinstance(other, ScalarMessageType):
            return engine.add_scalar(self, -other)
        if isinstance(other, Plaintext):
            return engine.pc_add(-other, self)
        if isinstance(other, VectorMessageType):
            return engine.pc_add(Plaintext(-np.asarray(other)), self)
        raise TypeError(f"Unsupported type for subtraction: {type(other)}")

    def __rsub__(self, other):
        engine = self._default_engine
        return engine.negate(self) + other

    def __mul__(self, other):
        engine = self._default_engine
        if isinstance(other, Ciphertext):
            return engine.cc_mult(self, other)
        if isinstance(other, CiphertextTriplet):
            return engine.cc_mult(self, engine.relinearize(other))
        if isinstance(other, ScalarMessageType):
            return engine.mult_scalar(self, other)
        if isinstance(other, Plaintext):
            return engine.pc_mult(other, self)
        if isinstance(other, VectorMessageType):
            return engine.mc_mult(other, self)
        raise TypeError(f"Unsupported type for multiplication: {type(other)}")

    def __rmul__(self, other):
        return self * other

    def __neg__(self):
        return self._default_engine.negate(self)

    def __rshift__(self, offset: int):
        if not isinstance(offset, int):
            raise TypeError("rotation offset must be int")
        return self._default_engine.rotate_offset(self, offset)

    def __lshift__(self, offset: int):
        return self >> (-offset)

    def __pow__(self, power: int):
        return self._default_engine.pow(self, power)

    def rescale(self, exact_rounding=True):
        return self._default_engine.rescale(self, exact_rounding)

    def level_up(self, dst_level: int):
        return self._default_engine.level_up(self, dst_level)

    def decryptcode(self, sk=None, is_real=False, final_round=True):
        return self._default_engine.decryptcode(
            self, sk=sk, is_real=is_real, final_round=final_round
        )

    @property
    def plain(self):
        return self.decryptcode(is_real=True)

    def sum(self):
        return self._default_engine.sum(self)

    def mean(self):
        return self._default_engine.mean(self)

    def std(self):
        return self._default_engine.std(self)


class CiphertextTriplet(DataStruct):
    """(d0, d1, d2) of a tensor product before relinearization, each
    [..., C, N] in the NTT and Montgomery state.  ``+`` / ``-`` with a
    triplet stay triplets; every other operator relinearizes first."""

    def _relin(self):
        return self._default_engine.relinearize(self)

    def __add__(self, other):
        if isinstance(other, CiphertextTriplet):
            return self._default_engine.cc_add_triplet(self, other)
        return other + self._relin()

    def __sub__(self, other):
        if isinstance(other, CiphertextTriplet):
            return self._default_engine.cc_sub_triplet(self, other)
        return self._relin() - other

    def __mul__(self, other):
        return self._relin() * other

    def __rshift__(self, offset):
        return self._relin() >> offset

    def __lshift__(self, offset):
        return self._relin() << offset

    def __pow__(self, power):
        return self._relin() ** power

    def rescale(self, exact_rounding=True):
        return self._relin().rescale(exact_rounding)

    def level_up(self, dst_level):
        return self._relin().level_up(dst_level)

    def decryptcode(self, sk=None, is_real=False, final_round=True):
        return self._default_engine.decryptcode(
            self, sk=sk, is_real=is_real, final_round=final_round
        )

    @property
    def plain(self):
        return self.decryptcode(is_real=True)

    def sum(self):
        return self._relin().sum()

    def mean(self):
        return self._relin().mean()

    def std(self):
        return self._relin().std()


# ================== #
#   Key structures   #
# ================== #


class SecretKey(DataStruct):
    pass


class EvaluationKey(SecretKey):
    """The relinearization key (a key-switching key from s^2 to s): one
    (pk0, pk1) pair of [P+S, N] tensors per decomposition part.  It
    derives from :class:`SecretKey`, as in the JAX package
    (``tiberate_tpu/typing.py:424``)."""


class PublicKey(DataStruct):
    """(pk0, a).  ``misc["a_seed"]``: the seed ``a`` was drawn from
    (``create_public_key(a_seed=)``), else None; a compressed key
    (``misc["compressed"]``) holds ``(pk0,)`` alone."""


class KeySwitchKey(DataStruct):
    """One (pk0, pk1) pair of [P+S, N] tensors per decomposition part.
    ``misc["a_seed"]``: the seed every part's ``pk1`` was drawn from
    (``create_key_switching_key(a_seed=)``), else None; a compressed key
    (``misc["compressed"]``) holds each part's ``pk0`` alone."""


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


_CLASS_REGISTRY = {
    c.__name__: c
    for c in (
        DataStruct, Ciphertext, CiphertextTriplet, SecretKey, PublicKey,
        EvaluationKey, KeySwitchKey, RotationKey, GaloisKey, ConjugationKey,
    )
}
