"""Ciphertext packing: the feature-wise layout of tensors into CKKS slots.

The torch counterpart of ``tiberate_tpu/extension/packing.py``: the last
dimension of an N-D array is padded to a power of two (the *logical* slot
count) and folded or split across the physical slots:

* ``logical >= physical``: each logical row folds into ``logical/physical``
  ciphertexts,
* ``logical <  physical``: one ciphertext per row, the row padded into the
  physical slot count (the tail slots stay zero).

The packing math is numpy (host-side data preparation); the ciphertexts
are the port's, and :class:`PackedCT`'s operators run through their
sugar.
"""

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from tiberate_tpu_torch.utils.massive import next_power_of_2


@dataclass
class PackingMetadata:
    original_shape: tuple | None = None
    logical_num_slots: int | None = None
    packed_by: Any = None
    encoded_by: Any = None
    misc: dict = field(default_factory=dict)


class FeatureWisePacking:
    """The plaintext-side packing math."""

    @classmethod
    def find_logical_num_slots(cls, num_slots: int, last_dim: int) -> int:
        if last_dim > num_slots:
            return num_slots * math.ceil(last_dim / num_slots)
        return next_power_of_2(last_dim)

    @classmethod
    def pack(cls, x: np.ndarray, num_slots: int, logical_num_slots: int):
        """[..., D] -> [..., rows, num_slots] of slot-aligned chunks."""
        x = np.asarray(x)
        pad = logical_num_slots - x.shape[-1]
        if pad > 0:
            width = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
            x = np.pad(x, width)
        if logical_num_slots % num_slots == 0:
            rows = logical_num_slots // num_slots
            return x.reshape(*x.shape[:-1], rows, num_slots)
        # logical < physical: one (padded) row per ciphertext
        out = np.zeros((*x.shape[:-1], 1, num_slots), dtype=x.dtype)
        out[..., 0, : x.shape[-1]] = x
        return out

    @classmethod
    def unpack(cls, x: np.ndarray, logical_num_slots: int,
               original_last_dim: int):
        """Inverse of :meth:`pack`: [..., rows, num_slots] -> [..., D]."""
        x = np.asarray(x)
        num_slots = x.shape[-1]
        if logical_num_slots % num_slots == 0:
            flat = x.reshape(*x.shape[:-2], -1)
        else:
            flat = x[..., 0, :logical_num_slots]
        return flat[..., :original_last_dim]


def _zip_map(fn, a, b):
    if isinstance(a, list):
        return [_zip_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _map(fn, x):
    if isinstance(x, list):
        return [_map(fn, v) for v in x]
    return fn(x)


class PackedCT:
    """A nested list of ciphertexts + its packing metadata."""

    def __init__(self, cts, metadata: PackingMetadata):
        self.cts = cts  # nested lists of Ciphertext
        self.metadata = metadata

    def clone(self):
        return self.map(lambda ct: ct.clone())

    def map(self, fn):
        return self.__class__(cts=_map(fn, self.cts), metadata=self.metadata)

    def __add__(self, other):
        if isinstance(other, PackedCT):
            return self.__class__(
                cts=_zip_map(lambda a, b: a + b, self.cts, other.cts),
                metadata=self.metadata,
            )
        return self.map(lambda ct: ct + other)

    def __mul__(self, other):
        if isinstance(other, PackedCT):
            return self.__class__(
                cts=_zip_map(lambda a, b: a * b, self.cts, other.cts),
                metadata=self.metadata,
            )
        return self.map(lambda ct: ct * other)

    def __neg__(self):
        return self.map(lambda ct: -ct)


class FeatureWiseCTEncoding:
    """Encrypt / decrypt N-D arrays with feature-wise packing: one
    ``encodecrypt`` per packed row, in row order (the JAX package's draw
    order)."""

    @classmethod
    def encodecrypt(cls, src, engine, level: int = 0) -> PackedCT:
        src = np.asarray(src, dtype=np.float64)
        if src.ndim < 2:
            src = src.reshape(1, -1)
        original_shape = src.shape
        flat = src.reshape(-1, src.shape[-1])  # [B*, D]

        num_slots = engine.num_slots
        logical = FeatureWisePacking.find_logical_num_slots(
            num_slots, flat.shape[-1]
        )
        packed = FeatureWisePacking.pack(flat, num_slots, logical)
        # packed: [B*, rows, num_slots]
        cts = [
            [
                engine.encodecrypt(packed[b, r], padding=False, level=level)
                for r in range(packed.shape[1])
            ]
            for b in range(packed.shape[0])
        ]
        return PackedCT(
            cts=cts,
            metadata=PackingMetadata(
                original_shape=original_shape,
                logical_num_slots=logical,
                packed_by=FeatureWisePacking,
                encoded_by=cls,
            ),
        )

    @classmethod
    def decryptcode(cls, packed_ct: PackedCT, engine, sk=None) -> np.ndarray:
        md = packed_ct.metadata
        rows = []
        for row_cts in packed_ct.cts:
            decs = [
                np.real(engine.decryptcode(ct, sk=sk)) for ct in row_cts
            ]
            rows.append(np.stack(decs))
        arr = np.stack(rows)  # [B*, rows, num_slots]
        flat = FeatureWisePacking.unpack(
            arr, md.logical_num_slots, md.original_shape[-1]
        )
        return flat.reshape(md.original_shape)
