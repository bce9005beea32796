"""A single-controller device mesh for sharded CKKS.

The torch counterpart of ``tiberate_tpu/parallel/mesh.py``.  One process
drives every shard: a :class:`Mesh` lays ``torch.device``s out over named
axes,

* ``rns``   — shards the C (RNS channel) axis,
* ``coef``  — shards the N (coefficient) axis,
* ``batch`` — data-parallel over independent ciphertexts (optional, first),

and a :class:`ShardedArray` (the counterpart of a ``NamedSharding``-ed
``jax.Array``) holds one block per mesh coordinate, each on its device.  A
spec names, per dimension, the mesh axis that shards it or None (the
dimension is whole, and so replicated over every axis that shards no
dimension).  Blocks of one device that hold the same slice share one tensor.

The collectives the JAX code leaves to XLA are functions here over the
blocks of every coordinate: :func:`all_gather` (tiled) and
:func:`ppermute`.  Between two blocks of one device a block is handed over
as it is (blocks are never written in place); between two cards it is a
peer copy (``.to(device)``).  Each call adds one to the mesh's
:attr:`Mesh.counts` under its name and the bytes that crossed between
shards under ``<name>_bytes``: the counterparts of the collectives an HLO
module holds.

Several coordinates may name one card (``make_mesh(devices=["cuda:0"] *
4)``): the shards then share it, as the JAX package's CPU mesh shares one
host.  Nothing here falls back to another device.
"""

import itertools
import math

import numpy as np
import torch


class Mesh:
    """A grid of devices over named axes.  ``devices``: nested lists (or an
    object array) shaped by the axes; an entry may be None for a
    coordinate another process owns (:mod:`parallel.multihost`)."""

    def __init__(self, devices, axis_names):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = None if dev is None else torch.device(dev)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.counts = {}
        self.reset_counts()

    def reset_counts(self):
        for name in ("all_gather", "ppermute"):
            self.counts[name] = 0
            self.counts[name + "_bytes"] = 0

    def _count(self, name, nbytes):
        self.counts[name] += 1
        self.counts[name + "_bytes"] += nbytes

    @property
    def size(self) -> int:
        return self.devices.size

    def coords(self):
        """The coordinates this process holds, in row-major order."""
        return [c for c in itertools.product(*map(range, self.devices.shape))
                if self.devices[c] is not None]

    def device(self, coord) -> torch.device:
        return self.devices[coord]

    @property
    def first_device(self) -> torch.device:
        return self.devices[self.coords()[0]]

    def extent(self, axis) -> int:
        """The axis' size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, coord, axis) -> int:
        return coord[self.axis_names.index(axis)] if axis in self.shape else 0

    def group(self, coord, axis):
        """The coordinates that differ from ``coord`` only along ``axis``,
        in axis order."""
        if axis not in self.shape:
            return [coord]
        k = self.axis_names.index(axis)
        return [coord[:k] + (i,) + coord[k + 1:]
                for i in range(self.shape[axis])]

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {self.first_device})"


def _devices(n_devices, devices):
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "no CUDA device for the mesh; pass devices=['cpu'] * D "
                "explicitly for the CPU path")
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devs)} available")
        devs = devs[:n_devices]
    return devs


def make_mesh(n_devices=None, rns=None, coef=None, devices=None,
              batch=None) -> Mesh:
    """A (rns, coef) mesh over the first ``n_devices`` of ``devices``, or a
    (batch, rns, coef) mesh when ``batch`` is given.

    ``devices`` defaults to the visible CUDA cards; it may repeat one card
    (``["cuda:0"] * 4``) or name the CPU (``["cpu"] * 4``).  All devices go
    on the rns axis unless ``rns`` / ``coef`` say otherwise.  Asking for
    more devices than there are raises: the mesh never repeats a card on
    its own.
    """
    devs = _devices(n_devices, devices)
    per = len(devs) // (batch or 1)
    if rns is None and coef is None:
        rns, coef = per, 1
    elif rns is None:
        rns = per // coef
    elif coef is None:
        coef = per // rns
    if (batch or 1) * rns * coef != len(devs) or rns < 1 or coef < 1:
        raise ValueError(f"mesh batch={batch or 1} x rns={rns} x "
                         f"coef={coef} does not cover {len(devs)} devices")
    if batch is None:
        return Mesh(np.array(devs, dtype=object).reshape(rns, coef),
                    ("rns", "coef"))
    return Mesh(np.array(devs, dtype=object).reshape(batch, rns, coef),
                ("batch", "rns", "coef"))


# ----------------------------------------------------------------------
# Specs.
# ----------------------------------------------------------------------


def ct_sharding(mesh: Mesh) -> tuple:
    """[C, N] polynomial: channels over 'rns', coefficients over 'coef'."""
    return tuple(a if a in mesh.shape else None for a in ("rns", "coef"))


def col_sharding(mesh: Mesh) -> tuple:
    """[C, 1] per-channel constants: sharded over 'rns', whole otherwise."""
    return ("rns" if "rns" in mesh.shape else None, None)


def replicated(mesh: Mesh, ndim: int = 2) -> tuple:
    return (None,) * ndim


def fitting_spec(shape, mesh: Mesh, axes=("rns", "coef")) -> tuple:
    """The spec of a [..., C, N] array: the last two dimensions over
    ``axes`` where the mesh has the axis, of more than one shard, and its
    extent divides the dimension; every other dimension whole."""
    tail = tuple(
        a if mesh.extent(a) > 1 and dim % mesh.extent(a) == 0 else None
        for dim, a in zip(shape[-2:], axes)
    )
    return (None,) * (len(shape) - 2) + tail


class ShardedArray:
    """A global array as one block per mesh coordinate.

    ``spec[d]`` is the axis that shards dimension d, or None; the block of
    a coordinate is the global array's slice at that coordinate's index
    along each sharding axis.  Built by :meth:`from_tensor` (or by a sharded
    op from its blocks); :meth:`gather` assembles the global array.
    Blocks are never written in place.
    """

    def __init__(self, blocks: dict, mesh: Mesh, spec, shape, dtype):
        self.blocks = blocks
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.dtype = dtype
        self._gathered = {}
        if len(self.spec) != len(self.shape):
            raise ValueError(f"spec {self.spec} for shape {self.shape}")
        for dim, axis in zip(self.shape, self.spec):
            if axis is not None and dim % mesh.extent(axis):
                raise ValueError(f"axis {axis!r} of extent "
                                 f"{mesh.extent(axis)} does not divide {dim}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def slices(self, coord) -> tuple:
        """The global slice the block at ``coord`` holds."""
        out = []
        for dim, axis in zip(self.shape, self.spec):
            if axis is None:
                out.append(slice(0, dim))
            else:
                size = dim // self.mesh.extent(axis)
                i = self.mesh.index(coord, axis)
                out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def rows(self, coord) -> tuple:
        """(r0, r1): the rows (dimension -2) of the block at ``coord``."""
        sl = self.slices(coord)[-2]
        return sl.start, sl.stop

    @classmethod
    def from_tensor(cls, x: torch.Tensor, mesh: Mesh, spec):
        """Lay ``x`` out over ``mesh`` by ``spec``; each block contiguous on
        its coordinate's device."""
        proto = cls({}, mesh, spec, x.shape, x.dtype)
        made = {}
        for coord in mesh.coords():
            dev = mesh.device(coord)
            sl = proto.slices(coord)
            key = (dev, tuple((s.start, s.stop) for s in sl))
            if key not in made:
                made[key] = x[sl].contiguous().to(dev)
            proto.blocks[coord] = made[key]
        return proto

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the mesh's first
        device), cached."""
        dev = torch.device(device) if device is not None else \
            self.mesh.first_device
        if dev not in self._gathered:
            seen = {}
            for coord, blk in self.blocks.items():
                seen.setdefault(self.slices(coord), blk)
            if math.prod(
                    (s.stop - s.start) for s in next(iter(seen))) * len(
                    seen) != math.prod(self.shape):
                raise ValueError("the blocks of other processes are not "
                                 "here: gather a process-local array")
            if len(seen) == 1:
                out = next(iter(seen.values())).to(dev)
            else:
                out = torch.empty(self.shape, dtype=self.dtype, device=dev)
                for sl, blk in seen.items():
                    out[sl] = blk.to(dev)
            self._gathered[dev] = out
        return self._gathered[dev]

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, spec={self.spec}, "
                f"{self.mesh})")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def all_gather(blocks: dict, mesh: Mesh, axis: str, dim: int = -2) -> dict:
    """Tiled all_gather over ``axis``: each coordinate gets the
    concatenation along ``dim`` of the blocks of its ``axis`` group, on its
    own device.  ``blocks``: coordinate -> tensor (one per coordinate this
    process holds).  One call; the bytes each coordinate receives from the
    others are counted."""
    out, moved = {}, 0
    for coord in blocks:
        group = mesh.group(coord, axis)
        dev = mesh.device(coord)
        parts = []
        for c in group:
            blk = blocks[c]
            if c != coord:
                moved += _nbytes(blk)
            parts.append(blk.to(dev))
        out[coord] = torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]
    mesh._count("all_gather", moved)
    return out


def ppermute(blocks: dict, mesh: Mesh, axis: str, perm) -> dict:
    """Collective permute over ``axis``: ``perm`` lists (source, dest)
    pairs of axis indices; the block of each destination coordinate is its
    source's block, on the destination's device.  One call; the bytes that
    move between shards are counted."""
    src_of = {dst: src for src, dst in perm}
    k = mesh.axis_names.index(axis)
    out, moved = {}, 0
    for coord in blocks:
        if coord[k] not in src_of:
            continue
        src = coord[:k] + (src_of[coord[k]],) + coord[k + 1:]
        blk = blocks[src]
        moved += _nbytes(blk)
        out[coord] = blk.to(mesh.device(coord))
    mesh._count("ppermute", moved)
    return out


def reshard(x: ShardedArray, spec) -> ShardedArray:
    """``x`` laid out by ``spec``: one all_gather for each dimension that
    ``x`` shards and ``spec`` does not, then each block sliced locally."""
    spec = tuple(spec)
    if spec == x.spec:
        return x
    blocks, cur = dict(x.blocks), list(x.spec)
    for d, (have, want) in enumerate(zip(x.spec, spec)):
        if have is not None and have != want:
            blocks = all_gather(blocks, x.mesh, have, dim=d)
            cur[d] = None
    whole = ShardedArray(blocks, x.mesh, cur, x.shape, x.dtype)
    out = ShardedArray({}, x.mesh, spec, x.shape, x.dtype)
    for coord, blk in whole.blocks.items():
        want_sl, have_sl = out.slices(coord), whole.slices(coord)
        local = tuple(slice(w.start - h.start, w.stop - h.start)
                      for w, h in zip(want_sl, have_sl))
        out.blocks[coord] = blk[local].contiguous()
    return out


def shard_leveled(x: torch.Tensor, mesh: Mesh) -> ShardedArray:
    """A [C, N] (or [C, 1]) tensor onto the mesh: channels over 'rns',
    coefficients over 'coef' (a [C, 1] column whole along N)."""
    spec = (ct_sharding(mesh) if x.ndim >= 2 and x.shape[-1] > 1
            else col_sharding(mesh))
    return ShardedArray.from_tensor(x, mesh, (None,) * (x.ndim - 2) + spec)


def shard_ciphertext(ct, mesh: Mesh):
    """A Ciphertext's data onto the mesh (rns x coef)."""
    return type(ct)(
        data=tuple(ShardedArray.from_tensor(d, mesh, (None,) * (d.ndim - 2)
                                            + ct_sharding(mesh))
                   for d in ct.data),
        flags=ct._flags, level=ct.level, **ct.misc,
    )
