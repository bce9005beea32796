"""Multi-process runtime plumbing on ``torch.distributed``.

The torch counterpart of ``tiberate_tpu/parallel/multihost.py``.  One
process per host runs the same program; the ``batch`` axis of the global
mesh spans the processes and each process owns its local (rns, coef) mesh,
so every collective of the sharded ops stays inside a process.  What
crosses processes is initialization, key broadcast and the batch scatter.

The backend is the caller's argument (default ``"gloo"``, which serves the
CPU and, through the host, processes that share one card: NCCL refuses two
ranks on one GPU); it is never switched.  Key bytes travel through the
host, as in the JAX package: CPU tensors broadcast over the process group.
"""

import numpy as np
import torch
import torch.distributed as dist

from tiberate_tpu_torch.parallel import mesh as meshlib
from tiberate_tpu_torch.typing import DataStruct


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_multihost(coordinator=None, num_processes=None, process_id=None,
                   backend="gloo"):
    """Join the process group (``tcp://<coordinator>``, e.g.
    ``"localhost:29500"``); a no-op for ``num_processes`` None or 1, or a
    group already joined.  Returns (process_index, process_count)."""
    if num_processes is not None and num_processes > 1 and \
            not dist.is_initialized():
        if coordinator is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator and "
                             "process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
    return _world()


def global_mesh(rns=None, coef=None, batch=None, devices=None):
    """The (batch, rns, coef) mesh of every process: ``batch`` (default:
    the process count) a multiple of the process count, each process's
    share of it on its local ``devices`` (default: its visible CUDA cards;
    ``["cpu"] * k`` for the CPU).  Coordinates of other processes hold no
    device here."""
    rank, world = _world()
    batch = batch or world
    if batch % world:
        raise ValueError(f"batch={batch} is not a multiple of the "
                         f"{world} processes")
    local = meshlib.make_mesh(devices=devices, rns=rns, coef=coef,
                              batch=batch // world)
    per = batch // world
    grid = np.empty((batch,) + local.devices.shape[1:], dtype=object)
    grid[rank * per:(rank + 1) * per] = local.devices
    return meshlib.Mesh(grid, ("batch", "rns", "coef"))


def _leaves(obj, fn):
    """``obj`` with ``fn`` applied to each tensor / array leaf (tuples,
    lists, dicts and typed structures' data)."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if isinstance(obj, DataStruct):
        return type(obj)(data=_leaves(obj.data, fn), flags=obj._flags,
                         level=obj.level, **obj.misc)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_leaves(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _leaves(v, fn) for k, v in obj.items()}
    return obj


def broadcast_key(key_struct, from_process: int = 0, device="cuda"):
    """Make key material identical in every process.

    Keys made by an identically seeded CSPRNG are equal already; a key
    held by one process only (loaded from a file there) is broadcast here:
    the source contributes its tensors, every other process same-shaped
    placeholders, and all return the source's values, on ``device``.  The
    bytes pass through the host (numpy -> CPU tensors -> the group)."""
    rank, world = _world()

    def move(x):
        host = torch.from_numpy(np.ascontiguousarray(
            x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x))
        if world > 1:
            dist.broadcast(host, src=from_process)
        return host.to(device)

    return _leaves(key_struct, move)


def scatter_batch(cts, mesh, axis="batch"):
    """This process's ciphertext arrays (a list of tensors, or of tuples of
    them) stacked into its share of the global batch: ShardedArrays over
    ``axis`` whose global leading dimension concatenates every process's
    batch (the blocks of other processes live there)."""
    rank, world = _world()

    def stack(*xs):
        x = torch.stack(xs)
        shape = (x.shape[0] * world,) + tuple(x.shape[1:])
        per = mesh.extent(axis) // world
        local = x.shape[0] // per
        if x.shape[0] % per:
            raise ValueError(f"{x.shape[0]} ciphertexts do not split over "
                             f"{per} local {axis!r} shards")
        spec = (axis,) + (None,) * (x.ndim - 1)
        out = meshlib.ShardedArray({}, mesh, spec, shape, x.dtype)
        for c in mesh.coords():
            i = mesh.index(c, axis) - rank * per
            out.blocks[c] = x[i * local:(i + 1) * local].contiguous().to(
                mesh.device(c))
        return out

    if isinstance(cts[0], (list, tuple)):
        return type(cts[0])(stack(*xs) for xs in zip(*cts))
    return stack(*cts)


def local_batch(x, axis="batch"):
    """This process's rows of a ShardedArray over ``axis`` (the inverse of
    :func:`scatter_batch`), assembled on its mesh's first local device."""
    mesh = x.mesh
    if x.spec[0] != axis:
        raise ValueError(f"{x} is not sharded over {axis!r} first")
    rows = {}
    for c in mesh.coords():
        i = mesh.index(c, axis)
        rows.setdefault(i, {})[c] = x.blocks[c]
    parts = []
    for i in sorted(rows):
        sub = meshlib.ShardedArray(
            rows[i], mesh, (None,) + x.spec[1:],
            (x.shape[0] // mesh.extent(axis),) + x.shape[1:], x.dtype)
        parts.append(sub.gather())
    return torch.cat(parts)
