"""Misc utilities: rotation-offset decomposition, size accounting.

A copy of ``tiberate_tpu/utils/massive.py`` (the port cannot import the
JAX package): a breadth-first search over the available rotation keys plus
the powers of two decomposes a slot offset into at most as many steps as
the pure power-of-2 decomposition.
"""

import math
from collections import deque

import torch


def next_power_of_n(x: int, n: int):
    return n ** math.ceil(math.log(x, n))


def next_power_of_2(n: int):
    return 1 << (n - 1).bit_length()


def next_multiple_of_n(x: int, n: int):
    return n * math.ceil(x / n)


def decompose_with_power_of_2(a: int, n: int) -> list:
    """Decompose offset ``a`` into power-of-2 unit offsets mod ``n``."""
    assert n > 0 and (n & (n - 1)) == 0, "n must be a power of 2"
    if a < 0:
        a = n + a
    result = []
    expo = 0
    while (1 << expo) < n:
        unit = 1 << expo
        if a & unit:
            result.append(unit)
        expo += 1
    return result


def decompose_rot_offsets(offset: int, num_slots: int, rotks) -> list:
    """Decompose a rotation offset using the available keys first.

    Returns a list of unit offsets whose sum is ``offset``; never longer
    than the power-of-2 decomposition.
    """
    best = decompose_with_power_of_2(offset, num_slots)
    max_steps = len(best)

    available = sorted(
        set(list(rotks.keys()) if hasattr(rotks, "keys") else list(rotks))
        | {1 << i for i in range(int(math.log2(num_slots // 2)))}
    )

    bound = num_slots
    visited = {0}
    queue = deque([(0, [])])
    while queue:
        curr, path = queue.popleft()
        if curr == offset:
            if len(path) <= max_steps:
                return path
            break
        for coin in available:
            nxt = curr + coin
            if -bound <= nxt <= bound and nxt not in visited:
                visited.add(nxt)
                queue.append((nxt, [*path, coin]))

    return best


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "data"):
        yield from _tensors(x.data)


def datastruct_size_bytes(obj) -> int:
    """Total byte size of the tensors inside a DataStruct (a GaloisKey's
    rotation keys included) or a nested container."""
    return sum(t.numel() * t.element_size()
               for t in _tensors(obj.data if hasattr(obj, "data") else obj))
