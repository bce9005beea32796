"""Carry keys and ciphertexts from the JAX package into the port.

The JAX package's data structures are read duck-typed — class name,
``data`` leaves through ``np.array``, ``level`` and the flag names — so
this module imports neither jax nor ``tiberate_tpu``.  With it, tests hand
identical keys and ciphertexts to both packages.
"""

import numpy as np
import torch

from tiberate_tpu_torch import typing as tt

_CLASSES = {
    name: getattr(tt, name)
    for name in ("Ciphertext", "SecretKey", "PublicKey", "KeySwitchKey",
                 "EvaluationKey")
}


def to_tensor(x, device="cpu") -> torch.Tensor:
    """An array-like (numpy, jax) -> tensor on ``device``: int32 arrays (the
    30-bit mode's residues) stay int32, every other array becomes int64."""
    x = np.array(x)
    if x.dtype != np.int32:
        x = x.astype(np.int64)
    return torch.from_numpy(x).to(device)


def _leaves(data, device):
    if isinstance(data, (tuple, list)):
        return tuple(_leaves(d, device) for d in data)
    return to_tensor(data, device)


def from_jax(obj, device="cpu"):
    """A JAX-package ``Ciphertext`` / key -> the port's class of the same
    name, with its data on ``device``."""
    name = type(obj).__name__
    if name not in _CLASSES:
        raise TypeError(f"no port counterpart for {name}")
    misc = {
        k: v for k, v in dict(obj.misc).items()
        if isinstance(v, (str, int, float, bool, type(None)))
    }
    return _CLASSES[name](
        data=_leaves(obj.data, device),
        flags=tt.FLAGS.loads(obj._flags.dumps()),
        level=obj.level,
        **misc,
    )
