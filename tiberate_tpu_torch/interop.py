"""Carry keys, ciphertexts and generator state from the JAX package into
the port.

The JAX package's objects are read duck-typed — class name, ``data``
leaves through ``np.array``, ``level``, the flag names and the scalar
``misc`` entries (``a_seed``, ``compressed``, a rotation key's ``delta``);
a ``GaloisKey``'s rotation keys one by one; a ``Plaintext``'s source,
scale, padding and cached rows; a ``Csprng``'s channel model, key, nonce
and states — so this module imports neither jax nor ``tiberate_tpu``.
With it, tests hand identical keys, ciphertexts and random streams to
both packages.
"""

import numpy as np
import torch

from tiberate_tpu_torch import typing as tt

_CLASSES = {
    name: getattr(tt, name)
    for name in ("Ciphertext", "CiphertextTriplet", "SecretKey", "PublicKey",
                 "KeySwitchKey", "EvaluationKey", "RotationKey",
                 "ConjugationKey", "GaloisKey", "Plaintext")
}


def to_tensor(x, device="cuda") -> torch.Tensor:
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


def from_jax(obj, device="cuda"):
    """A JAX-package ``Ciphertext`` / key / ``Plaintext`` -> the port's
    class of the same name, with its data on ``device``."""
    name = type(obj).__name__
    if name not in _CLASSES:
        raise TypeError(f"no port counterpart for {name}")
    misc = {
        k: v for k, v in dict(obj.misc).items()
        if isinstance(v, (str, int, float, bool, type(None)))
    }
    if name == "Plaintext":
        pt = tt.Plaintext(np.array(obj.src), **misc)
        for level, ops in obj.cache.items():
            for op, row in ops.items():
                pt.cache[level][op] = _leaves(row, device)
        return pt
    if name == "GaloisKey":
        data = [from_jax(k, device) for k in obj.data]
    else:
        data = _leaves(obj.data, device)
    return _CLASSES[name](
        data=data,
        flags=tt.FLAGS.loads(obj._flags.dumps()),
        level=obj.level,
        **misc,
    )


def csprng_from_jax(rng, device="cuda"):
    """A JAX-package ``Csprng`` -> a port ``Csprng`` on ``device`` that
    continues the same stream: the same channel model, key and nonce, and
    the JAX generator's current states (counters included)."""
    from tiberate_tpu_torch.rng.csprng import Csprng

    out = Csprng(
        num_coefs=rng.num_coefs, num_channels=rng.num_channels,
        num_repeating_channels=rng.num_repeating_channels, sigma=rng.sigma,
        seed=list(rng.key), nonce=list(rng.nonce), device=device,
    )
    states = to_tensor(np.array(rng.states), device)
    if states.shape != out.states.shape:
        raise ValueError(f"states {tuple(states.shape)} do not fit the "
                         f"channel model {tuple(out.states.shape)}")
    out.states = states
    return out
