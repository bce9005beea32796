"""Carry keys, ciphertexts, packed tensors, HE-NN layers and generator
state from the JAX package into the port.

The JAX package's objects are read duck-typed — class name, ``data``
leaves through ``np.array``, ``level``, the flag names and the scalar
``misc`` entries (``a_seed``, ``compressed``, a rotation key's ``delta``);
a ``GaloisKey``'s rotation keys one by one; a ``Plaintext``'s source,
scale, padding and cached rows; a ``PackedCT``'s nested ciphertexts and
metadata; an HE-NN layer's numpy parameters and ``Plaintext`` rows; a
``Csprng``'s channel model, key, nonce and states — so this module imports
neither jax nor ``tiberate_tpu``.  With it, tests hand identical keys,
ciphertexts, layers and random streams to both packages.
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
_LAYERS = ("HELinearFeatureWise", "HELayerNormFeatureWise")


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


def _nested(x, device):
    if isinstance(x, list):
        return [_nested(v, device) for v in x]
    return from_jax(x, device)


def _packed_ct(obj, device):
    from tiberate_tpu_torch.extension import packing

    md = obj.metadata
    by_name = {c.__name__: c for c in (packing.FeatureWisePacking,
                                       packing.FeatureWiseCTEncoding)}
    return packing.PackedCT(
        cts=_nested(obj.cts, device),
        metadata=packing.PackingMetadata(
            original_shape=md.original_shape,
            logical_num_slots=md.logical_num_slots,
            packed_by=by_name.get(getattr(md.packed_by, "__name__", None)),
            encoded_by=by_name.get(getattr(md.encoded_by, "__name__", None)),
            misc=dict(md.misc),
        ),
    )


def _layer(obj, engine):
    """A JAX HE-NN layer rebuilt as the port's, on ``engine``: the
    parameters it holds (numpy) and its ``Plaintext`` rows with their
    cached encodings, on the engine's device."""
    from tiberate_tpu_torch.extension import nn

    if engine is None:
        raise ValueError(f"carrying a {type(obj).__name__} over needs the "
                         f"port engine it is to run on (engine=)")
    device = engine.device
    if type(obj).__name__ == "HELayerNormFeatureWise":
        return nn.HELayerNormFeatureWise(
            obj.gamma, obj.beta, engine, eps=obj.eps,
            var_range=obj.var_range, iters=obj.iters)
    layer = object.__new__(nn.HELinearFeatureWise)
    layer.engine = engine
    layer.dim, layer.logical = obj.dim, obj.logical
    layer.fold, layer.period = obj.fold, obj.period
    layer.weight_rows = [[from_jax(pt, device) for pt in row]
                         for row in obj.weight_rows]
    layer.bias_rows = (None if obj.bias_rows is None
                       else [from_jax(pt, device) for pt in obj.bias_rows])
    layer.mask = from_jax(obj.mask, device)
    return layer


def from_jax(obj, device="cuda", engine=None):
    """A JAX-package ``Ciphertext`` / key / ``Plaintext`` / ``PackedCT`` ->
    the port's class of the same name, with its data on ``device``; a
    ``HELinearFeatureWise`` or ``HELayerNormFeatureWise`` -> the port's
    layer on the port ``engine`` (its device)."""
    name = type(obj).__name__
    if name == "PackedCT":
        return _packed_ct(obj, device)
    if name in _LAYERS:
        return _layer(obj, engine)
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
