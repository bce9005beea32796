"""tiberate_tpu_torch — the CKKS engine of ``tiberate_tpu`` on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port beside the JAX package, which stays the reference: same presets and
prime chains, same Montgomery residues (R = 2^62 in int64 tensors; R = 2^30
in int32 tensors for the 30-bit ``"logN15_30"``-style presets), same
``CkksEngine`` method names.  Polynomials are shaped ``[..., C, N]``; the
NTTs, the tensor product, the keyswitch part loop and the P-division run
as CUDA kernels (``csrc/``) on CUDA tensors and as their plain torch
versions on CPU tensors.

This package never imports jax.  Its keys and noise come from the JAX
package's counter-mode ChaCha20 CSPRNG, ported as torch ops
(``rng/csprng.py``): the same seed and nonce give the JAX package's keys
and ciphertexts byte for byte.
"""

from tiberate_tpu_torch import errors
from tiberate_tpu_torch.config import CkksConfig, Preset

__version__ = "0.1.0"

__all__ = ["CkksConfig", "CkksEngine", "Preset", "errors", "__version__"]


def __getattr__(name):
    if name == "CkksEngine":
        from tiberate_tpu_torch.engine import CkksEngine

        return CkksEngine
    raise AttributeError(
        f"module 'tiberate_tpu_torch' has no attribute {name!r}"
    )
