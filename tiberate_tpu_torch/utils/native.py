"""ctypes loader of the native host oracle (``csrc/native_oracle.cpp``).

The port's counterpart of ``tiberate_tpu/utils/native.py``, with the same
entry points.  ``g++ -O2 -shared -fPIC`` builds the library at first use
into ``tiberate_tpu_torch/_build/`` (named by a hash of the source, so an
edited source is rebuilt); where there is no compiler, :func:`load` raises
:class:`NativeUnavailable`.  The oracle is an independent check: exact
``__int128`` arithmetic that shares no code with the kernels or their plain
torch versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "native_oracle.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    """Compile the oracle if needed; returns the library path."""
    if not os.path.exists(_SRC):
        raise NativeUnavailable(f"source not found: {_SRC}")
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libtiberate_native_{digest}.so")
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ not found: the native oracle cannot "
                                "be built")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"  # concurrent builds
    proc = subprocess.run(
        [cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise NativeUnavailable(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


@lru_cache(maxsize=1)
def load():
    lib = ctypes.CDLL(_build())
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.negacyclic_mul.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                   ctypes.c_int64]
    lib.negacyclic_mul.restype = ctypes.c_int
    lib.mont_mult_verify.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                     ctypes.c_int64]
    lib.mont_mult_verify.restype = ctypes.c_int64
    lib.chacha20_blocks.argtypes = [u32p, u32p, ctypes.c_int64]
    lib.chacha20_blocks.restype = None
    lib.is_prime_u64.argtypes = [ctypes.c_uint64]
    lib.is_prime_u64.restype = ctypes.c_int
    lib.shoup_key_row.argtypes = [u64p, ctypes.c_int64, ctypes.c_uint64,
                                  ctypes.c_uint64, ctypes.c_int64, u64p,
                                  u64p]
    lib.shoup_key_row.restype = None
    return lib


def negacyclic_mul(a, b, q: int) -> np.ndarray:
    """Exact a*b mod (X^N+1, q), inputs/outputs [0, q) int64 arrays."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"two [N] polynomials expected, got {a.shape} "
                         f"and {b.shape}")
    out = np.empty_like(a)
    rc = lib.negacyclic_mul(a, b, out, a.shape[-1], q)
    if rc != 0:
        raise ValueError(f"q={q} is not NTT-friendly for N={a.shape[-1]}")
    return out


def mont_mult_verify(a, b, got, q: int) -> int:
    """Number of elements where got !≡ a*b*R^-1 (mod q) or got >= 2q
    (R = 2^62)."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.int64).ravel()
    b = np.ascontiguousarray(b, dtype=np.int64).ravel()
    got = np.ascontiguousarray(got, dtype=np.int64).ravel()
    if not a.size == b.size == got.size:
        raise ValueError("a, b and got must have one size")
    return int(lib.mont_mult_verify(a, b, got, a.size, q))


def chacha20_blocks(states) -> np.ndarray:
    """RFC-7539 block function over [n, 16] uint32 states."""
    lib = load()
    states = np.ascontiguousarray(states, dtype=np.uint32)
    if states.ndim != 2 or states.shape[1] != 16:
        raise ValueError(f"[n, 16] states expected, got {states.shape}")
    out = np.empty_like(states)
    lib.chacha20_blocks(states, out, states.shape[0])
    return out


def is_prime(n: int) -> bool:
    return bool(load().is_prime_u64(n))


def shoup_key_row(k, q: int, rinv: int, rbits: int, w_out, s_out):
    """w = k * rinv mod q and its Shoup companion floor(w << rbits / q)
    for one channel row (u64 arrays; k may be lazy [0, 2q))."""
    lib = load()
    k = np.ascontiguousarray(k, dtype=np.uint64)
    if w_out.shape != k.shape or s_out.shape != k.shape:
        raise ValueError("w_out and s_out must be shaped like k")
    lib.shoup_key_row(k, k.size, q, rinv, rbits, w_out, s_out)
