"""The kernels' modular product on the host: ``csrc/mont.cuh`` compiled
unchanged by ``g++``.

Every CUDA kernel of ``tiberate_tpu_torch`` inlines the REDC of
``csrc/mont.cuh``; the card tests see it only through whole kernels.  Here
a small shim defines the CUDA qualifiers away, ``g++`` builds the header
into a shared library (a second or so) and ``ctypes`` calls its device
functions on numpy arrays, which are checked against the exact Montgomery
reduction

    (a b + m q) >> 62,   m = ((a b) mod 2^62) k mod 2^62,   k = -q^-1 mod 2^62

in Python integers (the value as a signed 64-bit word), for every prime of
the logN15 and logN17 chains: edge operands and 10^5 random draws a chain,
over non-negative, signed and full-word ranges.  ``redc_by`` (one operand a
table constant in [0, 2^63)) is held to the same value on its range; the
30-bit lane's REDC to its own on the logN15_30 and logN17_30 chains, with
|a|, |b| < 2^29.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from tiberate_tpu_torch.config import CkksConfig

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tiberate_tpu_torch", "csrc")
DRAWS = 100_000

_SHIM = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#include "mont.cuh"

#define TT_MANY(NAME, FN, W, U)                                            \
    extern "C" void NAME(const W* a, const W* b, const U* q, const U* k,   \
                         W* out, long long n) {                            \
        for (long long i = 0; i < n; ++i) out[i] = FN(a[i], b[i], q[i], k[i]); \
    }
TT_MANY(redc_many, redc, i64, u64)
TT_MANY(redc_by_many, redc_by, i64, u64)
TT_MANY(redc30_many, redc, i32, u32)
"""


@pytest.fixture(scope="module")
def mont_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build csrc/mont.cuh on the host")
    d = tmp_path_factory.mktemp("mont_host")
    src, so = d / "mont_host.cpp", d / "libmont_host.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name, w, u in (("redc_many", np.int64, np.uint64),
                       ("redc_by_many", np.int64, np.uint64),
                       ("redc30_many", np.int32, np.uint32)):
        fn = getattr(lib, name)
        fn.argtypes = [np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                       for t in (w, w, u, u, w)] + [ctypes.c_longlong]
        fn.restype = None
    return lib


def _call(lib, name, a, b, q, k, dtype, udtype):
    a, b = (np.ascontiguousarray(v, dtype=dtype) for v in (a, b))
    q, k = (np.ascontiguousarray(v, dtype=udtype) for v in (q, k))
    out = np.empty_like(a)
    getattr(lib, name)(a, b, q, k, out, len(a))
    return out


def _exact(a, b, q, bits):
    """The REDC's value, wrapped to a signed word of 2 + bits bits' lane
    (int64 for bits = 62, int32 for 30)."""
    R = 1 << bits
    k = (-pow(q, -1, R)) % R
    p = a * b
    t = (p + ((p % R) * k % R) * q) >> bits
    w = 64 if bits == 62 else 32
    return (t + (1 << (w - 1))) % (1 << w) - (1 << (w - 1))


def _k(q, bits):
    R = 1 << bits
    return (-pow(q, -1, R)) % R


def _operands(q, rng, n, signed, full):
    """n operands for modulus q: [0, 2q), (-2q, 2q), 62-bit signed, and
    (full) every int64 word, in turn."""
    kinds = [rng.integers(0, 2 * q, n, dtype=np.int64)]
    if signed:
        kinds.append(rng.integers(-2 * q + 1, 2 * q, n, dtype=np.int64))
        kinds.append(rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64))
    if full:
        kinds.append(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                  dtype=np.int64, endpoint=True))
    pick = rng.integers(0, len(kinds), n)
    return np.choose(pick, kinds)


def _edges(q, signed):
    """The operands the kernels' bounds name, for modulus q: 0, 1, q - 1,
    2q - 1, the largest lazy sums tile_add / tile_sub can form (8q - 1),
    R = 2^62, 2^61 - 1 and the ends of the word; negatives where signed."""
    pos = [0, 1, q - 1, q, 2 * q - 1, 4 * q - 1, 8 * q - 1, (1 << 61) - 1,
           1 << 62, (1 << 63) - 1]
    return pos + ([-v for v in pos[1:]] + [-(1 << 63)] if signed else [])


@pytest.mark.parametrize("form", ["redc", "redc_by"])
@pytest.mark.parametrize("preset", ["logN15", "logN17"])
def test_redc62_is_the_exact_reduction(mont_lib, preset, form):
    """redc(a, b) for every pair of int64 words; redc_by(x, c) for every
    x and c in [0, 2^63); both equal to the exact REDC at R = 2^62."""
    primes = CkksConfig.parse(preset).q
    rng = np.random.default_rng(sum(primes) % (1 << 32) + (form == "redc"))
    a_all, b_all, q_all = [], [], []
    for q in primes:
        xs = _edges(q, True)
        cs = _edges(q, form == "redc")
        a_all += [x for x in xs for _ in cs]
        b_all += [c for _ in xs for c in cs]
        q_all += [q] * (len(xs) * len(cs))
    n = DRAWS // len(primes)
    for q in primes:
        a_all += _operands(q, rng, n, True, True).tolist()
        b_all += _operands(q, rng, n, form == "redc", form == "redc").tolist()
        if form == "redc_by":   # constants up to the bound's end too
            b_all[-n // 8:] = rng.integers(0, 1 << 63, n // 8,
                                           dtype=np.int64).tolist()
        q_all += [q] * n
    ks = {q: _k(q, 62) for q in primes}
    got = _call(mont_lib, f"{form}_many", a_all, b_all, q_all,
                [ks[q] for q in q_all], np.int64, np.uint64)
    want = [_exact(a, b, q, 62) for a, b, q in zip(a_all, b_all, q_all)]
    bad = [i for i, (g, w) in enumerate(zip(got.tolist(), want)) if g != w]
    assert not bad, (f"{len(bad)} of {len(want)} differ, first: a={a_all[bad[0]]}"
                     f" b={b_all[bad[0]]} q={q_all[bad[0]]}")
    assert len(want) >= DRAWS


@pytest.mark.parametrize("preset", ["logN15_30", "logN17_30"])
def test_redc30_is_the_exact_reduction(mont_lib, preset):
    """The 30-bit lane's redc for |a|, |b| < 2^29 (its stated range)."""
    primes = CkksConfig.parse(preset).q
    rng = np.random.default_rng(len(primes))
    lim = 1 << 29
    n = DRAWS // len(primes)
    a_all, b_all, q_all = [], [], []
    for q in primes:
        edges = [0, 1, -1, q - 1, 2 * q - 1, -(q - 1), lim - 1, -(lim - 1)]
        a_all += [x for x in edges for _ in edges]
        b_all += [y for _ in edges for y in edges]
        q_all += [q] * len(edges) ** 2
        a_all += rng.integers(-lim + 1, lim, n).tolist()
        b_all += rng.integers(-lim + 1, lim, n).tolist()
        q_all += [q] * n
    got = _call(mont_lib, "redc30_many", a_all, b_all, q_all,
                [_k(q, 30) for q in q_all], np.int32, np.uint32)
    want = [_exact(a, b, q, 30) for a, b, q in zip(a_all, b_all, q_all)]
    assert got.tolist() == want
