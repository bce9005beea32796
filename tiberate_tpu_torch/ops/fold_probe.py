"""The fold-rate probe: wrappers and plain versions.

The counterpart of the TPU's VPU op-rate probe
(``benchmarks/profiling/vpu_microbench.py``, Pallas kernel ``kern``): K
chained modular multiplies of every element of a block by one constant.
Its CUDA kernels (``csrc/fold_probe.cu``) measure the rate of the fold each
lane of the port runs; :mod:`tiberate_tpu_torch.ops.roofline` turns that
rate into the compute bound of every other kernel.

================  ====================  ==================================
launch count      wrapper               one fold
================  ====================  ==================================
``fold_shoup``    :func:`fold_shoup`    the TPU kernels' ``_shoup_mult``
                                        (int64 words, lazy [0, 2q))
``fold_redc``     :func:`fold_redc`     ``mont.mont_mult`` at R = 2^62
                                        (int64 words)
``fold_redc_30``  :func:`fold_redc`     ``mont.mont_mult`` at R = 2^30
                                        (int32 words)
================  ====================  ==================================

A wrapper dispatches on the device of its input, as the kernels of
``ops/ntt_kernels.py`` do: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel, any other device raises.  Each raises where its
arithmetic stops being exact (the bounds below), so that kernel and plain
version agree bit for bit on every input they accept.
"""

import torch

from tiberate_tpu_torch.ops import cuda_build, mont
from tiberate_tpu_torch.ops.ntt_kernels import _on_cpu

LAUNCHES = {"fold_shoup": 0, "fold_redc": 0, "fold_redc_30": 0}

_M31 = (1 << 31) - 1
# lane of the REDC fold: dtype -> (R bits, launch-count key, C entry point,
# bound on q: the chain stays in [0, 2q) for q < R / 4; at R = 2^30 also
# the |a|, |b| < 2^29 of csrc/mont.cuh's 30-bit redc)
_REDC_LANES = {
    torch.int64: (mont.NBITS, "fold_redc", "tt_fold_redc", 1 << 60),
    torch.int32: (mont.NBITS_30, "fold_redc_30", "tt_fold_redc_30", 1 << 28),
}
_SHOUP_LIMIT = 1 << 61  # q and x: r < 3.5 q stays below 2^63


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_chain(K):
    if not isinstance(K, int) or K < 1:
        raise ValueError(f"chain length K={K!r} must be a positive int")


def _check_range(x, hi, what):
    """Every element of ``x`` in [0, hi) (one reduction; a sync on the
    card)."""
    if x.numel() == 0:
        return
    lo_v, hi_v = (int(v) for v in torch.aminmax(x))
    if lo_v < 0 or hi_v >= hi:
        raise ValueError(f"{what}: x spans [{lo_v}, {hi_v}], outside "
                         f"[0, {hi})")


def _launch(entry, key, x, *consts):
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    rc = getattr(cuda_build.lib(), entry)(
        x.data_ptr(), out.data_ptr(), x.numel(), *consts,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    return out


# ----------------------------------------------------------------------
# The Shoup fold of the TPU kernels.
# ----------------------------------------------------------------------


def _shoup_consts(w: int, q: int):
    """``w' = floor(w 2^62 / q)``; raises outside 0 <= w < q < 2^61."""
    if not 0 < q < _SHOUP_LIMIT:
        raise ValueError(f"q={q} must lie in (0, 2^61)")
    if not 0 <= w < q:
        raise ValueError(f"w={w} must lie in [0, q)")
    return (w << 62) // q


def fold_shoup_plain(x, w: int, q: int, K: int):
    """K chained ``_shoup_mult`` by ``w`` mod ``q`` on int64 ``x`` in
    [0, 2^61): per fold t = x1 s1 + ((x1 s0 + x0 s1) >> 31) (the x0 s0 term
    dropped; halves of 31 bits, s = w'), r = (w x - t q) mod 2^64, one
    conditional subtract of 2q.  Torch's int64 multiply wraps mod 2^64, and
    r < 3.5 q < 2^63, so the signed compare is the TPU kernel's unsigned
    one."""
    wp = _shoup_consts(w, q)
    _check_chain(K)
    if x.dtype != torch.int64:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.int64")
    s0, s1 = wp & _M31, wp >> 31
    for _ in range(K):
        x0, x1 = x & _M31, x >> 31
        t = x1 * s1 + ((x1 * s0 + x0 * s1) >> 31)
        r = x * w - t * q
        x = torch.where(r >= 2 * q, r - 2 * q, r)
    return x


def fold_shoup(x, w: int, q: int, K: int):
    """K chained Shoup folds of every element of ``x`` (int64, values in
    [0, 2^61)) by ``w`` mod ``q`` (0 <= w < q < 2^61); lazy [0, 2q) out."""
    on_cpu = _on_cpu(x)
    wp = _shoup_consts(w, q)
    _check_chain(K)
    if x.dtype != torch.int64:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.int64")
    _check_range(x, _SHOUP_LIMIT, "fold_shoup")
    if on_cpu:
        return fold_shoup_plain(x, w, q, K)
    return _launch("tt_fold_shoup", "fold_shoup", x, w, wp, q, K)


# ----------------------------------------------------------------------
# The REDC fold of the port's kernels (csrc/mont.cuh), in both lanes.
# ----------------------------------------------------------------------


def _redc_lane(x, w: int, q: int):
    """(R bits, key, entry, k) of x's lane; raises outside odd q < the
    lane's bound and 0 <= w < 2q."""
    if x.dtype not in _REDC_LANES:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.int64 or "
                        f"torch.int32")
    bits, key, entry, q_limit = _REDC_LANES[x.dtype]
    if not (0 < q < q_limit and q % 2 == 1):
        raise ValueError(f"q={q} must be odd and below 2^"
                         f"{q_limit.bit_length() - 1} in this lane")
    if not 0 <= w < 2 * q:
        raise ValueError(f"w={w} must lie in [0, 2q)")
    R = 1 << bits
    return bits, key, entry, (R * pow(R, -1, q) - 1) // q


def fold_redc_plain(x, w: int, q: int, K: int):
    """K chained ``mont.mont_mult_raw(x, w)`` (REDC at R = 2^62 for int64
    ``x``, 2^30 for int32), x in [0, 2q): each fold stays in [0, 2q)."""
    bits = _redc_lane(x, w, q)[0]
    _check_chain(K)
    pack = mont.ModPack.from_q([q], R_bits=bits, device=x.device)
    wt = torch.tensor(w, dtype=x.dtype, device=x.device)
    ql, qh, kl, kh = (f.reshape(()) for f in (pack.ql, pack.qh, pack.kl,
                                              pack.kh))
    for _ in range(K):
        x = mont.mont_mult_raw(x, wt, ql, qh, kl, kh)
    return x


def fold_redc(x, w: int, q: int, K: int):
    """K chained REDC folds of every element of ``x`` by ``w`` mod ``q``,
    in the lane of x's dtype: int64 (R = 2^62, odd q < 2^60) or int32
    (R = 2^30, odd q < 2^28); x and w in [0, 2q), lazy [0, 2q) out."""
    on_cpu = _on_cpu(x)
    _, key, entry, k = _redc_lane(x, w, q)
    _check_chain(K)
    _check_range(x, 2 * q, key)
    if on_cpu:
        return fold_redc_plain(x, w, q, K)
    return _launch(entry, key, x, w, q, k, K)
