// Montgomery arithmetic on 64-bit residues for the Hopper NTT kernels.
//
// Replaces the u32-pair helpers that run inside the Pallas kernels
// (tiberate_tpu/ops/pallas_mont.py, and _shoup_mult / _csub2q /
// _signed_const_mult in tiberate_tpu/ops/pallas_mxu.py).  Those exist
// because Mosaic has no 64-bit integer vectors; Hopper has 64-bit
// registers and __umul64hi, so a residue is one long long here.
//
// R = 2^62.  redc() is the exact Montgomery reduction
//     (a*b + m*q) >> 62,   m = ((a*b) mod 2^62) * k mod 2^62,
// computed in 128 bits for SIGNED a and b.  The 31-bit-half REDC of
// ops/mont.py (and of the JAX package) equals it on every input, including
// the negative digits of the keyswitch basis extension, so the kernels are
// bit-identical to the plain torch versions.
#pragma once

typedef long long i64;
typedef unsigned long long u64;

#define TT_MASK62 ((1ULL << 62) - 1)

__device__ __forceinline__ i64 redc(i64 a, i64 b, u64 q, u64 k) {
    u64 lo = (u64)a * (u64)b;
    u64 hi = __umul64hi((u64)a, (u64)b);
    // signed 128-bit product from the unsigned one
    hi -= (u64)((a >> 63) & b);
    hi -= (u64)((b >> 63) & a);
    u64 m = (lo * k) & TT_MASK62;
    u64 mlo = m * q;
    u64 mhi = __umul64hi(m, q);
    u64 slo = lo + mlo;
    u64 shi = hi + mhi + (slo < lo ? 1ULL : 0ULL);
    // low 64 bits of the arithmetic shift of (shi:slo) by 62
    return (i64)((shi << 2) | (slo >> 62));
}

// lazy [0, 2q) add / sub, the same selects as ops/mont.py
__device__ __forceinline__ i64 lazy_add(i64 a, i64 b, i64 q2) {
    i64 s = a + b;
    return s < q2 ? s : s - q2;
}

__device__ __forceinline__ i64 lazy_sub(i64 a, i64 b, i64 q2) {
    i64 s = a + q2 - b;
    return s < q2 ? s : s - q2;
}

// (-q, 2q) -> [0, q)
__device__ __forceinline__ i64 canon(i64 a, i64 q) {
    a = a < 0 ? a + q : a;
    return a < q ? a : a - q;
}
