// Montgomery arithmetic on one-word residues for the Hopper NTT kernels.
//
// Replaces the helpers that run inside the Pallas kernels: the u32-pair
// layer (tiberate_tpu/ops/pallas_mont.py, and _shoup_mult / _csub2q /
// _signed_const_mult in tiberate_tpu/ops/pallas_mxu.py) and the single-lane
// u32 layer of the 30-bit mode (_redc30, _redc_reduce30, _shoup_mult32,
// _sub2q32, _signed_const_mult30: pallas_mxu.py:167-258, :665).  Those
// exist because Mosaic has no 64-bit integer vectors and no wide product;
// Hopper has both, so a residue is one word here and REDC is a product and
// a shift.  Every kernel is a template on the word type W:
//
//   W = i64, R = 2^62 (the 62-bit mode):
//     redc(a, b) = (a*b + m*q) >> 62,  m = ((a*b) mod 2^62) * k mod 2^62,
//     in 128 bits;
//   W = i32, R = 2^30 (the 30-bit mode, q < 2^28):
//     redc(a, b) = (a*b + m*q) >> 30,  m = ((a*b) mod 2^30) * k mod 2^30,
//     in 64 bits.
//
// Both take SIGNED a and b (m from the low bits of the two's-complement
// product, an arithmetic shift at the end).  The half-word REDC of
// ops/mont.py (and of the JAX package) equals them on every input the
// engine feeds, including the negative digits of the keyswitch basis
// extension and the rescale differences, so the kernels are bit-identical
// to the plain torch versions.
#pragma once

typedef long long i64;
typedef unsigned long long u64;
typedef int i32;
typedef unsigned int u32;

// The unsigned type that carries a lane's modulus q and k = -q^-1 mod R.
template <typename W> struct Lane;
template <> struct Lane<i64> { typedef u64 U; };
template <> struct Lane<i32> { typedef u32 U; };

#define TT_MASK62 ((1ULL << 62) - 1)
#define TT_MASK30 ((1U << 30) - 1)

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

// |a*b| < 2^58 and m*q < 2^58 on every input the engine feeds (|a|, |b| <
// 2^29), so the sum fits a signed 64-bit word and the shift is exact.
__device__ __forceinline__ i32 redc(i32 a, i32 b, u32 q, u32 k) {
    const i64 p = (i64)a * (i64)b;
    const u32 m = ((u32)p * k) & TT_MASK30;
    return (i32)((p + (i64)m * (i64)q) >> 30);
}

// lazy [0, 2q) add / sub: the values of ops/mont.py's selects (a + b, less
// 2q where that is >= 2q; a - b, plus 2q where that is < 0) for every
// input, selected on the sign of the difference, which costs one compare
// and subtraction fewer in the 62-bit lane.  With q < 2^60 (i64) or q <
// 2^28 (i32) every sum stays below 8q, inside the word.
template <typename W>
__device__ __forceinline__ W tile_add(W a, W b, W q2) {
    const W s = a + b, d = s - q2;
    return d < 0 ? s : d;
}

template <typename W>
__device__ __forceinline__ W tile_sub(W a, W b, W q2) {
    const W d = a - b;
    return d < 0 ? d + q2 : d;
}

// (-q, 2q) -> [0, q)
template <typename W>
__device__ __forceinline__ W canon(W a, W q) {
    a = a < 0 ? a + q : a;
    return a < q ? a : a - q;
}
