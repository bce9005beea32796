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
//     redc(a, b) = (a*b + m*q) >> 62,  m = ((a*b) mod 2^62) * k mod 2^62;
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
//
// The 62-bit REDC forms neither m q's low word nor a 128-bit sum.  With P
// = a*b, lo = P mod 2^64 and k4 = 4k mod 2^64:
//
//   redc(a, b) = floor(P / 2^62) + umulhi(lo * k4, q) + [lo * k4 != 0]
//
// because P + m q = 0 (mod 2^62), so the low 62 bits of P and of m q sum
// to 0 (m = 0) or to 2^62 (the carry); 4m = lo * k4 (mod 2^64) needs no
// mask, and umulhi(4m, q) = floor(m q / 2^62).  The sign costs no
// correction of the high word: the product is taken of the biased words
// a' = a + 2^63 and b' = b + 2^63, both in [0, 2^64), where
//
//   a' b' = a b + 2^63 (a + b) + 2^126,
//
// so floor(a' b' / 2^62) = floor(P / 2^62) + 2 (a + b) (mod 2^64) and the
// low 62 bits, hence m, are P's.  redc() subtracts 2 (a + b) at the end:
// one unsigned 64 x 64 -> 128 product, one low and one high 64-bit
// product, no branch, and the exact value for every pair of i64 words.
// Where one operand is a constant of the program's own tables, c in
// [0, 2^63), redc_by(x, c) biases x alone and subtracts 2c: the same
// value, fewer instructions.  (cuobjdump of the sm_90a build, one step of
// the fold probe's chain with its loop's counter, compare and branch:
// redc_by 33 SASS instructions, 18 IMAD-class, where the REDC with two
// signed 128-bit halves was 41, 18; chip_smoke.py phase 2b, PERF.md.)
//
// The form each call site takes (the constant's range is the reason):
//
//   site                                  form      constant, its range
//   butterflies (ntt.cuh: K1-K6, chain)   redc_by   twiddle psi / ipsi, [0, q)
//   x R entry (K1, K3, K5 pass 1)         redc_by   Rs, [0, q) (R on a
//                                                   coef shard)
//   K6 extension: alpha 1; 30-bit lane    redc_by   Rs / L_enter, [0, q)
//   K6 extension, alpha >= 2 (62-bit)     exact     Rs / L_enter, [0, q):
//                                                   redc_sum_signed once
//                                                   a run of digits
//   K2 / K4 epilogue (inv_strided_k)      redc_by   N^-1 R (or R), 1, pdc,
//                                                   [0, q)
//   fold probe (fold_probe.cu)            redc_by   w, [0, 2q) (checked by
//                                                   ops/fold_probe.py)
//   G1-G3 (glue.cu)                       redc_by   rescale scales, Y, L,
//                                                   PiRs, [0, q)
//   key products (K3, K3 chain; K6 in     redc      keys are data
//   the 30-bit lane)
//   K6 key products (62-bit)              exact     keys are data:
//                                                   redc_sum once a word,
//                                                   fold_sum between runs
//                                                   of parts
//   K5's products (tensor_contig_k)       redc      both data
//
// The 30-bit lane's redc_by is its redc, unchanged.
#pragma once

typedef long long i64;
typedef unsigned long long u64;
typedef int i32;
typedef unsigned int u32;

// The unsigned type that carries a lane's modulus q and k = -q^-1 mod R.
template <typename W> struct Lane;
template <> struct Lane<i64> { typedef u64 U; };
template <> struct Lane<i32> { typedef u32 U; };

#define TT_MASK30 ((1U << 30) - 1)

#define TT_BIAS (1ULL << 63)

typedef unsigned __int128 u128;

// floor(p / 2^62) + floor(m q / 2^62) + [m != 0] (mod 2^64) for a 128-bit
// p in two's complement, m = (p mod 2^62) k mod 2^62: (p + m q) / 2^62,
// the REDC of p itself, wherever that quotient fits a word
__device__ __forceinline__ u64 redc_wide(u128 p, u64 q, u64 k) {
    const u64 m4 = (u64)p * (k << 2);
    const u64 t = (u64)(((u128)m4 * q) >> 64);
    return (u64)(p >> 62) + t + (m4 != 0 ? 1ULL : 0ULL);
}

// the REDC of x y, unsigned, for x, y in [0, 2^64)
__device__ __forceinline__ u64 redc_u(u64 x, u64 y, u64 q, u64 k) {
    return redc_wide((u128)x * y, q, k);
}

// every a, b
__device__ __forceinline__ i64 redc(i64 a, i64 b, u64 q, u64 k) {
    return (i64)(redc_u((u64)a ^ TT_BIAS, (u64)b ^ TT_BIAS, q, k) -
                 (((u64)a + (u64)b) << 1));
}

// every x; c in [0, 2^63)
__device__ __forceinline__ i64 redc_by(i64 x, i64 c, u64 q, u64 k) {
    return (i64)(redc_u((u64)x ^ TT_BIAS, (u64)c, q, k) - ((u64)c << 1));
}

// Sums of products, reduced once (K6, keyswitch.cu).  A sum of exact
// 64 x 64 -> 128-bit products x = hi 2^64 + lo is congruent to
// hi f + lo with f = 2^64 mod q, a number of about 64 + log2 q bits whose
// REDC lands in [0, 2q) where hi f stays below q 2^62 - 2^64:
//
//   redc_sum(x)         x unsigned, hi < 2^64:     [0, 2q) where
//                       hi (q - 1) + 2^64 <= q 2^62;
//   redc_sum_signed(x)  x signed (two's complement), |hi| <= H:
//                       (-q, 2q) where H (q - 1) + 2^64 <= q 2^62.
//
// Both equal REDC(x) mod q: hi f + lo - x is a multiple of q.  The
// signed fold biases hi as redc_by() biases its word: (hi + 2^63) f + lo
// = (hi f + lo) + 2^63 f, whose REDC is 2f more, with the same m (2^63 f
// has no bit below 2^63).  fold_sum(x) is the fold alone, at most (2^64
// - 1) q: a long sum is folded between its terms, so that what follows
// the fold starts from a high word below q.  The host works out, from
// the largest modulus, how many terms a sum takes before its reduction
// or its next fold keeps the bound (ntt_kernels.sum_runs).
__device__ __forceinline__ u128 fold_sum(u128 x, u64 f) {
    return (u128)(u64)(x >> 64) * f + (u64)x;
}

__device__ __forceinline__ i64 redc_sum(u128 x, u64 f, u64 q, u64 k) {
    return (i64)redc_wide(fold_sum(x, f), q, k);
}

__device__ __forceinline__ i64 redc_sum_signed(u128 x, u64 f, u64 q,
                                               u64 k) {
    return (i64)(redc_wide((u128)((u64)(x >> 64) ^ TT_BIAS) * f + (u64)x, q,
                           k) -
                 (f << 1));
}

// |a*b| < 2^58 and m*q < 2^58 on every input the engine feeds (|a|, |b| <
// 2^29), so the sum fits a signed 64-bit word and the shift is exact.
__device__ __forceinline__ i32 redc(i32 a, i32 b, u32 q, u32 k) {
    const i64 p = (i64)a * (i64)b;
    const u32 m = ((u32)p * k) & TT_MASK30;
    return (i32)((p + (i64)m * (i64)q) >> 30);
}

__device__ __forceinline__ i32 redc_by(i32 x, i32 c, u32 q, u32 k) {
    return redc(x, c, q, k);
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
