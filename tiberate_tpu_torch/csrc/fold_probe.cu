// The fold-rate probe: K chained modular multiplies by one constant, applied
// to every element of a block, the result stored.
//
// Replaces the Pallas kernel `kern` of the VPU op-rate probe
// (benchmarks/profiling/vpu_microbench.py:39, launched at :49), which runs K
// chained _shoup_mult (tiberate_tpu/ops/pallas_mxu.py:132-158) over a
// resident u32-pair block to measure the fold rate the TPU kernels' compute
// bound rests on.  Three entry points:
//
//   tt_fold_shoup    the TPU kernel's own function on one int64 word per
//                    element: t = x1 s1 + ((x1 s0 + x0 s1) >> 31) with the
//                    x0 s0 term dropped (x0, x1, s0, s1 the 31-bit halves of
//                    x and w' = floor(w 2^62 / q)), r = (w x - t q) mod 2^64,
//                    one conditional subtract of 2q.  Native u64 arithmetic:
//                    every product but w x and t q fits 64 bits, and those
//                    two are wanted mod 2^64, so no wide product is needed.
//                    Bit-identical to the u32-pair chain for x, q < 2^61.
//   tt_fold_redc     redc_by(x, w) of csrc/mont.cuh in the i64 lane (R =
//   tt_fold_redc_30  2^62) and in the i32 lane (R = 2^30) - the product by
//                    a constant that every butterfly here inlines, so their
//                    rate is the compute term of the port's roofline
//                    (ops/roofline.py).
//
// w, w' (or k) and q are kernel arguments, never compile-time constants, so
// nvcc cannot strength-reduce the multiplies; every result is stored, so the
// chain is not dead code.  The chain loop is not unrolled (#pragma unroll
// 1): its SASS body is one fold plus the loop's counter, compare and branch,
// which fold_microbench counts.  What bounds it: instruction issue and the
// integer multiply-add pipe that the IMAD-class instructions share (a chain
// step is 18 IMAD-class of 33 instructions in the i64 REDC, 41 with the REDC
// of signed 128-bit halves, 6 of 14 in the i32 one; 568.1 against 535.7
// G-fold/s on the H100, PERF.md), once the chain is long enough that the 16
// (i64) or 8 (i32) bytes an element moves are hidden; the microbench takes
// the rate from two chain lengths so that the bytes and the launch cancel.
// Each element's chain is dependent; the block's 8.4 M elements keep every
// SM at full occupancy, so other warps hide the multiply latency.  A
// grid-stride loop over the block, not tuned.
#include <cuda_runtime.h>

#include "mont.cuh"

#define TT_FOLD_THREADS 256
#define TT_FOLD_MAX_BLOCKS (132 * 32)

__global__ void fold_shoup_kernel(const u64* __restrict__ x,
                                  u64* __restrict__ out, long long n, u64 w,
                                  u64 wp, u64 q, int K) {
    const u64 m31 = (1ULL << 31) - 1;
    const u64 s0 = wp & m31, s1 = wp >> 31;
    const u64 q2 = q << 1;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        u64 v = x[i];
#pragma unroll 1
        for (int j = 0; j < K; ++j) {
            const u64 x0 = v & m31, x1 = v >> 31;
            const u64 t = x1 * s1 + ((x1 * s0 + x0 * s1) >> 31);
            const u64 r = w * v - t * q;
            v = r >= q2 ? r - q2 : r;
        }
        out[i] = v;
    }
}

template <typename W>
__global__ void fold_redc_kernel(const W* __restrict__ x, W* __restrict__ out,
                                 long long n, W w, typename Lane<W>::U q,
                                 typename Lane<W>::U k, int K) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        W v = x[i];
#pragma unroll 1
        for (int j = 0; j < K; ++j) v = redc_by(v, w, q, k);
        out[i] = v;
    }
}

static dim3 fold_grid(long long n) {
    long long blocks = (n + TT_FOLD_THREADS - 1) / TT_FOLD_THREADS;
    if (blocks > TT_FOLD_MAX_BLOCKS) blocks = TT_FOLD_MAX_BLOCKS;
    return dim3((unsigned)(blocks > 0 ? blocks : 1));
}

// x, out: [n] words; w < q < 2^61, wp = floor(w 2^62 / q), x < 2^61.
extern "C" int tt_fold_shoup(const i64* x, i64* out, long long n, i64 w,
                             i64 wp, i64 q, int K, void* stream) {
    fold_shoup_kernel<<<fold_grid(n), TT_FOLD_THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const u64*)x, (u64*)out, n, (u64)w, (u64)wp, (u64)q, K);
    return (int)cudaGetLastError();
}

// x, out: [n] words in [0, 2q); w in [0, 2q); k = -q^-1 mod R.
extern "C" int tt_fold_redc(const i64* x, i64* out, long long n, i64 w,
                            i64 q, i64 k, int K, void* stream) {
    fold_redc_kernel<i64><<<fold_grid(n), TT_FOLD_THREADS, 0,
                            (cudaStream_t)stream>>>(x, out, n, w, (u64)q,
                                                    (u64)k, K);
    return (int)cudaGetLastError();
}

extern "C" int tt_fold_redc_30(const i32* x, i32* out, long long n, i32 w,
                               i32 q, i32 k, int K, void* stream) {
    fold_redc_kernel<i32><<<fold_grid(n), TT_FOLD_THREADS, 0,
                            (cudaStream_t)stream>>>(x, out, n, w, (u32)q,
                                                    (u32)k, K);
    return (int)cudaGetLastError();
}
