// The engine's stacked linear op (CkksEngine.mult_matrix) as one kernel:
// a modular matrix product over a stack of ciphertexts,
//
//   out[p][j][c][n] = (acc[p][j][c][n] +) sum_i W[i][j] x[p][i][c][n]  mod q_c
//
// for both polynomials p of F_in input ciphertexts x [F_in, C, N] (rows N
// words apart, one feature stride) and F_out outputs [F_out, C, N]
// (contiguous), with one signed integer weight W[i][j] for every channel
// (the mult_scalar encoding of a real weight).  With features as
// ciphertexts and tokens in the slots, a linear layer is this product and
// needs no rotation and no key.
//
// It replaces no TPU kernel: the JAX package has no such op.  The engine
// ran it, one output at a time, as a per-row product by a column, a tree
// of additions and a rescale: tens of GB of traffic an output.
//
// What bounds it: products, F_in F_out 2 N C of them, each of a residue
// of up to 60 bits by a weight of about 37.  Bytes are few by comparison
// (the inputs and outputs once, the weights from L2).  The design does
// the products exactly in float64 fused multiply-adds, which Hopper
// issues at 64 a clock on each SM on a pipe of their own:
//
//   * a residue x < q splits into XL limbs of 21 bits (2 below 2^42, 3
//     below 2^63); a weight into L balanced limbs of 21 bits, each in
//     [-2^20, 2^20] (the host splits the weights once, ops/matmul.py;
//     L = 3 holds any weight below 2^62);
//   * limb a of x times limb l of W lands in the sum of shift 21 (a + l);
//     a sum takes at most min(XL, L) products of magnitude below 2^41 a
//     term, so that K terms stay integers below 2^53, exact in float64,
//     for K up to ops/matmul.py's matmul_run (4096 at L = 1, 2048 at L =
//     2, 1365 at L = 3); the wrapper splits a longer sum into runs, each
//     run's output the next one's accumulator;
//   * each output word reduces once its sum is complete: the sums of
//     shift below 84, shifted and added as a signed 128-bit integer
//     (below 2^118), with the accumulator's word, go through mont.cuh's
//     redc_sum_signed (the fold by 2^64 mod q and one REDC); the sum of
//     shift 84 (XL = L = 3 alone) goes in at shift 22 through its own
//     redc_sum_signed and a REDC by 2^124 mod q, which multiplies by 2^62
//     (2^84 2^-62 = 2^22); one REDC by 2^124 mod q of the total takes the
//     2^-62 back out (62-bit lane).  The 30-bit lane takes each sum modulo
//     q in 64-bit integers and combines them with 2^21s mod q.
//
// Output canonical in [0, q), byte for byte ops/matmul.py's plain version.
//
// Tiling: a block of 256 threads owns 64 outputs by 64 coefficients of one
// channel of one polynomial and walks the input features 8 at a time.
// Each stage, every thread loads two words of x and four weight limbs
// into registers for the next stage while the block works on the current
// one from shared memory (x as float64 limbs, [8][3][64]; the weights as
// [8][L][64]); each thread keeps 4 outputs by 4 coefficients, XL + L - 1
// sums each, in registers (L = 3 is for blocks that hold an outlier
// weight above about 2^41; its 80 sums a thread may spill).  The blocks of one column tile run next to
// each other (the output tile varies fastest), so x is read from device
// memory about once and the weights stay in L2.
//
// Two lanes: tt_matmul (62-bit, i64 words) and tt_matmul_30 (30-bit, i32);
// the build compiles this file once per lane (TT_LANE).
#include <math.h>

#include "ntt.cuh"

#define TT_MM_T 256     // threads a block: 16 along the outputs, 16 along n
#define TT_MM_TJ 64     // outputs a block
#define TT_MM_TN 64     // coefficients a block
#define TT_MM_TK 8      // input features a stage
#define TT_MM_R 4       // outputs and coefficients a thread, each way
#define TT_MM_LB 21     // bits of a limb
#define TT_MM_XL 3      // most limbs of a residue
#define TT_MM_L 3       // most limbs of a weight

// sums [XL + L - 1] of one output word (each an integer below 2^53, so
// its conversion is exact), plus acc (in [0, q)), mod q
template <typename W>
__device__ __forceinline__ W mm_reduce(const double* s, int ns, W acc,
                                       W q, W k, W f, W r2);

template <>
__device__ __forceinline__ i64 mm_reduce<i64>(const double* s, int ns,
                                              i64 acc, i64 q, i64 k, i64 f,
                                              i64 r2) {
    __int128 t = acc;
    for (int i = 0; i < ns && i < 4; ++i)
        t += (__int128)(long long)s[i] << (TT_MM_LB * i);
    i64 v = redc_sum_signed((u128)t, (u64)f, (u64)q, (u64)k);  // (-q, 2q)
    if (ns > 4) {
        // s[4] 2^84 = (s[4] 2^22 2^-62) 2^124 2^-62 2^62: (-q, 2q) more
        const __int128 t4 = (__int128)(long long)s[4] << (4 * TT_MM_LB - 62);
        v += redc_by(redc_sum_signed((u128)t4, (u64)f, (u64)q, (u64)k), r2,
                     (u64)q, (u64)k);
    }
    return canon(redc_by(v, r2, (u64)q, (u64)k), q);
}

template <>
__device__ __forceinline__ i32 mm_reduce<i32>(const double* s, int ns,
                                              i32 acc, i32 q, i32, i32,
                                              i32) {
    const long long m = q;
    const long long c = (1LL << TT_MM_LB) % m;
    long long r = acc, p = 1;
    for (int i = 0; i < ns; ++i) {
        const long long v = ((long long)s[i] % m + m) % m;
        r = (r + v * p) % m;
        p = p * c % m;
    }
    return (i32)r;
}

struct MmArgs {
    long long x_fs, w_ls;
    int F_in, F_out, C, N, tiles_j, tiles_n;
};

template <typename W, int L, int XL>
__device__ __forceinline__ void mm_body(const W* __restrict__ x,
                                        const double* __restrict__ wl,
                                        const W* acc, W* out, const MmArgs a,
                                        int c, int j0, int n0, W q, W k, W f,
                                        W r2) {
    typedef typename Lane<W>::U U;
    constexpr int NS = XL + L - 1;
    constexpr u64 MASK = (1ULL << TT_MM_LB) - 1;
    double* xs = smem<double>();                          // [TK][XL_MAX][TN]
    double* ws = xs + TT_MM_TK * TT_MM_XL * TT_MM_TN;     // [TK][L][TJ]
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;
    // the stage's loads: row t / 32 of the stage, two neighbouring words
    const int lk = t / 32, lc = (t % 32) * 2;
    const W* xg = x + (size_t)c * a.N + n0 + lc;
    const double* wg = wl + j0 + lc;

    W xv[2];
    double wv[L][2];
    auto fetch = [&](int k0) {
        const int kk = k0 + lk;
        const bool in = kk < a.F_in;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            xv[e] = in ? xg[kk * a.x_fs + e] : (W)0;
#pragma unroll
            for (int l = 0; l < L; ++l)
                wv[l][e] = in && j0 + lc + e < a.F_out
                               ? wg[l * a.w_ls + (long long)kk * a.F_out + e]
                               : 0.0;
        }
    };

    double s[NS][TT_MM_R][TT_MM_R];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int r = 0; r < TT_MM_R; ++r)
#pragma unroll
            for (int m = 0; m < TT_MM_R; ++m) s[i][r][m] = 0.0;

    fetch(0);
    for (int k0 = 0; k0 < a.F_in; k0 += TT_MM_TK) {
        __syncthreads();   // the last stage's reads are done
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const u64 u = (u64)(U)xv[e];
#pragma unroll
            for (int b = 0; b < XL; ++b)
                xs[(lk * TT_MM_XL + b) * TT_MM_TN + lc + e] =
                    (double)((u >> (TT_MM_LB * b)) & MASK);
#pragma unroll
            for (int l = 0; l < L; ++l)
                ws[(lk * L + l) * TT_MM_TJ + lc + e] = wv[l][e];
        }
        __syncthreads();
        if (k0 + TT_MM_TK < a.F_in) fetch(k0 + TT_MM_TK);
#pragma unroll
        for (int kk = 0; kk < TT_MM_TK; ++kk) {
            double xr[XL][TT_MM_R], wr[L][TT_MM_R];
#pragma unroll
            for (int b = 0; b < XL; ++b)
#pragma unroll
                for (int m = 0; m < TT_MM_R; ++m)
                    xr[b][m] = xs[(kk * TT_MM_XL + b) * TT_MM_TN +
                                  tx * TT_MM_R + m];
#pragma unroll
            for (int l = 0; l < L; ++l)
#pragma unroll
                for (int r = 0; r < TT_MM_R; ++r)
                    wr[l][r] = ws[(kk * L + l) * TT_MM_TJ + ty * TT_MM_R + r];
#pragma unroll
            for (int b = 0; b < XL; ++b)
#pragma unroll
                for (int l = 0; l < L; ++l)
#pragma unroll
                    for (int r = 0; r < TT_MM_R; ++r)
#pragma unroll
                        for (int m = 0; m < TT_MM_R; ++m)
                            s[b + l][r][m] =
                                fma(xr[b][m], wr[l][r], s[b + l][r][m]);
        }
    }

#pragma unroll
    for (int r = 0; r < TT_MM_R; ++r) {
        const int j = j0 + ty * TT_MM_R + r;
        if (j >= a.F_out) continue;
        const size_t o = ((size_t)j * a.C + c) * a.N + n0 + tx * TT_MM_R;
#pragma unroll
        for (int m = 0; m < TT_MM_R; ++m) {
            double v[NS];
#pragma unroll
            for (int i = 0; i < NS; ++i) v[i] = s[i][r][m];
            out[o + m] = mm_reduce<W>(v, NS, acc ? acc[o + m] : (W)0, q, k, f,
                                      r2);
        }
    }
}

// grid (tiles_j * C * tiles_n, 2): block b owns output tile b % tiles_j
// of column tile b / tiles_j (channel, then coefficients) of polynomial
// blockIdx.y.  acc may be null or out itself (each word is read before
// the same thread writes it).
template <typename W, int L>
__global__ void __launch_bounds__(TT_MM_T, 1)
matmul_k(const W* __restrict__ x0, const W* __restrict__ x1,
         const double* __restrict__ wl, const W* acc0, const W* acc1,
         W* out0, W* out1, const MmArgs a, const W* __restrict__ qv,
         const W* __restrict__ kv, const W* __restrict__ fv,
         const W* __restrict__ rv) {
    const long long b = blockIdx.x;
    const int jt = (int)(b % a.tiles_j);
    const long long col = b / a.tiles_j;
    const int c = (int)(col / a.tiles_n);
    const int n0 = (int)(col % a.tiles_n) * TT_MM_TN;
    const int j0 = jt * TT_MM_TJ;
    const bool p1 = blockIdx.y != 0;
    const W* x = p1 ? x1 : x0;
    const W* acc = p1 ? acc1 : acc0;
    W* out = p1 ? out1 : out0;
    const W q = qv[c];
    if ((u64)q >= (1ULL << (2 * TT_MM_LB)))
        mm_body<W, L, 3>(x, wl, acc, out, a, c, j0, n0, q, kv[c], fv[c],
                         rv[c]);
    else
        mm_body<W, L, 2>(x, wl, acc, out, a, c, j0, n0, q, kv[c], fv[c],
                         rv[c]);
}

// x0, x1 [F_in, C, N] (feature stride x_fs, rows N apart); wl [L][F_in]
// [F_out] float64 limbs, limb l at wl + l w_ls; acc0, acc1 null or
// [F_out, C, N]; out0, out1 [F_out, C, N]; q, k, f (2^64 mod q), r2
// (2^124 mod q): [C].
template <typename W>
static int matmul(const W* x0, const W* x1, long long x_fs, const double* wl,
                  long long w_ls, int L, int F_in, int F_out, const W* acc0,
                  const W* acc1,
                  W* out0, W* out1, int C, int N, const W* q, const W* k,
                  const W* f, const W* r2, void* stream) {
    if (F_in < 1 || F_out < 1 || C < 1 || N < TT_MM_TN || N % TT_MM_TN ||
        L < 1 || L > TT_MM_L || (acc0 == nullptr) != (acc1 == nullptr))
        return (int)cudaErrorInvalidValue;
    MmArgs a;
    a.x_fs = x_fs;
    a.w_ls = w_ls;
    a.F_in = F_in;
    a.F_out = F_out;
    a.C = C;
    a.N = N;
    a.tiles_j = (F_out + TT_MM_TJ - 1) / TT_MM_TJ;
    a.tiles_n = N / TT_MM_TN;
    const long long blocks = (long long)a.tiles_j * C * a.tiles_n;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks, 2);
    const int sm = (TT_MM_TK * TT_MM_XL * TT_MM_TN +
                    TT_MM_TK * L * TT_MM_TJ) * (int)sizeof(double);
    if (L == 1)
        matmul_k<W, 1><<<grid, TT_MM_T, sm, (cudaStream_t)stream>>>(
            x0, x1, wl, acc0, acc1, out0, out1, a, q, k, f, r2);
    else if (L == 2)
        matmul_k<W, 2><<<grid, TT_MM_T, sm, (cudaStream_t)stream>>>(
            x0, x1, wl, acc0, acc1, out0, out1, a, q, k, f, r2);
    else
        matmul_k<W, 3><<<grid, TT_MM_T, sm, (cudaStream_t)stream>>>(
            x0, x1, wl, acc0, acc1, out0, out1, a, q, k, f, r2);
    TT_CHECK();
    return 0;
}

#define TT_MATMUL_ENTRY(SFX, W)                                              \
    extern "C" int tt_matmul##SFX(                                           \
        const W* x0, const W* x1, long long x_fs, const double* wl,          \
        long long w_ls, int L, int F_in, int F_out, const W* acc0,           \
        const W* acc1, W* out0, W* out1, int C, int N, const W* q,           \
        const W* k, const W* f, const W* r2, void* stream) {                 \
        return matmul(x0, x1, x_fs, wl, w_ls, L, F_in, F_out, acc0, acc1,    \
                      out0, out1, C, N, q, k, f, r2, stream);                \
    }

#if TT_I64
TT_MATMUL_ENTRY(, i64)
#endif

#if TT_I32
TT_MATMUL_ENTRY(_30, i32)
#endif
