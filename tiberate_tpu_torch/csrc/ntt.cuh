// Negacyclic NTT stages over one word type W (i64 at R = 2^62, i32 in the
// 30-bit mode; mont.cuh), in two passes.
//
// A logN15 row of i64 is 32768 x 8 B = 256 KB, more than the 227 KB of
// shared memory one block may use, so a transform never holds a whole row.
// Split N = N1 * N2 (N1 = 2^L1, L1 = logN/2, N2 = N / N1) and view the row
// as [N1, N2]:
//
//   * forward stages logm < L1 pair x with x + t, t >= N2: they never mix
//     columns, so a "strided" block owns TC columns of all N1 rows;
//   * forward stages logm >= L1 have t < N2: a "contiguous" block owns
//     chunks of N2 consecutive coefficients.
//
// The inverse runs the same split in the opposite order.  Each stage is the
// radix-2 butterfly of ops/ntt.py with the same twiddle psi[m + i], the
// same operand order and the same lazy reductions, so the output equals the
// plain torch transform bit for bit, in the same bit-reversed order.
//
// Every kernel of ntt.cu (K1-K4 and the keyswitch chain), tensor.cu (K5)
// and keyswitch.cu (K6) runs these stages on the one core below.
#pragma once

#include <cuda_runtime.h>

#include "mont.cuh"

// Lanes a translation unit instantiates: TT_LANE=62 (i64), 30 (i32), or
// both when it is not set.  The build compiles each unit once per lane.
#ifndef TT_LANE
#define TT_LANE 0
#endif
#define TT_I64 (TT_LANE == 0 || TT_LANE == 62)
#define TT_I32 (TT_LANE == 0 || TT_LANE == 30)

// The block's dynamic shared memory as words of type W.
template <typename W>
__device__ __forceinline__ W* smem() {
    extern __shared__ __align__(16) unsigned char tt_smem[];
    return reinterpret_cast<W*>(tt_smem);
}

#define TT_CHECK()                                   \
    do {                                             \
        cudaError_t err_ = cudaGetLastError();       \
        if (err_ != cudaSuccess) return (int)err_;   \
    } while (0)

// ---------------------------------------------------------------------
// Register-tiled core.
//
// A pass works on "lines" of 2^B coefficients: the N1 rows of one column
// (strided pass, B = L1) or one chunk of N2 (contiguous pass, B = L2).
// The forward transforms a line's bits from B-1 down to 0, the inverse
// from 0 up to B-1; the butterfly on bit b of element e takes the twiddle
// T[2^s + (e >> (b + 1))], s = B - 1 - b, from a per-line table T of 2^B
// words that the block stages in shared memory before its first stage:
//
//   strided pass:    T[j] = psi[j]                          (j < N1)
//   contiguous pass: T[2^s + m] = psi[2^(L1+s) + j1 2^s + m] (m < 2^s)
//
// (ipsi for the inverse).  Each thread holds R = 2^RL words of one line
// in registers.  A round is a window of RL consecutive bits [lo, lo+RL):
// thread t's register i holds element slot(t, i, lo), i.e. i's bits at
// lo.., t's bits around them, and the round runs the stages of the
// window's bits on registers alone.  The forward's windows go from the
// top down, the inverse's from bit 0 up; where B is not a multiple of RL
// the last window overlaps bits already done, which ride along untouched.
// Between rounds the line passes once through shared memory: each thread
// stores its registers in the old round's pattern, one barrier (a warp
// barrier where a line lies within one warp), and loads them in the new
// pattern.  Two buffers alternate, so no second barrier guards the
// overwrite.  Every index is a shift or mask of compile-time constants.
//
// What it does about the four costs of a stage-at-a-time NTT: (1) a line
// crosses shared memory once per round of three stages, not once per
// stage, with one barrier per crossing (a warp barrier for a chunk inside
// one warp); (2) the plan (Plan<W, LOGN>) is compile-time, so no
// butterfly divides by a runtime value and every round unrolls; (3) each
// block reads its twiddles from global memory once, into the table; (4)
// strided tiles are 128 B wide in both lanes, blocks take 256-512
// threads, and a thread that holds consecutive words moves them as
// 16-byte vectors.  This core replaces the stages of _make_kernel
// (tiberate_tpu/ops/pallas_mxu.py:445, run by _run_group :1395), of the
// tensor kernel (:1084) and of the parts kernel (:678); ntt.cu,
// tensor.cu and keyswitch.cu say what they measured.
// ---------------------------------------------------------------------
#define TT_RLOG 3             // registers a thread holds: R = 2^TT_RLOG
#define TT_MAX_THREADS 512    // the most threads a strided block takes
#define TT_LINE_BYTES 128     // a strided tile's row: one 128 B line
#define TT_CONTIG_THREADS 256 // threads a contiguous block gathers
#define TT_PAD_SHIFT 3        // contiguous tile: a pad word every 2^3

__host__ __device__ constexpr int tt_log2(int x) {
    return x <= 1 ? 0 : 1 + tt_log2(x >> 1);
}

__host__ __device__ constexpr int tt_min(int a, int b) { return a < b ? a : b; }

// The round schedule of a line of 2^B words, 2^RL registers a thread.
template <int B, int RL>
struct Sched {
    static constexpr int R = 1 << RL;
    static constexpr int T = 1 << (B - RL);  // threads per line
    static constexpr int ROUNDS = (B + RL - 1) / RL;
    static constexpr int NBUF = tt_min(ROUNDS - 1, 2);
    // low bit of round k's window
    __host__ __device__ static constexpr int lo(bool fwd, int k) {
        return fwd ? (B - (k + 1) * RL > 0 ? B - (k + 1) * RL : 0)
                   : ((k + 1) * RL <= B ? k * RL : B - RL);
    }
    // the bits round k transforms: [first, last] (forward: last..first
    // from the top; inverse: first..last from the bottom)
    __host__ __device__ static constexpr int first(bool fwd, int k) {
        return fwd ? lo(true, k) : k * RL;
    }
    __host__ __device__ static constexpr int last(bool fwd, int k) {
        return fwd ? B - 1 - k * RL : tt_min((k + 1) * RL, B) - 1;
    }
};

// Element of a line held by register i of thread t in the window at lo.
__host__ __device__ constexpr int slot(int t, int i, int lo, int rl) {
    return ((t >> lo) << (lo + rl)) | (i << lo) | (t & ((1 << lo) - 1));
}

// Strided tile: element e of column col at s[e * TC + col].
template <int TC>
struct ColLayout {
    int col;
    __device__ __forceinline__ int operator()(int e) const {
        return e * TC + col;
    }
};

// Contiguous chunk: element e at s[e + e / 8] (spreads the strided
// patterns of the low windows over the banks).
struct PadLayout {
    __device__ __forceinline__ int operator()(int e) const {
        return e + (e >> TT_PAD_SHIFT);
    }
};

template <bool WARP>
__device__ __forceinline__ void tile_sync() {
    if (WARP)
        __syncwarp();
    else
        __syncthreads();
}

// The butterflies of bits [BF, BL] on the registers of window LO.
template <typename W, typename U, int B, int RL, int LO, int BF, int BL,
          bool FWD>
__device__ __forceinline__ void butterflies(W (&v)[1 << RL], int t,
                                            const W* T, U q, U k, W q2) {
#pragma unroll
    for (int n = 0; n <= BL - BF; ++n) {
        const int b = FWD ? BL - n : BF + n;
        const int j = b - LO;
#pragma unroll
        for (int i = 0; i < (1 << RL); ++i) {
            if (i & (1 << j)) continue;
            const int h = i | (1 << j);
            const W S = T[(1 << (B - 1 - b)) + (slot(t, i, LO, RL) >> (b + 1))];
            const W U0 = v[i];
            if (FWD) {
                // S: a twiddle of psi, [0, q)
                const W V = redc_by(v[h], S, q, k);
                v[i] = tile_add(U0, V, q2);
                v[h] = tile_sub(U0, V, q2);
            } else {
                const W V = v[h];
                v[i] = tile_add(U0, V, q2);
                // S: a twiddle of ipsi, [0, q)
                v[h] = redc_by(tile_sub(U0, V, q2), S, q, k);
            }
        }
    }
}

// Rounds K.. of a line: exchange into round K's pattern (K > 0), its
// butterflies, then the next round.  buf holds NBUF tiles, bstride words
// apart; lay maps a line element to its word in a tile.
template <typename W, typename U, int B, int RL, bool FWD, bool WARP, int K,
          class Lay>
__device__ __forceinline__ void run_rounds(W (&v)[1 << RL], int t,
                                           const W* T, W* buf, int bstride,
                                           const Lay& lay, U q, U k, W q2) {
    typedef Sched<B, RL> SC;
    constexpr int LO = SC::lo(FWD, K);
    if constexpr (K > 0) {
        constexpr int PLO = SC::lo(FWD, K - 1);
        W* s = buf + ((K - 1) & 1) * bstride;
#pragma unroll
        for (int i = 0; i < SC::R; ++i) s[lay(slot(t, i, PLO, RL))] = v[i];
        tile_sync<WARP>();
#pragma unroll
        for (int i = 0; i < SC::R; ++i) v[i] = s[lay(slot(t, i, LO, RL))];
    }
    butterflies<W, U, B, RL, LO, SC::first(FWD, K), SC::last(FWD, K), FWD>(
        v, t, T, q, k, q2);
    if constexpr (K + 1 < SC::ROUNDS)
        run_rounds<W, U, B, RL, FWD, WARP, K + 1>(v, t, T, buf, bstride, lay,
                                                  q, k, q2);
}

// A contiguous chunk's twiddle table: T[2^s + m] = tw[2^(L1+s) + j1 2^s + m]
// for s < L2, m < 2^s, filled by the chunk's NT threads (T[0] unused).
template <typename W, int L1, int L2, int NT>
__device__ __forceinline__ void chunk_twiddles(W* T, const W* tw, int j1,
                                               int t) {
#pragma unroll
    for (int n = 0; n < (1 << L2) / NT; ++n) {
        const int j = t + n * NT;
        if (j == 0) continue;
        const int s = 31 - __clz(j);
        T[j] = tw[(1 << (L1 + s)) + (j1 << s) + (j - (1 << s))];
    }
}

// The strided register count: TT_RLOG, or more where the block would
// exceed TT_MAX_THREADS.
__host__ __device__ constexpr int strided_rlog(int L1, int TC) {
    int r = tt_min(TT_RLOG, L1);
    while ((TC << (L1 - r)) > TT_MAX_THREADS) ++r;
    return r;
}

// Every launch constant of a transform of 2^LOGN words of type W.
template <typename W, int LOGN>
struct Plan {
    static constexpr int L1 = LOGN / 2, L2 = LOGN - L1;
    static constexpr int N1 = 1 << L1, N2 = 1 << L2;
    // strided pass (bits of j1): TC columns, a line each, T1 threads
    static constexpr int TC = tt_min(N2, TT_LINE_BYTES / (int)sizeof(W));
    static constexpr int LTC = tt_log2(TC);
    static constexpr int RL1 = strided_rlog(L1, TC);
    typedef Sched<L1, RL1> S1;
    static constexpr int T1 = TC * S1::T;
    static constexpr int SMEM1 =
        (N1 + S1::NBUF * N1 * TC) * (int)sizeof(W);
    // contiguous pass (bits within a chunk): CH chunks, a table and NBUF
    // padded tiles each
    static constexpr int RL2 = tt_min(TT_RLOG, L2);
    typedef Sched<L2, RL2> S2;
    static constexpr int TPC = S2::T;
    static constexpr int CH =
        tt_min(N1, TPC >= TT_CONTIG_THREADS ? 1 : TT_CONTIG_THREADS / TPC);
    static constexpr int T2 = CH * TPC;
    static constexpr int P2 = N2 + (N2 >> TT_PAD_SHIFT);
    static constexpr int CHUNK = N2 + S2::NBUF * P2;
    static constexpr int SMEM2 = CH * CHUNK * (int)sizeof(W);
    static constexpr bool WARP2 = TPC <= 32 && T2 >= 32;
};

// R consecutive words, as 16-byte vectors where p is 16-byte aligned.
template <typename W, int R>
__device__ __forceinline__ void ld_vec(W (&v)[R], const W* p) {
    constexpr int PER = 16 / (int)sizeof(W);
    if (R % PER == 0 && ((size_t)p & 15) == 0) {
#pragma unroll
        for (int n = 0; n < R / PER; ++n) {
            const int4 a = reinterpret_cast<const int4*>(p)[n];
            const W* w = reinterpret_cast<const W*>(&a);
#pragma unroll
            for (int i = 0; i < PER; ++i) v[n * PER + i] = w[i];
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
}

template <typename W, int R>
__device__ __forceinline__ void st_vec(W* p, const W (&v)[R]) {
    constexpr int PER = 16 / (int)sizeof(W);
    if (R % PER == 0 && ((size_t)p & 15) == 0) {
#pragma unroll
        for (int n = 0; n < R / PER; ++n) {
            int4 a;
            W* w = reinterpret_cast<W*>(&a);
#pragma unroll
            for (int i = 0; i < PER; ++i) w[i] = v[n * PER + i];
            reinterpret_cast<int4*>(p)[n] = a;
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = v[i];
}

// ---------------------------------------------------------------------
// The forward strided pass on the tile of TC columns blockIdx.x of one
// row: fill(v, xo) puts the words at row offsets xo[i] into the thread's
// registers (a prologue rides in the load), the stages [0, L1) run on the
// core with the row's N1 twiddles tw staged once, and the tile is stored
// to the row out.  K1/K3 (fwd_strided_k), K5 and K6 share it.
// ---------------------------------------------------------------------
template <typename W, int LOGN, class Fill>
__device__ __forceinline__ void fwd_strided_tile(const Fill& fill,
                                                 W* __restrict__ out,
                                                 const W* __restrict__ tw,
                                                 typename Lane<W>::U q,
                                                 typename Lane<W>::U k) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S1 SC;
    typedef typename Lane<W>::U U;
    const int col = threadIdx.x & (P::TC - 1);
    const int t = threadIdx.x >> P::LTC;
    const int x0 = blockIdx.x * P::TC + col;
    constexpr int LO0 = SC::lo(true, 0), LOL = SC::lo(true, SC::ROUNDS - 1);
    int xo[SC::R];
#pragma unroll
    for (int i = 0; i < SC::R; ++i)
        xo[i] = x0 + (slot(t, i, LO0, P::RL1) << P::L2);
    W v[SC::R];
    fill(v, xo);
    W* T = smem<W>();
    for (int j = threadIdx.x; j < P::N1; j += P::T1) T[j] = tw[j];
    __syncthreads();
    run_rounds<W, U, P::L1, P::RL1, true, false, 0>(
        v, t, T, T + P::N1, P::N1 * P::TC, ColLayout<P::TC>{col}, q, k,
        (W)(q << 1));
#pragma unroll
    for (int i = 0; i < SC::R; ++i)
        out[x0 + (slot(t, i, LOL, P::RL1) << P::L2)] = v[i];
}

// Forward, strided pass of K1 and K3: optional x R entry (Rs != NULL),
// stages [0, L1) of TC columns.  Grid (N2 / TC, rows); row = batch * C +
// channel.  Blocks of channels in [skip_lo, skip_hi) return at once (the
// keyswitch in-part shortcut; an empty range skips nothing).
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T1)
fwd_strided_k(const W* __restrict__ x, W* __restrict__ out, int C,
              int skip_lo, int skip_hi, const W* __restrict__ qv,
              const W* __restrict__ kv, const W* __restrict__ psi,
              const W* __restrict__ Rs) {
    typedef typename Plan<W, LOGN>::S1 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;
    const int c = row % C;
    if (c >= skip_lo && c < skip_hi) return;
    const U q = (U)qv[c], k = (U)kv[c];
    const W* xr = x + ((size_t)row << LOGN);
    fwd_strided_tile<W, LOGN>(
        [&](W(&v)[SC::R], const int(&xo)[SC::R]) {
#pragma unroll
            for (int i = 0; i < SC::R; ++i) v[i] = xr[xo[i]];
            if (Rs != nullptr) {
                const W rs = Rs[c];  // R^2 mod q, or R on a coef shard
#pragma unroll
                for (int i = 0; i < SC::R; ++i)
                    v[i] = redc_by(v[i], rs, q, k);
            }
        },
        out + ((size_t)row << LOGN), psi + ((size_t)c << LOGN), q, k);
}

// One chunk's forward stages [L1, logN) in registers, its twiddle table T
// staged: the chunk src (N2 words) is loaded in round 0's pattern and every
// round runs; on return thread t holds words tR .. tR+R-1.  K5 and K6 run
// several lines through one table and one pair of exchange buffers: with
// three rounds the two buffers' barriers separate one line's reads from
// the next line's writes, with two rounds (one buffer) a barrier at the
// end does.
template <typename W, int LOGN>
__device__ __forceinline__ void fwd_chunk(W (&v)[Plan<W, LOGN>::S2::R],
                                          const W* __restrict__ src, int t,
                                          W* T, typename Lane<W>::U q,
                                          typename Lane<W>::U k, W q2) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S2 SC;
    typedef typename Lane<W>::U U;
    constexpr int LO0 = SC::lo(true, 0);
#pragma unroll
    for (int i = 0; i < SC::R; ++i) v[i] = src[slot(t, i, LO0, P::RL2)];
    run_rounds<W, U, P::L2, P::RL2, true, P::WARP2, 0>(
        v, t, T, T + P::N2, P::P2, PadLayout{}, q, k, q2);
    if constexpr (SC::ROUNDS == 2) tile_sync<P::WARP2>();
}

// ---------------------------------------------------------------------
// Launch helpers.
// ---------------------------------------------------------------------
// Dynamic shared memory above 48 KB must be allowed per kernel, once.
template <typename K>
static bool allow_smem(K kernel, int bytes) {
    return bytes <= 48 * 1024 ||
           cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes) == cudaSuccess;
}

// FN<W, logN>(args...) for logN in [4, 17] (ops/ntt_kernels.py checks it).
#define TT_BY_LOGN(FN, ...)                               \
    switch (logN) {                                       \
        case 4: return FN<W, 4>(__VA_ARGS__);             \
        case 5: return FN<W, 5>(__VA_ARGS__);             \
        case 6: return FN<W, 6>(__VA_ARGS__);             \
        case 7: return FN<W, 7>(__VA_ARGS__);             \
        case 8: return FN<W, 8>(__VA_ARGS__);             \
        case 9: return FN<W, 9>(__VA_ARGS__);             \
        case 10: return FN<W, 10>(__VA_ARGS__);           \
        case 11: return FN<W, 11>(__VA_ARGS__);           \
        case 12: return FN<W, 12>(__VA_ARGS__);           \
        case 13: return FN<W, 13>(__VA_ARGS__);           \
        case 14: return FN<W, 14>(__VA_ARGS__);           \
        case 15: return FN<W, 15>(__VA_ARGS__);           \
        case 16: return FN<W, 16>(__VA_ARGS__);           \
        case 17: return FN<W, 17>(__VA_ARGS__);           \
        default: return (int)cudaErrorInvalidValue;       \
    }
