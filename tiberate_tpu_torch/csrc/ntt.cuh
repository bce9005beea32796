// Two-pass negacyclic NTT stages in shared memory, over one word type W
// (i64 at R = 2^62, i32 in the 30-bit mode; mont.cuh).
//
// A logN15 row of i64 is 32768 x 8 B = 256 KB, more than the 227 KB of
// shared memory one block may use, so a transform never holds a whole row.
// Split N = N1 * N2 (N1 = 2^L1, L1 = logN/2, N2 = N / N1) and view the row
// as [N1, N2]:
//
//   * forward stages logm < L1 pair x with x + t, t >= N2: they never mix
//     columns, so a "strided" block owns TC columns of all N1 rows;
//   * forward stages logm >= L1 have t < N2: a "contiguous" block owns
//     one chunk of N2 consecutive coefficients.
//
// The inverse runs the same split in the opposite order.  Each stage is the
// radix-2 butterfly of ops/ntt.py with the same twiddle psi[m + i], the
// same operand order and the same lazy reductions, so the output equals the
// plain torch transform bit for bit, in the same bit-reversed order.  Both
// word types use the same geometry: an i32 tile takes half the bytes.
//
// Per block one row (one batch entry x one RNS channel): q, k and the
// twiddle row are the channel's.  Twiddles are read from global memory
// (the [C, N] tables stay in L2); data lives in shared memory between
// stages.
#pragma once

#include "mont.cuh"

#define TT_TC 16          // columns per strided block (128 B of i64 per j1 row)
#define TT_THREADS 256

struct Geo {
    int logN, L1, L2, N1, N2, TC;
};

static inline Geo make_geo(int logN) {
    Geo g;
    g.logN = logN;
    g.L1 = logN / 2;
    g.L2 = logN - g.L1;
    g.N1 = 1 << g.L1;
    g.N2 = 1 << g.L2;
    g.TC = g.N2 < TT_TC ? g.N2 : TT_TC;
    return g;
}

// The block's dynamic shared memory as words of type W.
template <typename W>
__device__ __forceinline__ W* smem() {
    extern __shared__ __align__(16) unsigned char tt_smem[];
    return reinterpret_cast<W*>(tt_smem);
}

// Forward stages [0, L1) on a strided tile s[j1 * TC + col].
template <typename W, typename U>
__device__ __forceinline__ void fwd_strided(W* s, const Geo& g, const W* psi,
                                            U q, U k) {
    const W q2 = (W)(q << 1);
    const int nb = (g.N1 >> 1) * g.TC;
    for (int logm = 0; logm < g.L1; ++logm) {
        const int sh = g.L1 - 1 - logm;
        for (int w = threadIdx.x; w < nb; w += blockDim.x) {
            const int col = w % g.TC;
            const int b = w / g.TC;
            const int grp = b >> sh;
            const int ju = (grp << (sh + 1)) + (b & ((1 << sh) - 1));
            const int jv = ju + (1 << sh);
            const W S = psi[(1 << logm) + grp];
            const W U0 = s[ju * g.TC + col];
            const W V = redc(S, s[jv * g.TC + col], q, k);
            s[ju * g.TC + col] = lazy_add(U0, V, q2);
            s[jv * g.TC + col] = lazy_sub(U0, V, q2);
        }
        __syncthreads();
    }
}

// Forward stages [L1, logN) on the contiguous chunk j1: s[0, N2).
template <typename W, typename U>
__device__ __forceinline__ void fwd_contig(W* s, const Geo& g, int j1,
                                           const W* psi, U q, U k) {
    const W q2 = (W)(q << 1);
    const int nb = g.N2 >> 1;
    for (int logm = g.L1; logm < g.logN; ++logm) {
        const int sh = g.logN - 1 - logm;
        const W* tw = psi + (1 << logm) + (j1 << (logm - g.L1));
        for (int b = threadIdx.x; b < nb; b += blockDim.x) {
            const int grp = b >> sh;
            const int u = (grp << (sh + 1)) + (b & ((1 << sh) - 1));
            const int v = u + (1 << sh);
            const W U0 = s[u];
            const W V = redc(tw[grp], s[v], q, k);
            s[u] = lazy_add(U0, V, q2);
            s[v] = lazy_sub(U0, V, q2);
        }
        __syncthreads();
    }
}

// Inverse stages logm = logN .. L1+1 on the contiguous chunk j1.
template <typename W, typename U>
__device__ __forceinline__ void inv_contig(W* s, const Geo& g, int j1,
                                           const W* ipsi, U q, U k) {
    const W q2 = (W)(q << 1);
    const int nb = g.N2 >> 1;
    for (int logm = g.logN; logm > g.L1; --logm) {
        const int sh = g.logN - logm;
        const W* tw = ipsi + (1 << (logm - 1)) + (j1 << (logm - 1 - g.L1));
        for (int b = threadIdx.x; b < nb; b += blockDim.x) {
            const int grp = b >> sh;
            const int u = (grp << (sh + 1)) + (b & ((1 << sh) - 1));
            const int v = u + (1 << sh);
            const W U0 = s[u];
            const W V = s[v];
            s[u] = lazy_add(U0, V, q2);
            s[v] = redc(tw[grp], lazy_sub(U0, V, q2), q, k);
        }
        __syncthreads();
    }
}

// Inverse stages logm = L1 .. 1 on a strided tile s[j1 * TC + col].
template <typename W, typename U>
__device__ __forceinline__ void inv_strided(W* s, const Geo& g, const W* ipsi,
                                            U q, U k) {
    const W q2 = (W)(q << 1);
    const int nb = (g.N1 >> 1) * g.TC;
    for (int logm = g.L1; logm >= 1; --logm) {
        const int sh = g.L1 - logm;
        for (int w = threadIdx.x; w < nb; w += blockDim.x) {
            const int col = w % g.TC;
            const int b = w / g.TC;
            const int grp = b >> sh;
            const int ju = (grp << (sh + 1)) + (b & ((1 << sh) - 1));
            const int jv = ju + (1 << sh);
            const W S = ipsi[(1 << (logm - 1)) + grp];
            const W U0 = s[ju * g.TC + col];
            const W V = s[jv * g.TC + col];
            s[ju * g.TC + col] = lazy_add(U0, V, q2);
            s[jv * g.TC + col] = redc(S, lazy_sub(U0, V, q2), q, k);
        }
        __syncthreads();
    }
}

// Global coefficient index of strided-tile element e (column tile ct).
__device__ __forceinline__ int strided_x(const Geo& g, int ct, int e) {
    return (e / g.TC) * g.N2 + ct * g.TC + (e % g.TC);
}

static inline int contig_threads(const Geo& g) {
    int t = g.N2 >> 1;
    return t < TT_THREADS ? t : TT_THREADS;
}

// ---------------------------------------------------------------------
// Forward pass 1: optional x R entry, stages [0, L1) on strided tiles.
// Grid (N2 / TC, rows); row = batch * C + channel.  Blocks of channels in
// [skip_lo, skip_hi) return at once (the keyswitch in-part shortcut; an
// empty range skips nothing).  Shared by ntt.cu and tensor.cu.
// ---------------------------------------------------------------------
template <typename W, bool ENTER>
__global__ void fwd_pass1(const W* __restrict__ x, W* out, Geo g, int C,
                          int skip_lo, int skip_hi,
                          const W* __restrict__ qv,
                          const W* __restrict__ kv,
                          const W* __restrict__ psi,
                          const W* __restrict__ Rs) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    const int row = blockIdx.y;
    const int c = row % C;
    if (c >= skip_lo && c < skip_hi) return;
    const int ct = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const size_t base = (size_t)row << g.logN;
    const int n = g.N1 * g.TC;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        W v = x[base + strided_x(g, ct, e)];
        if (ENTER) v = redc(v, Rs[c], q, k);
        s[e] = v;
    }
    __syncthreads();
    fwd_strided(s, g, psi + ((size_t)c << g.logN), q, k);
    for (int e = threadIdx.x; e < n; e += blockDim.x)
        out[base + strided_x(g, ct, e)] = s[e];
}

#define TT_CHECK()                                   \
    do {                                             \
        cudaError_t err_ = cudaGetLastError();       \
        if (err_ != cudaSuccess) return (int)err_;   \
    } while (0)

