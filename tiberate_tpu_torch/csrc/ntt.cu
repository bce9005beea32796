// Forward and inverse negacyclic NTT with prologues and epilogues.
//
// Replaces the Pallas kernel _make_kernel run by _run_group
// (tiberate_tpu/ops/pallas_mxu.py:445, :1395) behind the entry points
//   ntt        (K1, pallas_mxu.py:1708)  enter (x R) or plain,
//   intt       (K2, pallas_mxu.py:1713)  x N^-1 with "mont" / "exit" /
//                                         "exit_reduce" epilogues,
//   ntt_keymul (K3, pallas_mxu.py:1791)  forward NTT, then t_i = X k_i R^-1
//                                         for one or two keys,
//   ntt_keymul_accum (K3 with accum= and a skip_range table view, the
//              per-part keyswitch chain: the acc epilogue at
//              pallas_mxu.py:603-627, the gap fill at :1659-1702)
//                                         acc_i (+)= X k_i R^-1 in place,
//                                         the part's own channels passed
//                                         through untransformed,
//   intt_pdiv  (K4, pallas_mxu.py:1835)  "mont" inverse NTT, then the
//                                         P-division x c_x - sum p0_i c_i,
//                                         canonical [0, q).
// Every entry point has two lanes: NAME for i64 words (R = 2^62) and
// NAME_30 for i32 words (R = 2^30), the single-lane u32 variant of the
// same TPU kernel (tables.lane == "single": pallas_mxu.py:1420,
// :1542-1543; its arithmetic _redc30 / _shoup_mult32 / _sub2q32 at
// :167-258).  The TPU kernel is a 4-step int8-limb matmul with Shoup folds
// because Mosaic has no 64-bit vectors (and, in the single lane, builds
// its 32x32 high product from 16-bit pieces).  Here each transform is the
// radix-2 butterfly NTT of ops/ntt.py in two launches (a strided and a
// contiguous pass, ntt.cuh), one word per residue, with the prologue fused
// into the first pass's load and the epilogue into the second pass's
// store.  Outputs are byte-identical to the plain versions.
//
// What bounds it on the H100: not the bytes (each coefficient is read and
// written twice) but the butterflies: a 62-bit REDC is one unsigned
// 64x64->128 product and a low and a high 64-bit product (mont.cuh; 18
// IMAD-class of 33 SASS instructions in the fold probe's chain with its
// loop, csrc/fold_probe.cu, where the REDC with signed 128-bit halves took
// 41), a 30-bit one two 32x32->64 products (6 of 14), and a logN15 row
// needs 15 x 16384 of them.  A core that ran one shared-memory stage at a time reached a
// third of that REDC bound in the 62-bit lane and a quarter in the 30-bit
// lane (ops/roofline.py, PERF.md): most of its time went around the
// REDCs.  The register-tiled core (ntt.cuh, which also holds the strided
// forward pass fwd_strided_k) answers each cause:
//
//   1. a shared-memory round trip and a barrier per stage: each thread
//      runs three stages (R = 8 registers; four at logN16/17 in the strided
//      30-bit pass, R = 16) on registers alone, so a logN15 transform
//      crosses shared memory 2 + 2 times, not 15, and a contiguous chunk
//      that fits one warp (logN <= 16) syncs with __syncwarp only;
//   2. index arithmetic on runtime values: every kernel is instantiated
//      per logN (4..17), so L1, L2, TC and the round windows are
//      compile-time constants; no division or modulo by a runtime value is
//      left in a butterfly, and the rounds unroll completely;
//   3. one twiddle per butterfly from global memory: a block stages its
//      table once (N1 words for a strided block, N2 per contiguous chunk)
//      in shared memory before its first stage;
//   4. small, half-empty blocks: a strided tile is 128 B a row in both
//      lanes (16 i64 or 32 i32 columns) and takes up to 512 threads, a
//      contiguous block gathers chunks up to 256 threads, and the
//      contiguous pass moves 16-byte vectors wherever a thread holds
//      consecutive words (the inverse's first load, the forward's key
//      products, accumulators and stores).
//
// Measured on the H100 (cuobjdump of the sm_90a build, chip_smoke.py phase
// 2c): the inverse contiguous pass at logN15, whose threads each run 32
// butterflies and nothing else but loads, the twiddle table, two exchanges
// and stores, is 1808 SASS instructions (767 IMAD-class) in the 62-bit
// lane, 56.5 a butterfly against the 33 of a bare REDC (2186, 909 and 68.3
// with the REDC of signed 128-bit halves), and 723 (253) in the 30-bit
// lane, 22.6 a butterfly against 14; the forward strided pass is 71.4 a
// butterfly at logN15 (85.7 before), its x R entry included.  The instructions beyond
// the REDC (the lazy add and sub on two words, the twiddle's shared-memory
// load, the exchanges) are what keeps the transforms at 46-64% of the
// REDC bound in the 62-bit lane and 37-56% in the 30-bit lane (PERF.md).
// R = 16 registers, which saves a round at L = 7 and 8, measured slower at
// logN15 (register pressure), so R stays 8 but where a block would exceed
// 512 threads.  The accumulating variant reads and writes its two
// accumulators once each in the contiguous pass: the TPU kernel's donated
// accumulator becomes an in-place update.
#include "ntt.cuh"

enum { EPI_MONT = 0, EPI_EXIT = 1, EPI_EXIT_REDUCE = 2, EPI_PDIV = 3 };

// ---------------------------------------------------------------------
// Forward, contiguous pass: stages [L1, logN) on CH chunks of buf, then
// the epilogue for nkeys keys ([C, N] each): nkeys == 0 stores the
// transform in out0; otherwise out_i = REDC(X k_i), and with acc the lazy
// [0, 2q) running part-sum out_i = out_i (+) REDC(X k_i) of the keyswitch
// chain, so the fresh key products never reach device memory.  buf may be
// out0 (in place).  Channels in [skip_lo, skip_hi) are not touched.  Grid
// (N1 / CH, rows).
// ---------------------------------------------------------------------
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T2)
fwd_contig_k(const W* buf, W* out0, W* out1, int C, int skip_lo,
             int skip_hi, const W* __restrict__ qv, const W* __restrict__ kv,
             const W* __restrict__ psi, const W* __restrict__ key0,
             const W* __restrict__ key1, int nkeys, int acc) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S2 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;
    const int c = row % C;
    if (c >= skip_lo && c < skip_hi) return;
    const int cl = threadIdx.x / P::TPC;
    const int t = threadIdx.x & (P::TPC - 1);
    const int j1 = blockIdx.x * P::CH + cl;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const size_t off = ((size_t)row << LOGN) + ((size_t)j1 << P::L2);
    constexpr int LO0 = SC::lo(true, 0);
    W v[SC::R];
#pragma unroll
    for (int i = 0; i < SC::R; ++i) v[i] = buf[off + slot(t, i, LO0, P::RL2)];
    W* T = smem<W>() + cl * P::CHUNK;
    chunk_twiddles<W, P::L1, P::L2, P::TPC>(T, psi + ((size_t)c << LOGN), j1,
                                            t);
    tile_sync<P::WARP2>();
    run_rounds<W, U, P::L2, P::RL2, true, P::WARP2, 0>(
        v, t, T, T + P::N2, P::P2, PadLayout{}, q, k, q2);
    // the last window is bits [0, RL2): thread t holds words tR .. tR+R-1
    const size_t o = off + (size_t)t * SC::R;
    if (nkeys == 0) {
        st_vec(out0 + o, v);
        return;
    }
    const size_t ko =
        ((size_t)c << LOGN) + ((size_t)j1 << P::L2) + (size_t)t * SC::R;
    W key[SC::R], a[SC::R];
    for (int n = 0; n < nkeys; ++n) {
        W* out = n == 0 ? out0 : out1;
        ld_vec(key, (n == 0 ? key0 : key1) + ko);
        if (acc) ld_vec(a, out + o);
#pragma unroll
        for (int i = 0; i < SC::R; ++i) {
            const W p = redc(v[i], key[i], q, k);
            a[i] = acc ? tile_add(a[i], p, q2) : p;
        }
        st_vec(out + o, a);
    }
}

// ---------------------------------------------------------------------
// Inverse, contiguous pass: stages logN .. L1+1 on CH chunks.  Output row
// b * C + c reads input row b * C_in + c (C_in >= C: intt_pdiv reads only
// the ordinary rows of a with-special accumulator).
// ---------------------------------------------------------------------
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T2)
inv_contig_k(const W* __restrict__ x, W* __restrict__ out, int C, int C_in,
             const W* __restrict__ qv, const W* __restrict__ kv,
             const W* __restrict__ ipsi) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S2 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;
    const int c = row % C;
    const int b = row / C;
    const int cl = threadIdx.x / P::TPC;
    const int t = threadIdx.x & (P::TPC - 1);
    const int j1 = blockIdx.x * P::CH + cl;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const size_t chunk = (size_t)j1 << P::L2;
    constexpr int LOL = SC::lo(false, SC::ROUNDS - 1);
    // the first window is bits [0, RL2): thread t holds words tR .. tR+R-1
    W v[SC::R];
    ld_vec(v, x + (((size_t)b * C_in + c) << LOGN) + chunk + (size_t)t * SC::R);
    W* T = smem<W>() + cl * P::CHUNK;
    chunk_twiddles<W, P::L1, P::L2, P::TPC>(T, ipsi + ((size_t)c << LOGN),
                                            j1, t);
    tile_sync<P::WARP2>();
    run_rounds<W, U, P::L2, P::RL2, false, P::WARP2, 0>(
        v, t, T, T + P::N2, P::P2, PadLayout{}, q, k, q2);
    W* dst = out + ((size_t)row << LOGN) + chunk;
#pragma unroll
    for (int i = 0; i < SC::R; ++i) dst[slot(t, i, LOL, P::RL2)] = v[i];
}

// ---------------------------------------------------------------------
// Inverse, strided pass: stages L1 .. 1 of TC columns, x N^-1 R (the
// "mont" variant), then the epilogue epi, in place on buf [B * C, N].
//   EPI_PDIV: out = X c_x - sum_i p0_i c_i (mod q), canonical, with
//   pdc[c] = [c_x, c_0 R, ..., c_{S-1} R] and p0 [B, S, N] plain rows.
//   Every term is brought to [0, q) before it is subtracted, so the
//   running value stays in (-q, q): no word overflows in either lane.
// ---------------------------------------------------------------------
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T1)
inv_strided_k(W* buf, int C, const W* __restrict__ qv,
              const W* __restrict__ kv, const W* __restrict__ ipsi,
              const W* __restrict__ Ninv, int epi, const W* __restrict__ p0,
              const W* __restrict__ pdc, int S) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S1 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;
    const int c = row % C;
    const int b = row / C;
    const int col = threadIdx.x & (P::TC - 1);
    const int t = threadIdx.x >> P::LTC;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const W qw = (W)q;
    const int x0 = blockIdx.x * P::TC + col;  // the column within the row
    W* base = buf + ((size_t)row << LOGN) + x0;
    constexpr int LOL = SC::lo(false, SC::ROUNDS - 1);
    W v[SC::R];
#pragma unroll
    for (int i = 0; i < SC::R; ++i)
        v[i] = base[(size_t)slot(t, i, 0, P::RL1) << P::L2];
    W* T = smem<W>();
    const W* tw = ipsi + ((size_t)c << LOGN);
    for (int j = threadIdx.x; j < P::N1; j += P::T1) T[j] = tw[j];
    __syncthreads();
    run_rounds<W, U, P::L1, P::RL1, false, false, 0>(
        v, t, T, T + P::N1, P::N1 * P::TC, ColLayout<P::TC>{col}, q, k, q2);
    // N^-1 R mod q (R on a coef shard), 1 and pdc: constants below 2^63
    const W ninv = Ninv[c];
#pragma unroll
    for (int i = 0; i < SC::R; ++i) {
        const size_t xo = (size_t)slot(t, i, LOL, P::RL1) << P::L2;
        W w = redc_by(v[i], ninv, q, k);
        if (epi == EPI_EXIT || epi == EPI_EXIT_REDUCE)
            w = redc_by(w, (W)1, q, k);
        if (epi == EPI_EXIT_REDUCE) w = w < qw ? w : w - qw;
        if (epi == EPI_PDIV) {
            const W* cc = pdc + (size_t)c * (1 + S);
            w = canon(redc_by(w, cc[0], q, k), qw);
            for (int s = 0; s < S; ++s) {
                const W p = p0[(((size_t)b * S + s) << LOGN) + x0 + xo];
                w -= canon(redc_by(p, cc[1 + s], q, k), qw);
                w = w < 0 ? w + qw : w;
            }
        }
        base[xo] = w;
    }
}

// ---------------------------------------------------------------------
// Launchers, one instantiation per word type and logN.  Each returns
// cudaGetLastError() after its launches.
// ---------------------------------------------------------------------
// The forward transform of x into out0 through mid (the strided pass's
// output; mid may be out0), with the contiguous pass's epilogue.
template <typename W, int LOGN>
static int fwd_n(const W* x, W* mid, W* out0, W* out1, int rows, int C,
                 int skip_lo, int skip_hi, const W* q, const W* k,
                 const W* psi, const W* Rs, const W* key0, const W* key1,
                 int nkeys, int acc, cudaStream_t st) {
    typedef Plan<W, LOGN> P;
    static const bool ready = allow_smem(fwd_strided_k<W, LOGN>, P::SMEM1) &&
                              allow_smem(fwd_contig_k<W, LOGN>, P::SMEM2);
    if (!ready) return (int)cudaErrorInvalidValue;
    fwd_strided_k<W, LOGN><<<dim3(P::N2 / P::TC, rows), P::T1, P::SMEM1,
                             st>>>(x, mid, C, skip_lo, skip_hi, q, k, psi,
                                   Rs);
    TT_CHECK();
    fwd_contig_k<W, LOGN><<<dim3(P::N1 / P::CH, rows), P::T2, P::SMEM2,
                            st>>>(mid, out0, out1, C, skip_lo, skip_hi, q, k,
                                  psi, key0, key1, nkeys, acc);
    TT_CHECK();
    return 0;
}

template <typename W, int LOGN>
static int inv_n(const W* x, W* out, int rows, int C, int C_in, const W* q,
                 const W* k, const W* ipsi, const W* Ninv, int epi,
                 const W* p0, const W* pdc, int S, cudaStream_t st) {
    typedef Plan<W, LOGN> P;
    static const bool ready = allow_smem(inv_contig_k<W, LOGN>, P::SMEM2) &&
                              allow_smem(inv_strided_k<W, LOGN>, P::SMEM1);
    if (!ready) return (int)cudaErrorInvalidValue;
    inv_contig_k<W, LOGN><<<dim3(P::N1 / P::CH, rows), P::T2, P::SMEM2,
                            st>>>(x, out, C, C_in, q, k, ipsi);
    TT_CHECK();
    inv_strided_k<W, LOGN><<<dim3(P::N2 / P::TC, rows), P::T1, P::SMEM1,
                             st>>>(out, C, q, k, ipsi, Ninv, epi, p0, pdc, S);
    TT_CHECK();
    return 0;
}

// K1 (nkeys = 0) and K3 (nkeys = 1 or 2).  out0 may alias nothing of x;
// out1 is written only for nkeys == 2.  Rs == NULL: no x R entry.
template <typename W>
static int ntt_fwd(const W* x, W* out0, W* out1, int rows, int C, int logN,
                   const W* q, const W* k, const W* psi, const W* Rs,
                   const W* key0, const W* key1, int nkeys, void* stream) {
    TT_BY_LOGN(fwd_n, x, out0, out0, out1, rows, C, 0, 0, q, k, psi, Rs,
               key0, key1, nkeys, 0, (cudaStream_t)stream)
}

// K3 with accumulators (the per-part keyswitch chain): on every channel
// outside [skip_lo, skip_hi), acc_i = acc_i (+) REDC(NTT(x) key_i), in
// place; the other channels' rows of acc0/acc1 are left as they were and
// are not transformed.  x, tmp, acc0, acc1: [rows, N] with rows = B * C;
// key0, key1: [C, N].  tmp is scratch for the strided pass.
template <typename W>
static int ntt_keymul_accum(const W* x, W* tmp, W* acc0, W* acc1, int rows,
                            int C, int logN, const W* q, const W* k,
                            const W* psi, const W* key0, const W* key1,
                            int skip_lo, int skip_hi, void* stream) {
    TT_BY_LOGN(fwd_n, x, tmp, acc0, acc1, rows, C, skip_lo, skip_hi, q, k,
               psi, (const W*)nullptr, key0, key1, 2, 1,
               (cudaStream_t)stream)
}

// K2 (epi 0..2) and K4 (epi 3).  x: [B, C_in, N]; out: [B, C, N].
template <typename W>
static int ntt_inv(const W* x, W* out, int rows, int C, int C_in, int logN,
                   const W* q, const W* k, const W* ipsi, const W* Ninv,
                   int epi, const W* p0, const W* pdc, int S, void* stream) {
    TT_BY_LOGN(inv_n, x, out, rows, C, C_in, q, k, ipsi, Ninv, epi, p0, pdc,
               S, (cudaStream_t)stream)
}

// ---------------------------------------------------------------------
// Host entry points (plain C interface, loaded with ctypes): the 62-bit
// lane, then the 30-bit lane (_30) with the same arguments over i32.  The
// build compiles this file once per lane (TT_LANE=62, 30) and direction
// (TT_FWD=1 forward, 0 inverse), the four in parallel: each instantiates
// its kernels for every logN.
// ---------------------------------------------------------------------
#ifndef TT_FWD
#define TT_FWD -1  // both directions
#endif

#if TT_I64 && TT_FWD != 0
extern "C" int tt_ntt_fwd(const i64* x, i64* out0, i64* out1, int rows,
                          int C, int logN, const i64* q, const i64* k,
                          const i64* psi, const i64* Rs, const i64* key0,
                          const i64* key1, int nkeys, void* stream) {
    return ntt_fwd(x, out0, out1, rows, C, logN, q, k, psi, Rs, key0, key1,
                   nkeys, stream);
}

extern "C" int tt_ntt_keymul_accum(const i64* x, i64* tmp, i64* acc0,
                                   i64* acc1, int rows, int C, int logN,
                                   const i64* q, const i64* k,
                                   const i64* psi, const i64* key0,
                                   const i64* key1, int skip_lo, int skip_hi,
                                   void* stream) {
    return ntt_keymul_accum(x, tmp, acc0, acc1, rows, C, logN, q, k, psi,
                            key0, key1, skip_lo, skip_hi, stream);
}
#endif

#if TT_I64 && TT_FWD != 1
extern "C" int tt_ntt_inv(const i64* x, i64* out, int rows, int C,
                          int C_in, int logN, const i64* q, const i64* k,
                          const i64* ipsi, const i64* Ninv, int epi,
                          const i64* p0, const i64* pdc, int S,
                          void* stream) {
    return ntt_inv(x, out, rows, C, C_in, logN, q, k, ipsi, Ninv, epi, p0,
                   pdc, S, stream);
}
#endif

#if TT_I32 && TT_FWD != 0
extern "C" int tt_ntt_fwd_30(const i32* x, i32* out0, i32* out1, int rows,
                             int C, int logN, const i32* q, const i32* k,
                             const i32* psi, const i32* Rs, const i32* key0,
                             const i32* key1, int nkeys, void* stream) {
    return ntt_fwd(x, out0, out1, rows, C, logN, q, k, psi, Rs, key0, key1,
                   nkeys, stream);
}

extern "C" int tt_ntt_keymul_accum_30(const i32* x, i32* tmp, i32* acc0,
                                      i32* acc1, int rows, int C, int logN,
                                      const i32* q, const i32* k,
                                      const i32* psi, const i32* key0,
                                      const i32* key1, int skip_lo,
                                      int skip_hi, void* stream) {
    return ntt_keymul_accum(x, tmp, acc0, acc1, rows, C, logN, q, k, psi,
                            key0, key1, skip_lo, skip_hi, stream);
}
#endif

#if TT_I32 && TT_FWD != 1
extern "C" int tt_ntt_inv_30(const i32* x, i32* out, int rows, int C,
                             int C_in, int logN, const i32* q, const i32* k,
                             const i32* ipsi, const i32* Ninv, int epi,
                             const i32* p0, const i32* pdc, int S,
                             void* stream) {
    return ntt_inv(x, out, rows, C, C_in, logN, q, k, ipsi, Ninv, epi, p0,
                   pdc, S, stream);
}
#endif
