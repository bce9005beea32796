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
// radix-2 butterfly NTT of ops/ntt.py in two passes (ntt.cuh), one word per
// residue, with the prologue fused into the first pass's load and the
// epilogue into the second pass's store.
//
// What bounds it on the H100: not the bytes.  A transform reads and
// writes each coefficient twice (8 B a word in the 62-bit lane, 4 B in the
// 30-bit lane), and the measured kernels reach 7-26% of that HBM bound.
// The butterflies bound it: a 62-bit REDC is one 64x64->128 multiply pair
// plus a 62-bit multiply (18 IMAD-class of 41 SASS instructions in the
// fold probe's chain, csrc/fold_probe.cu), a 30-bit one two 32x32->64
// products (6 of 14), and a logN15 row needs 15 x 16384 of them, with
// shared-memory traffic and a barrier per stage.  At the REDC rate the
// fold probe measures on the card, the kernels reach about a third of
// their REDC bound in the 62-bit lane and a quarter in the 30-bit lane
// (ops/roofline.py, PERF.md).  The design keeps every stage in shared
// memory (two device-memory round trips per transform, not logN) and
// fuses the epilogues so no transform is re-read; a wgmma int8 4-step is
// the later lever for the multiply bound.  The accumulating variant reads
// and writes its two accumulators once each in pass 2, the same traffic as
// K3's two outputs plus two reads: the TPU kernel's donated accumulator
// becomes an in-place update.
#include <cuda_runtime.h>

#include "ntt.cuh"

// ---------------------------------------------------------------------
// Forward pass 2: stages [L1, logN) on contiguous chunks of buf, then the
// epilogue for NKEYS keys ([C, N] each): NKEYS == 0 stores the transform
// in out0; otherwise out_i = REDC(X k_i), and with ACC the lazy [0, 2q)
// running part-sum out_i = out_i (+) REDC(X k_i) of the keyswitch chain,
// so the fresh key products never reach device memory.  buf may be out0
// (in place).  Channels in [skip_lo, skip_hi) are not touched.
// ---------------------------------------------------------------------
template <typename W, int NKEYS, bool ACC>
__global__ void fwd_pass2(const W* buf, W* out0, W* out1, Geo g, int C,
                          int skip_lo, int skip_hi,
                          const W* __restrict__ qv,
                          const W* __restrict__ kv,
                          const W* __restrict__ psi,
                          const W* __restrict__ key0,
                          const W* __restrict__ key1) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    const int row = blockIdx.y;
    const int c = row % C;
    if (c >= skip_lo && c < skip_hi) return;
    const int j1 = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const size_t off = ((size_t)row << g.logN) + ((size_t)j1 << g.L2);
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) s[e] = buf[off + e];
    __syncthreads();
    fwd_contig(s, g, j1, psi + ((size_t)c << g.logN), q, k);
    const size_t koff = ((size_t)c << g.logN) + ((size_t)j1 << g.L2);
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) {
        const W v = s[e];
        if (NKEYS == 0) {
            out0[off + e] = v;
            continue;
        }
        W t0 = redc(v, key0[koff + e], q, k);
        if (ACC) t0 = lazy_add(out0[off + e], t0, q2);
        out0[off + e] = t0;
        if (NKEYS == 2) {
            W t1 = redc(v, key1[koff + e], q, k);
            if (ACC) t1 = lazy_add(out1[off + e], t1, q2);
            out1[off + e] = t1;
        }
    }
}

// ---------------------------------------------------------------------
// Inverse pass A: stages logN .. L1+1 on contiguous chunks.  Output row
// b * C + c reads input row b * C_in + c (C_in >= C: intt_pdiv reads only
// the ordinary rows of a with-special accumulator).
// ---------------------------------------------------------------------
template <typename W>
__global__ void inv_passA(const W* __restrict__ x, W* __restrict__ out,
                          Geo g, int C, int C_in,
                          const W* __restrict__ qv,
                          const W* __restrict__ kv,
                          const W* __restrict__ ipsi) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    const int row = blockIdx.y;
    const int c = row % C;
    const int b = row / C;
    const int j1 = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const size_t chunk = (size_t)j1 << g.L2;
    const W* src = x + (((size_t)b * C_in + c) << g.logN) + chunk;
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) s[e] = src[e];
    __syncthreads();
    inv_contig(s, g, j1, ipsi + ((size_t)c << g.logN), q, k);
    W* dst = out + ((size_t)row << g.logN) + chunk;
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) dst[e] = s[e];
}

enum { EPI_MONT = 0, EPI_EXIT = 1, EPI_EXIT_REDUCE = 2, EPI_PDIV = 3 };

// ---------------------------------------------------------------------
// Inverse pass B: stages L1 .. 1 on strided tiles, x N^-1 R (the "mont"
// variant), then the epilogue, in place on buf [B * C, N].
//   EPI_PDIV: out = X c_x - sum_i p0_i c_i (mod q), canonical, with
//   pdc[c] = [c_x, c_0 R, ..., c_{S-1} R] and p0 [B, S, N] plain rows.
//   Every term is brought to [0, q) before it is subtracted, so the
//   running value stays in (-q, q): no word overflows in either lane.
// ---------------------------------------------------------------------
template <typename W, int EPI>
__global__ void inv_passB(W* buf, Geo g, int C,
                          const W* __restrict__ qv,
                          const W* __restrict__ kv,
                          const W* __restrict__ ipsi,
                          const W* __restrict__ Ninv,
                          const W* __restrict__ p0,
                          const W* __restrict__ pdc, int S) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    const int row = blockIdx.y;
    const int c = row % C;
    const int b = row / C;
    const int ct = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const W qw = (W)q;
    const size_t base = (size_t)row << g.logN;
    const int n = g.N1 * g.TC;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
        s[e] = buf[base + strided_x(g, ct, e)];
    __syncthreads();
    inv_strided(s, g, ipsi + ((size_t)c << g.logN), q, k);
    const W ninv = Ninv[c];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int xi = strided_x(g, ct, e);
        W v = redc(s[e], ninv, q, k);
        if (EPI == EPI_EXIT || EPI == EPI_EXIT_REDUCE) v = redc(v, (W)1, q, k);
        if (EPI == EPI_EXIT_REDUCE) v = v < qw ? v : v - qw;
        if (EPI == EPI_PDIV) {
            const W* cc = pdc + (size_t)c * (1 + S);
            v = canon(redc(v, cc[0], q, k), qw);
            for (int i = 0; i < S; ++i) {
                const W p = p0[(((size_t)b * S + i) << g.logN) + xi];
                v -= canon(redc(p, cc[1 + i], q, k), qw);
                v = v < 0 ? v + qw : v;
            }
        }
        buf[base + xi] = v;
    }
}

// ---------------------------------------------------------------------
// Launchers, one instantiation per word type.  Each returns
// cudaGetLastError() after its launches.
// ---------------------------------------------------------------------
// K1 (nkeys = 0) and K3 (nkeys = 1 or 2).  out0 may alias nothing of x;
// out1 is written only for nkeys == 2.  Rs == NULL: no x R entry.
template <typename W>
static int ntt_fwd(const W* x, W* out0, W* out1, int rows, int C, int logN,
                   const W* q, const W* k, const W* psi, const W* Rs,
                   const W* key0, const W* key1, int nkeys, void* stream) {
    const Geo g = make_geo(logN);
    cudaStream_t st = (cudaStream_t)stream;
    const size_t sm1 = (size_t)g.N1 * g.TC * sizeof(W);
    const size_t sm2 = (size_t)g.N2 * sizeof(W);
    dim3 g1(g.N2 / g.TC, rows), g2(g.N1, rows);
    if (Rs)
        fwd_pass1<W, true><<<g1, TT_THREADS, sm1, st>>>(x, out0, g, C, 0, 0,
                                                        q, k, psi, Rs);
    else
        fwd_pass1<W, false><<<g1, TT_THREADS, sm1, st>>>(x, out0, g, C, 0, 0,
                                                         q, k, psi, Rs);
    TT_CHECK();
    const int t2 = contig_threads(g);
    if (nkeys == 0)
        fwd_pass2<W, 0, false><<<g2, t2, sm2, st>>>(
            out0, out0, out1, g, C, 0, 0, q, k, psi, key0, key1);
    else if (nkeys == 1)
        fwd_pass2<W, 1, false><<<g2, t2, sm2, st>>>(
            out0, out0, out1, g, C, 0, 0, q, k, psi, key0, key1);
    else
        fwd_pass2<W, 2, false><<<g2, t2, sm2, st>>>(
            out0, out0, out1, g, C, 0, 0, q, k, psi, key0, key1);
    TT_CHECK();
    return 0;
}

// K3 with accumulators (the per-part keyswitch chain): on every channel
// outside [skip_lo, skip_hi), acc_i = acc_i (+) REDC(NTT(x) key_i), in
// place; the other channels' rows of acc0/acc1 are left as they were and
// are not transformed.  x, tmp, acc0, acc1: [rows, N] with rows = B * C;
// key0, key1: [C, N].  tmp is scratch for the first pass.
template <typename W>
static int ntt_keymul_accum(const W* x, W* tmp, W* acc0, W* acc1, int rows,
                            int C, int logN, const W* q, const W* k,
                            const W* psi, const W* key0, const W* key1,
                            int skip_lo, int skip_hi, void* stream) {
    const Geo g = make_geo(logN);
    cudaStream_t st = (cudaStream_t)stream;
    const size_t sm1 = (size_t)g.N1 * g.TC * sizeof(W);
    const size_t sm2 = (size_t)g.N2 * sizeof(W);
    dim3 g1(g.N2 / g.TC, rows), g2(g.N1, rows);
    fwd_pass1<W, false><<<g1, TT_THREADS, sm1, st>>>(
        x, tmp, g, C, skip_lo, skip_hi, q, k, psi, nullptr);
    TT_CHECK();
    fwd_pass2<W, 2, true><<<g2, contig_threads(g), sm2, st>>>(
        tmp, acc0, acc1, g, C, skip_lo, skip_hi, q, k, psi, key0, key1);
    TT_CHECK();
    return 0;
}

// K2 (epi 0..2) and K4 (epi 3).  x: [B, C_in, N]; out: [B, C, N].
template <typename W>
static int ntt_inv(const W* x, W* out, int rows, int C, int C_in, int logN,
                   const W* q, const W* k, const W* ipsi, const W* Ninv,
                   int epi, const W* p0, const W* pdc, int S, void* stream) {
    const Geo g = make_geo(logN);
    cudaStream_t st = (cudaStream_t)stream;
    const size_t sm1 = (size_t)g.N1 * g.TC * sizeof(W);
    const size_t sm2 = (size_t)g.N2 * sizeof(W);
    dim3 g1(g.N2 / g.TC, rows), g2(g.N1, rows);
    inv_passA<W><<<g2, contig_threads(g), sm2, st>>>(x, out, g, C, C_in, q,
                                                     k, ipsi);
    TT_CHECK();
    switch (epi) {
        case EPI_MONT:
            inv_passB<W, EPI_MONT><<<g1, TT_THREADS, sm1, st>>>(
                out, g, C, q, k, ipsi, Ninv, p0, pdc, S);
            break;
        case EPI_EXIT:
            inv_passB<W, EPI_EXIT><<<g1, TT_THREADS, sm1, st>>>(
                out, g, C, q, k, ipsi, Ninv, p0, pdc, S);
            break;
        case EPI_EXIT_REDUCE:
            inv_passB<W, EPI_EXIT_REDUCE><<<g1, TT_THREADS, sm1, st>>>(
                out, g, C, q, k, ipsi, Ninv, p0, pdc, S);
            break;
        default:
            inv_passB<W, EPI_PDIV><<<g1, TT_THREADS, sm1, st>>>(
                out, g, C, q, k, ipsi, Ninv, p0, pdc, S);
    }
    TT_CHECK();
    return 0;
}

// ---------------------------------------------------------------------
// Host entry points (plain C interface, loaded with ctypes): the 62-bit
// lane, then the 30-bit lane (_30) with the same arguments over i32.
// ---------------------------------------------------------------------
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

extern "C" int tt_ntt_inv(const i64* x, i64* out, int rows, int C,
                          int C_in, int logN, const i64* q, const i64* k,
                          const i64* ipsi, const i64* Ninv, int epi,
                          const i64* p0, const i64* pdc, int S,
                          void* stream) {
    return ntt_inv(x, out, rows, C, C_in, logN, q, k, ipsi, Ninv, epi, p0,
                   pdc, S, stream);
}

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

extern "C" int tt_ntt_inv_30(const i32* x, i32* out, int rows, int C,
                             int C_in, int logN, const i32* q, const i32* k,
                             const i32* ipsi, const i32* Ninv, int epi,
                             const i32* p0, const i32* pdc, int S,
                             void* stream) {
    return ntt_inv(x, out, rows, C, C_in, logN, q, k, ipsi, Ninv, epi, p0,
                   pdc, S, stream);
}
