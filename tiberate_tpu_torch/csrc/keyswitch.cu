// All keyswitch parts in one kernel family (K6, ntt_keymul_parts).
//
// Replaces the Pallas kernel _make_parts_kernel run by _run_parts_group
// (tiberate_tpu/ops/pallas_mxu.py:678, :868; entry ntt_keymul_parts :988):
// for every part p, the signed-digit basis extension
//     ext[c] = REDC(st[p, 0] Rs[c]) + sum_i REDC(st[p, i] L_enter[p, i, c])
// onto all with-special channels, the forward NTT, both evk products
// t_j = NTT(ext) k_j[p] R^-1, and the sum over parts, for j = 0, 1.
//
// The TPU kernel carries the part-sum in VMEM scratch across a sequential
// grid axis.  Hopper blocks run in no order, so here the block that owns an
// output chunk loops over the parts itself: pass 2 loads part p's chunk,
// finishes its NTT in shared memory, multiplies by both keys and adds into
// two accumulators in shared memory, in part order 0, 1, ... - the same
// order as the plain version, so the sum is deterministic and bit-identical.
// The digits are signed (the mixed-radix differences of _pre_extend):
// redc() multiplies signed operands exactly (mont.cuh).
//
// Two lanes, as in ntt.cu: tt_ntt_keymul_parts over i64 words (R = 2^62)
// and tt_ntt_keymul_parts_30 over i32 words (R = 2^30), the single-lane
// variant of the TPU kernel (pallas_mxu.py:981, :1009-1017), whose signed
// digit extension _signed_const_mult30 (:665) is the i32 redc() here.  In
// the i32 lane the extension sum stays lazy below 2q < 2^29 at every step,
// as in the i64 lane.
//
// What bounds it on the H100: the REDCs of the extension and of the NTT
// butterflies of n_parts x C_sp rows (integer multiply throughput: it
// reaches about 3% of the HBM bound of its inputs and outputs, and a
// larger share of its REDC bound, ops/roofline.py and PERF.md), plus the
// pass-1 intermediate
// [B, n_parts, C_sp, N] (340 MB of i64 at logN15, batch 8) written once
// and read once.  Pass 1 fuses the extension into the load, pass 2 fuses
// the key products and the part-sum into the store, so neither the extended
// polynomials nor the per-part products reach device memory.
#include <cuda_runtime.h>

#include "ntt.cuh"

// st [B, n_parts, amax, N] digits; ec [n_parts, C_sp, amax] extension
// constants (Rs, then L_enter); alphas [n_parts]; tmp [B, n_parts, C_sp, N].
// Grid (N2 / TC, B * n_parts * C_sp).
template <typename W>
__global__ void parts_pass1(const W* __restrict__ st, const W* __restrict__ ec,
                            const int* __restrict__ alphas,
                            W* __restrict__ tmp, Geo g, int n_parts,
                            int amax, int C_sp, const W* __restrict__ qv,
                            const W* __restrict__ kv,
                            const W* __restrict__ psi) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    const int row = blockIdx.y;
    const int c = row % C_sp;
    const int bp = row / C_sp;          // b * n_parts + p
    const int p = bp % n_parts;
    const int ct = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const int alpha = alphas[p];
    const W* dig = st + (((size_t)bp * amax) << g.logN);
    const W* cst = ec + ((size_t)p * C_sp + c) * amax;
    const int n = g.N1 * g.TC;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int xi = strided_x(g, ct, e);
        W v = redc(dig[xi], cst[0], q, k);
        for (int i = 1; i < alpha; ++i)
            v = lazy_add(v, redc(dig[((size_t)i << g.logN) + xi], cst[i], q, k),
                         q2);
        s[e] = v;
    }
    __syncthreads();
    fwd_strided(s, g, psi + ((size_t)c << g.logN), q, k);
    const size_t base = (size_t)row << g.logN;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
        tmp[base + strided_x(g, ct, e)] = s[e];
}

// keys k0, k1 [n_parts, C_sp, N]; acc0, acc1 [B, C_sp, N].
// Grid (N1, B * C_sp).
template <typename W>
__global__ void parts_pass2(const W* __restrict__ tmp, const W* __restrict__ k0,
                            const W* __restrict__ k1, W* __restrict__ acc0,
                            W* __restrict__ acc1, Geo g, int n_parts,
                            int C_sp, const W* __restrict__ qv,
                            const W* __restrict__ kv,
                            const W* __restrict__ psi) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    W* a0 = s + g.N2;
    W* a1 = s + 2 * g.N2;
    const int row = blockIdx.y;
    const int c = row % C_sp;
    const int b = row / C_sp;
    const int j1 = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const W* tw = psi + ((size_t)c << g.logN);
    const size_t chunk = (size_t)j1 << g.L2;
    for (int p = 0; p < n_parts; ++p) {
        const W* src =
            tmp + ((((size_t)b * n_parts + p) * C_sp + c) << g.logN) + chunk;
        for (int e = threadIdx.x; e < g.N2; e += blockDim.x) s[e] = src[e];
        __syncthreads();
        fwd_contig(s, g, j1, tw, q, k);
        const size_t koff = (((size_t)p * C_sp + c) << g.logN) + chunk;
        for (int e = threadIdx.x; e < g.N2; e += blockDim.x) {
            const W t0 = redc(s[e], k0[koff + e], q, k);
            const W t1 = redc(s[e], k1[koff + e], q, k);
            a0[e] = p == 0 ? t0 : lazy_add(a0[e], t0, q2);
            a1[e] = p == 0 ? t1 : lazy_add(a1[e], t1, q2);
        }
        __syncthreads();
    }
    const size_t off = ((size_t)row << g.logN) + chunk;
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) {
        acc0[off + e] = a0[e];
        acc1[off + e] = a1[e];
    }
}

template <typename W>
static int ntt_keymul_parts(const W* st, const W* ec, const int* alphas,
                            W* tmp, const W* k0, const W* k1, W* acc0,
                            W* acc1, int B, int n_parts, int amax, int C_sp,
                            int logN, const W* q, const W* k, const W* psi,
                            void* stream) {
    const Geo g = make_geo(logN);
    cudaStream_t stm = (cudaStream_t)stream;
    const size_t sm1 = (size_t)g.N1 * g.TC * sizeof(W);
    dim3 g1(g.N2 / g.TC, B * n_parts * C_sp), g2(g.N1, B * C_sp);
    parts_pass1<W><<<g1, TT_THREADS, sm1, stm>>>(st, ec, alphas, tmp, g,
                                                 n_parts, amax, C_sp, q, k,
                                                 psi);
    TT_CHECK();
    parts_pass2<W><<<g2, contig_threads(g), 3 * g.N2 * sizeof(W), stm>>>(
        tmp, k0, k1, acc0, acc1, g, n_parts, C_sp, q, k, psi);
    TT_CHECK();
    return 0;
}

extern "C" int tt_ntt_keymul_parts(const i64* st, const i64* ec,
                                   const int* alphas, i64* tmp,
                                   const i64* k0, const i64* k1, i64* acc0,
                                   i64* acc1, int B, int n_parts, int amax,
                                   int C_sp, int logN, const i64* q,
                                   const i64* k, const i64* psi,
                                   void* stream) {
    return ntt_keymul_parts(st, ec, alphas, tmp, k0, k1, acc0, acc1, B,
                            n_parts, amax, C_sp, logN, q, k, psi, stream);
}

extern "C" int tt_ntt_keymul_parts_30(const i32* st, const i32* ec,
                                      const int* alphas, i32* tmp,
                                      const i32* k0, const i32* k1,
                                      i32* acc0, i32* acc1, int B,
                                      int n_parts, int amax, int C_sp,
                                      int logN, const i32* q, const i32* k,
                                      const i32* psi, void* stream) {
    return ntt_keymul_parts(st, ec, alphas, tmp, k0, k1, acc0, acc1, B,
                            n_parts, amax, C_sp, logN, q, k, psi, stream);
}
