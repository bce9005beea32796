// All keyswitch parts in one kernel family (K6, ntt_keymul_parts).
//
// Replaces the Pallas kernel _make_parts_kernel run by _run_parts_group
// (tiberate_tpu/ops/pallas_mxu.py:678, :868; entry ntt_keymul_parts :988):
// for every part p, the signed-digit basis extension
//     ext[c] = REDC(st[p, 0] Rs[c]) (+) sum_i REDC(st[p, i] L_enter[p, i, c])
// onto all with-special channels, the forward NTT, both evk products
// t_j = NTT(ext) k_j[p] R^-1, and the sum over parts, for j = 0, 1.
//
// The TPU kernel carries the part-sum in VMEM scratch across a sequential
// grid axis.  Hopper blocks run in no order, so here the block that owns an
// output chunk loops over the parts itself, in part order 0, 1, ... - the
// order of the plain version, so the sum is deterministic and
// bit-identical.  The digits are signed (the mixed-radix differences of
// _pre_extend): redc_by() multiplies a signed digit by its constant
// exactly (mont.cuh).
//
// Two lanes: tt_ntt_keymul_parts over i64 words (R = 2^62) and
// tt_ntt_keymul_parts_30 over i32 words (R = 2^30), the single-lane
// variant of the TPU kernel (pallas_mxu.py:981, :1009-1017), whose signed
// digit extension _signed_const_mult30 (:665) is the i32 redc() here.  In
// the i32 lane the extension sum stays lazy below 2q < 2^29 at every step,
// as in the i64 lane.  The build compiles this file once per lane
// (TT_LANE), each instantiating both passes for every logN (4..17).
//
// Two launches on the register-tiled core of ntt.cuh:
//
//   pass 1 (parts_strided_k, grid (N2 / TC, B * n_parts * C_sp)): the
//     forward strided pass fwd_strided_tile, with the extension fused
//     into the load: each thread reads its R slots' digits for the part's
//     alpha_p rows and forms the lazy sum in registers; the result goes
//     to the intermediate tmp [B, n_parts, C_sp, N];
//   pass 2 (parts_contig_k, grid (N1 / CH, B * C_sp)): a block owns CH
//     chunks of one (b, c) row, stages each chunk's twiddle table once,
//     then for each part in order transforms the chunk of tmp in
//     registers (fwd_chunk), multiplies by k0[p] and k1[p] (16-byte
//     loads) and adds into two register accumulators; both are stored
//     once, as 16-byte vectors.
//
// The keys are read in place: k0p and k1p are device tables of one base
// pointer per part, each pointing at that part's [C_sp, N] evk rows
// wherever the key holds them (row-contiguous, 16-byte aligned; the
// wrapper checks both).  The TPU kernel takes the parts stacked into one
// [n_parts, C_sp, N] array, the layout its BlockSpec indexes by part; a
// pointer per part costs pass 2 one uniform load a part and spares the
// caller a stacked copy of every key it switches with.
//
// What bounds it on the H100: the REDCs of the extension, the butterflies
// of n_parts x C_sp rows and the key products (ops/roofline.py; the bytes
// bound is a few percent of it).  Against the four costs of the
// stage-at-a-time design it replaces: (1) a round of three stages runs in
// registers between shared-memory exchanges, and the part loop adds no
// barrier beyond those exchanges (a logN15 chunk lies in one warp, so
// they are warp barriers); (2) every index is a compile-time shift, the
// plan being instantiated per logN; only the extension's alpha_p loop and
// the part loop run to runtime bounds; (3) pass 2 reads a chunk's
// twiddles once for all parts, not once per part and butterfly; (4) tiles
// are 128 B wide in both lanes, blocks take 256-512 threads, and the
// accumulators live in registers, not in shared memory.  The intermediate
// tmp stays: an i64 logN15 row (256 KB) exceeds a block's 227 KB, so the
// transform needs its two launches, and tmp is written once and read once
// (a floor outside the bytes bound, which counts inputs and outputs only;
// PERF.md).  Measured on the H100 (cuobjdump of the sm_90a build,
// chip_smoke.py phase 2c): pass 2 at logN15, whose part loop's body runs
// one part's 32 butterflies a thread with its two key products and adds,
// is 3041 SASS instructions (1422 IMAD-class) in the 62-bit lane, 95.0 a
// butterfly against the transforms' 56.5 (3687, 1632, 115.2 and 68.3 with
// the REDC of signed 128-bit halves, mont.cuh), and 1045 (428) in the
// 30-bit lane, 32.7 a butterfly against 22.6: the products, adds and key
// loads add about two thirds again.  Pass 1 is 82.6 a butterfly at
// logN15 (99.9 before), the extension's first digit and one iteration of
// its digit loop included.
#include "ntt.cuh"

// st [B, n_parts, amax, N] digits; ec [n_parts, C_sp, amax] extension
// constants (Rs, then L_enter); alphas [n_parts]; tmp [B, n_parts, C_sp, N].
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T1)
parts_strided_k(const W* __restrict__ st, const W* __restrict__ ec,
                const int* __restrict__ alphas, W* __restrict__ tmp,
                int n_parts, int amax, int C_sp, const W* __restrict__ qv,
                const W* __restrict__ kv, const W* __restrict__ psi) {
    typedef typename Plan<W, LOGN>::S1 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;  // (b * n_parts + p) * C_sp + c
    const int c = row % C_sp;
    const int bp = row / C_sp;
    const int p = bp % n_parts;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const int alpha = alphas[p];
    const W* dig = st + (((size_t)bp * amax) << LOGN);
    const W* cst = ec + ((size_t)p * C_sp + c) * amax;
    fwd_strided_tile<W, LOGN>(
        [&](W(&v)[SC::R], const int(&xo)[SC::R]) {
            // the digits are signed; Rs and L_enter are in [0, q)
            const W c0 = cst[0];
#pragma unroll
            for (int i = 0; i < SC::R; ++i)
                v[i] = redc_by(dig[xo[i]], c0, q, k);
            for (int a = 1; a < alpha; ++a) {
                const W* d = dig + ((size_t)a << LOGN);
                const W ca = cst[a];
#pragma unroll
                for (int i = 0; i < SC::R; ++i)
                    v[i] = tile_add(v[i], redc_by(d[xo[i]], ca, q, k), q2);
            }
        },
        tmp + ((size_t)row << LOGN), psi + ((size_t)c << LOGN), q, k);
}

// key tables k0p, k1p [n_parts]: part p's rows, each [C_sp, N];
// acc0, acc1 [B, C_sp, N].
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T2)
parts_contig_k(const W* __restrict__ tmp, const W* const* __restrict__ k0p,
               const W* const* __restrict__ k1p, W* __restrict__ acc0,
               W* __restrict__ acc1, int n_parts, int C_sp,
               const W* __restrict__ qv, const W* __restrict__ kv,
               const W* __restrict__ psi) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S2 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;  // b * C_sp + c
    const int c = row % C_sp;
    const int b = row / C_sp;
    const int cl = threadIdx.x / P::TPC;
    const int t = threadIdx.x & (P::TPC - 1);
    const int j1 = blockIdx.x * P::CH + cl;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const size_t chunk = (size_t)j1 << P::L2;
    W* T = smem<W>() + cl * P::CHUNK;
    chunk_twiddles<W, P::L1, P::L2, P::TPC>(T, psi + ((size_t)c << LOGN), j1,
                                            t);
    tile_sync<P::WARP2>();
    // one part further on: C_sp rows of tmp
    const size_t pstride = (size_t)C_sp << LOGN;
    const W* src = tmp + (((size_t)b * n_parts * C_sp + c) << LOGN) + chunk;
    // after the last round thread t holds words tR .. tR+R-1 of the chunk
    const size_t ko = ((size_t)c << LOGN) + chunk + (size_t)t * SC::R;
    W a0[SC::R], a1[SC::R];
    for (int p = 0; p < n_parts; ++p) {
        W v[SC::R], key[SC::R];
        fwd_chunk<W, LOGN>(v, src + p * pstride, t, T, q, k, q2);
        ld_vec(key, k0p[p] + ko);
#pragma unroll
        for (int i = 0; i < SC::R; ++i) {
            const W x = redc(v[i], key[i], q, k);
            a0[i] = p == 0 ? x : tile_add(a0[i], x, q2);
        }
        ld_vec(key, k1p[p] + ko);
#pragma unroll
        for (int i = 0; i < SC::R; ++i) {
            const W x = redc(v[i], key[i], q, k);
            a1[i] = p == 0 ? x : tile_add(a1[i], x, q2);
        }
    }
    const size_t o = ((size_t)row << LOGN) + chunk + (size_t)t * SC::R;
    st_vec(acc0 + o, a0);
    st_vec(acc1 + o, a1);
}

template <typename W, int LOGN>
static int parts_n(const W* st, const W* ec, const int* alphas, W* tmp,
                   const W* const* k0p, const W* const* k1p, W* acc0,
                   W* acc1, int B,
                   int n_parts, int amax, int C_sp, const W* q, const W* k,
                   const W* psi, cudaStream_t s) {
    typedef Plan<W, LOGN> P;
    static const bool ready =
        allow_smem(parts_strided_k<W, LOGN>, P::SMEM1) &&
        allow_smem(parts_contig_k<W, LOGN>, P::SMEM2);
    if (!ready) return (int)cudaErrorInvalidValue;
    parts_strided_k<W, LOGN><<<dim3(P::N2 / P::TC, B * n_parts * C_sp),
                               P::T1, P::SMEM1, s>>>(
        st, ec, alphas, tmp, n_parts, amax, C_sp, q, k, psi);
    TT_CHECK();
    parts_contig_k<W, LOGN><<<dim3(P::N1 / P::CH, B * C_sp), P::T2,
                              P::SMEM2, s>>>(tmp, k0p, k1p, acc0, acc1,
                                             n_parts, C_sp, q, k, psi);
    TT_CHECK();
    return 0;
}

template <typename W>
static int ntt_keymul_parts(const W* st, const W* ec, const int* alphas,
                            W* tmp, const W* const* k0p,
                            const W* const* k1p, W* acc0, W* acc1, int B,
                            int n_parts, int amax, int C_sp, int logN,
                            const W* q, const W* k, const W* psi,
                            void* stream) {
    TT_BY_LOGN(parts_n, st, ec, alphas, tmp, k0p, k1p, acc0, acc1, B,
               n_parts, amax, C_sp, q, k, psi, (cudaStream_t)stream)
}

#if TT_I64
extern "C" int tt_ntt_keymul_parts(const i64* st, const i64* ec,
                                   const int* alphas, i64* tmp,
                                   const i64* const* k0p,
                                   const i64* const* k1p, i64* acc0,
                                   i64* acc1, int B, int n_parts, int amax,
                                   int C_sp, int logN, const i64* q,
                                   const i64* k, const i64* psi,
                                   void* stream) {
    return ntt_keymul_parts(st, ec, alphas, tmp, k0p, k1p, acc0, acc1, B,
                            n_parts, amax, C_sp, logN, q, k, psi, stream);
}
#endif

#if TT_I32
extern "C" int tt_ntt_keymul_parts_30(const i32* st, const i32* ec,
                                      const int* alphas, i32* tmp,
                                      const i32* const* k0p,
                                      const i32* const* k1p, i32* acc0,
                                      i32* acc1, int B, int n_parts,
                                      int amax, int C_sp, int logN,
                                      const i32* q, const i32* k,
                                      const i32* psi, void* stream) {
    return ntt_keymul_parts(st, ec, alphas, tmp, k0p, k1p, acc0, acc1, B,
                            n_parts, amax, C_sp, logN, q, k, psi, stream);
}
#endif
