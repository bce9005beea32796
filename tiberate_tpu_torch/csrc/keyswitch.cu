// All keyswitch parts in one kernel family (K6, ntt_keymul_parts).
//
// Replaces the Pallas kernel _make_parts_kernel run by _run_parts_group
// (tiberate_tpu/ops/pallas_mxu.py:678, :868; entry ntt_keymul_parts :988):
// for every part p, the signed-digit basis extension
//     ext[c] = st[p, 0] Rs[c] + sum_i st[p, i] L_enter[p, i, c]  (x R^-1)
// onto all with-special channels, the forward NTT, both evk products
// t_j = NTT(ext) k_j[p] R^-1, and the sum over parts, for j = 0, 1.
//
// The TPU kernel carries the part-sum in VMEM scratch across a sequential
// grid axis.  Hopper blocks run in no order, so here the block that owns an
// output chunk loops over the parts itself, in part order 0, 1, ...  The
// digits are signed (the mixed-radix differences of _pre_extend).
//
// Two lanes: tt_ntt_keymul_parts over i64 words (R = 2^62) and
// tt_ntt_keymul_parts_30 over i32 words (R = 2^30), the single-lane
// variant of the TPU kernel (pallas_mxu.py:981, :1009-1017), whose signed
// digit extension _signed_const_mult30 (:665) is the i32 redc() here.  The
// build compiles this file once per lane (TT_LANE), each instantiating
// both passes for every logN (4..17).
//
// Sums reduced once (62-bit lane).  Both sums of products are kept as
// exact 128-bit integers and each output word is reduced once, after its
// last term (mont.cuh, "Sums of products"):
//
//   pass 1: S = sum_a d_a c_a over a run of at most run1 of the part's
//     alpha digits, d_a any i64 word, c_a in [0, q).  Each term is the
//     unsigned product of the biased digit d_a + 2^63 and c_a, one 64 x
//     64 -> 128 product and a 128-bit add; the sum starts at -2^63 sum_a
//     c_a over the run, so it is S in two's complement.  |S| <= run1 2^63
//     (q - 1), so its high word H has |H| <= ceil(run1 (q - 1) / 2);
//     folded as H (2^64 mod q) + lo, its REDC lies in (-q, 2q) where H (q
//     - 1) + 2^64 <= q 2^62, and +q where negative brings it into [0,
//     2q), the range the forward stages take.  The runs' results are
//     added lazily, as the chain adds its terms; a part that fits one run
//     (every part of the presets) makes one reduction a word.  A part of
//     alpha 1 keeps its one redc_by(), (-2q, 3q) for every digit, brought
//     into [0, 2q) by a select.
//   pass 2: S_j = sum_p v_p k_j[p] over the parts, v in [0, 2q) (the
//     forward stages keep [0, 2q)), keys in [0, q), unsigned; folded
//     (fold_sum) after every run2 parts where parts follow, to at most
//     (2^64 - 1) q, and reduced once after the last, into [0, 2q): run2
//     parts more keep H (q - 1) + 2^64 <= q 2^62 with H = S_j >> 64.
//
// run1 and run2 come from the host (ntt_kernels.sum_runs, from the
// basis's largest modulus, held by the LevelPack): below 2^60 they are at
// least 7 digits and 23 parts, so the presets' sums (logN17: alpha 6, 13
// parts) run whole, and any number of parts and any alpha runs too.  The
// sums are congruent to the plain version's chains of REDCs, so the
// outputs equal ntt_keymul_parts_plain's residue for residue (in [0, 2q),
// as the chain's); not word for word: a chain of signed terms, each
// reduced, lands on a representative that depends on its path, and the
// parity contract leaves K6's lazy accumulators free (ROADMAP.md).  2^64
// mod q comes from the host too (fold [C_sp]).  The 30-bit lane keeps its
// per-product reductions: its sum stays lazy below 2q < 2^29.
//
// Two launches on the register-tiled core of ntt.cuh:
//
//   pass 1 (parts_strided_k, grid (N2 / TC, B * n_parts * C_sp)): the
//     forward strided pass fwd_strided_tile, with the extension fused
//     into the load: each thread reads its R slots' digits for the part's
//     alpha_p rows and forms the sum in registers, four slots at a time
//     in the 62-bit lane (8 x 128-bit sums at once take 94-100 registers
//     a thread); the result goes to the intermediate tmp [B, n_parts,
//     C_sp, N];
//   pass 2 (parts_contig_k, grid (N1 / CH, B * C_sp)): a block owns CH
//     chunks of one (b, c) row, stages each chunk's twiddle table once,
//     then for each part in order transforms the chunk of tmp in
//     registers (fwd_chunk), multiplies by k0[p] and k1[p] (16-byte
//     loads) and adds into two register accumulators (2 x R x 128 bits in
//     the 62-bit lane); both are stored once, as 16-byte vectors.
//
// The keys are read in place: k0p and k1p are device tables of one base
// pointer per part, each pointing at that part's [C_sp, N] evk rows
// wherever the key holds them (row-contiguous, 16-byte aligned; the
// wrapper checks both).  The TPU kernel takes the parts stacked into one
// [n_parts, C_sp, N] array, the layout its BlockSpec indexes by part; a
// pointer per part costs pass 2 one uniform load a part and spares the
// caller a stacked copy of every key it switches with.
//
// What bounds it on the H100: integer issue, the products of the
// extension, of the butterflies of n_parts x C_sp rows and of the keys
// (ops/roofline.py; the bytes bound is a few percent of it).  Against the
// four costs of the stage-at-a-time design it replaces: (1) a round of
// three stages runs in registers between shared-memory exchanges, and the
// part loop adds no barrier beyond those exchanges (a logN15 chunk lies
// in one warp, so they are warp barriers); (2) every index is a
// compile-time shift, the plan being instantiated per logN; only the
// extension's alpha_p loop and the part loop run to runtime bounds; (3)
// pass 2 reads a chunk's twiddles once for all parts, not once per part
// and butterfly; (4) tiles are 128 B wide in both lanes, blocks take
// 256-512 threads, and the accumulators live in registers, not in shared
// memory.  The intermediate tmp stays: an i64 logN15 row (256 KB) exceeds
// a block's 227 KB, so the transform needs its two launches, and tmp is
// written once and read once (a floor outside the bytes bound, which
// counts inputs and outputs only; PERF.md).
//
// Measured on the H100 (sm_90a build; cuobjdump's SASS of each kernel,
// chip_smoke.py phase 2c, over the butterflies one thread runs in it;
// ptxas -v), 62-bit lane, before the sums -> after:
//
//   pass 2 (the part loop's body: one part's butterflies, its two key
//     products and adds, beside the fold the presets never run), logN15:
//     3041 SASS (1422 IMAD-class), 95.0 a butterfly -> 2844 (1304), 88.9;
//     logN17: 3222, 89.5 -> 3030, 84.2; 112 -> 128 registers, no spill,
//     256 threads, 2 blocks an SM both;
//   pass 1 (the extension: the alpha 1 branch, the first run and the
//     later runs, each four slots at a time twice), logN15: 2312 (983),
//     82.6 -> 4339 (1709), 155.0; logN17: 2494, 77.9 -> 4515 (1785),
//     141.1: more code, fewer instructions run for alpha >= 2; 64 / 60 ->
//     64 registers, no spill (the launch bound below caps them: left
//     alone they take 94-100 and halve the blocks an SM), 4 blocks of 256
//     an SM at logN15, 2 of 512 at logN17.
//
// The 30-bit lane: pass 2 unchanged (1045 SASS, 62 registers); pass 1's
// arithmetic unchanged, its registers 58 -> 64 (logN15), 118 -> 96
// (logN17) and 52 -> 72 (logN10) under the explicit one-block bound.
#include <type_traits>

#include "ntt.cuh"

// st [B, n_parts, amax, N] digits; ec [n_parts, C_sp, amax] extension
// constants (Rs, then L_enter); alphas [n_parts]; fold [C_sp] 2^64 mod q
// and run1, the most digits a sum takes (62-bit lane; unread in the
// 30-bit lane); tmp [B, n_parts, C_sp, N].
// Pass 1's blocks an SM: in the 62-bit lane as many as hold 1024
// threads, which caps a thread at 64 registers (the sums would take more),
// and at most 16: a block of fewer than 32 threads (logN < 10) takes a
// whole warp's registers, so 16 of them leave 128 a thread; one in the
// 30-bit lane.
template <typename W, int LOGN>
__host__ __device__ constexpr int parts_blocks1() {
    return sizeof(W) == 8 ? tt_min(16, 1024 / Plan<W, LOGN>::T1) : 1;
}

template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T1,
                                  parts_blocks1<W, LOGN>())
parts_strided_k(const W* __restrict__ st, const W* __restrict__ ec,
                const int* __restrict__ alphas, W* __restrict__ tmp,
                int n_parts, int amax, int C_sp, const W* __restrict__ qv,
                const W* __restrict__ kv, const W* __restrict__ psi,
                const W* __restrict__ fold, int run1) {
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
            if constexpr (sizeof(W) == 8) {
                if (alpha == 1) {
                    // one product, one REDC: (-2q, 3q) for every digit
#pragma unroll
                    for (int i = 0; i < SC::R; ++i) {
                        const W x = redc_by(dig[xo[i]], c0, q, k);
                        v[i] = x < 0 ? x + q2 : (x < q2 ? x : x - q2);
                    }
                    return;
                }
                // the exact sums of d_a c_a over runs of at most run1
                // digits: biased digits d_a + 2^63 give unsigned
                // products, so a run's sum starts at -2^63 sum_a c_a; the
                // first run sets v, a later one adds to it lazily
                const U f = (U)fold[c];
                constexpr int G = SC::R < 4 ? SC::R : 4;  // slots at once
                const auto sum_run = [&](int a0, auto add) {
                    const int a1 = alpha - a0 > run1 ? a0 + run1 : alpha;
                    U csum = 0;
                    for (int a = a0; a < a1; ++a) csum += (U)cst[a];
                    const u128 init = (u128)0 - ((u128)csum << 63);
#pragma unroll
                    for (int g = 0; g < SC::R; g += G) {
                        u128 acc[G];
#pragma unroll
                        for (int i = 0; i < G; ++i) acc[i] = init;
                        for (int a = a0; a < a1; ++a) {
                            const W* d = dig + ((size_t)a << LOGN);
                            const U ca = (U)cst[a];
#pragma unroll
                            for (int i = 0; i < G; ++i)
                                acc[i] +=
                                    (u128)((U)d[xo[g + i]] ^ TT_BIAS) * ca;
                        }
#pragma unroll
                        for (int i = 0; i < G; ++i) {
                            W x = redc_sum_signed(acc[i], f, q, k);
                            x = x < 0 ? x + (W)q : x;
                            if constexpr (decltype(add)::value)
                                x = tile_add(v[g + i], x, q2);
                            v[g + i] = x;
                        }
                    }
                };
                sum_run(0, std::false_type());
                for (int a0 = run1; a0 < alpha; a0 += run1)
                    sum_run(a0, std::true_type());
            } else {
#pragma unroll
                for (int i = 0; i < SC::R; ++i)
                    v[i] = redc_by(dig[xo[i]], c0, q, k);
                for (int a = 1; a < alpha; ++a) {
                    const W* d = dig + ((size_t)a << LOGN);
                    const W ca = cst[a];
#pragma unroll
                    for (int i = 0; i < SC::R; ++i)
                        v[i] = tile_add(v[i], redc_by(d[xo[i]], ca, q, k),
                                        q2);
                }
            }
        },
        tmp + ((size_t)row << LOGN), psi + ((size_t)c << LOGN), q, k);
}

// key tables k0p, k1p [n_parts]: part p's rows, each [C_sp, N];
// acc0, acc1 [B, C_sp, N]; run2, the most parts a sum adds between two
// folds (62-bit lane; unread in the 30-bit lane).
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T2)
parts_contig_k(const W* __restrict__ tmp, const W* const* __restrict__ k0p,
               const W* const* __restrict__ k1p, W* __restrict__ acc0,
               W* __restrict__ acc1, int n_parts, int C_sp,
               const W* __restrict__ qv, const W* __restrict__ kv,
               const W* __restrict__ psi, const W* __restrict__ fold,
               int run2) {
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
    const size_t o = ((size_t)row << LOGN) + chunk + (size_t)t * SC::R;
    W v[SC::R], key[SC::R];
    if constexpr (sizeof(W) == 8) {
        // the exact sums of v key over the parts (v in [0, 2q), keys in
        // [0, q)), folded after every run2 parts where parts follow and
        // reduced once (the fold word is read where it is used: the part
        // loop holds no register for it)
        u128 a0[SC::R], a1[SC::R];
#pragma unroll
        for (int i = 0; i < SC::R; ++i) a0[i] = a1[i] = 0;
        for (int p = 0, next = run2; p < n_parts; ++p) {
            fwd_chunk<W, LOGN>(v, src + p * pstride, t, T, q, k, q2);
            ld_vec(key, k0p[p] + ko);
#pragma unroll
            for (int i = 0; i < SC::R; ++i)
                a0[i] += (u128)(U)v[i] * (U)key[i];
            ld_vec(key, k1p[p] + ko);
#pragma unroll
            for (int i = 0; i < SC::R; ++i)
                a1[i] += (u128)(U)v[i] * (U)key[i];
            if (p + 1 == next && next < n_parts) {
                next += run2;
                const U f = (U)fold[c];
#pragma unroll
                for (int i = 0; i < SC::R; ++i) {
                    a0[i] = fold_sum(a0[i], f);
                    a1[i] = fold_sum(a1[i], f);
                }
            }
        }
        const U f = (U)fold[c];
#pragma unroll
        for (int i = 0; i < SC::R; ++i) v[i] = redc_sum(a0[i], f, q, k);
        st_vec(acc0 + o, v);
#pragma unroll
        for (int i = 0; i < SC::R; ++i) v[i] = redc_sum(a1[i], f, q, k);
        st_vec(acc1 + o, v);
    } else {
        W a0[SC::R], a1[SC::R];
        for (int p = 0; p < n_parts; ++p) {
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
        st_vec(acc0 + o, a0);
        st_vec(acc1 + o, a1);
    }
}

template <typename W, int LOGN>
static int parts_n(const W* st, const W* ec, const int* alphas, W* tmp,
                   const W* const* k0p, const W* const* k1p, W* acc0,
                   W* acc1, int B,
                   int n_parts, int amax, int C_sp, const W* q, const W* k,
                   const W* psi, const W* fold, int run1, int run2,
                   cudaStream_t s) {
    typedef Plan<W, LOGN> P;
    static const bool ready =
        allow_smem(parts_strided_k<W, LOGN>, P::SMEM1) &&
        allow_smem(parts_contig_k<W, LOGN>, P::SMEM2);
    if (!ready) return (int)cudaErrorInvalidValue;
    parts_strided_k<W, LOGN><<<dim3(P::N2 / P::TC, B * n_parts * C_sp),
                               P::T1, P::SMEM1, s>>>(
        st, ec, alphas, tmp, n_parts, amax, C_sp, q, k, psi, fold, run1);
    TT_CHECK();
    parts_contig_k<W, LOGN><<<dim3(P::N1 / P::CH, B * C_sp), P::T2,
                              P::SMEM2, s>>>(tmp, k0p, k1p, acc0, acc1,
                                             n_parts, C_sp, q, k, psi, fold,
                                             run2);
    TT_CHECK();
    return 0;
}

template <typename W>
static int ntt_keymul_parts(const W* st, const W* ec, const int* alphas,
                            W* tmp, const W* const* k0p,
                            const W* const* k1p, W* acc0, W* acc1, int B,
                            int n_parts, int amax, int C_sp, int logN,
                            const W* q, const W* k, const W* psi,
                            const W* fold, int run1, int run2,
                            void* stream) {
    TT_BY_LOGN(parts_n, st, ec, alphas, tmp, k0p, k1p, acc0, acc1, B,
               n_parts, amax, C_sp, q, k, psi, fold, run1, run2,
               (cudaStream_t)stream)
}

#if TT_I64
extern "C" int tt_ntt_keymul_parts(const i64* st, const i64* ec,
                                   const int* alphas, i64* tmp,
                                   const i64* const* k0p,
                                   const i64* const* k1p, i64* acc0,
                                   i64* acc1, int B, int n_parts, int amax,
                                   int C_sp, int logN, const i64* q,
                                   const i64* k, const i64* psi,
                                   const i64* fold, int run1, int run2,
                                   void* stream) {
    return ntt_keymul_parts(st, ec, alphas, tmp, k0p, k1p, acc0, acc1, B,
                            n_parts, amax, C_sp, logN, q, k, psi, fold,
                            run1, run2, stream);
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
                                      const i32* psi, const i32* fold,
                                      int run1, int run2, void* stream) {
    return ntt_keymul_parts(st, ec, alphas, tmp, k0p, k1p, acc0, acc1, B,
                            n_parts, amax, C_sp, logN, q, k, psi, fold,
                            run1, run2, stream);
}
#endif
