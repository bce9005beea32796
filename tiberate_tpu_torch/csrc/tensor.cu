// Tensor product of two ciphertexts in the NTT domain (K5, ntt_tensor).
//
// Replaces the Pallas kernel _make_tensor_kernel run by _run_tensor_group
// (tiberate_tpu/ops/pallas_mxu.py:1084, :1194; entry ntt_tensor :1252):
// four enter-NTTs (x0, x1, y0, y1), then
//     d0 = x0 y0,   d1 = x0 y1 + x1 y0,   d2 = x1 y1   (Montgomery).
//
// Two launches on the register-tiled core of ntt.cuh:
//
//   pass 1 (tensor_strided_k, grid (N2 / TC, rows, 4)): the forward
//     strided pass fwd_strided_tile with the x R entry fused into the
//     load, one launch for the four inputs (blockIdx.z picks the input),
//     into tmp [4, rows, N];
//   pass 2 (tensor_contig_k, grid (N1 / CH, rows)): per chunk, the
//     twiddle table is staged once, then the four lines are transformed
//     one after another in registers (fwd_chunk); each thread keeps its
//     R words of X0 and X1 in shared memory beside the chunk (its own
//     words: no barrier), forms d0 and X1 Y0 after Y0, d1 and d2 after
//     Y1, and stores them as 16-byte vectors, so the finished transforms
//     never reach device memory: 4 reads and 3 writes per coefficient in
//     pass 2.
//
// Two lanes: tt_ntt_tensor over i64 words (R = 2^62) and tt_ntt_tensor_30
// over i32 words (R = 2^30), the single-lane variant of the TPU kernel
// (pallas_mxu.py:1268).  The build compiles this file once per lane
// (TT_LANE), each instantiating both passes for every logN (4..17).
//
// What bounds it on the H100: the REDCs of the four transforms and the
// four products per coefficient (ops/roofline.py), not the bytes.
// Against the four costs of the stage-at-a-time design it replaces: (1)
// three stages a round in registers, one shared-memory exchange and
// barrier per round (warp barriers at logN15), none per stage; (2) the
// plan is compile-time per logN, so no index divides by a runtime value;
// (3) each block stages its twiddles once - a strided block N1 words, a
// contiguous chunk N2 words for all four lines; (4) 128 B strided tiles,
// 256-512 threads a block, and one pass-1 launch, not four.  Measured on
// the H100 (cuobjdump of the sm_90a build, chip_smoke.py phase 2c): pass
// 2 at logN15, four lines of 32 butterflies a thread and the products, is
// 7744 SASS instructions (3514 IMAD-class) in the 62-bit lane, 60.5 a
// butterfly (9579, 3997 and 74.8 with the REDC of signed 128-bit halves,
// mont.cuh), and 2519 (956) in the 30-bit lane, 19.7; pass 1 is 72.3 a
// butterfly with its x R entry (85.5 before).  In the 62-bit lane
// the two lines kept beside the chunk hold pass 2 to two blocks an SM
// (shared memory), where the transforms' contiguous pass runs four, and
// it runs at about two thirds of their rate per REDC (PERF.md).
#include "ntt.cuh"

// The four inputs of pass 1, chosen by blockIdx.z.
template <typename W>
struct Quad {
    const W* x[4];
};

// in: four [rows, N] inputs; tmp [4, rows, N].  Row = batch * C + channel.
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T1)
tensor_strided_k(Quad<W> in, W* __restrict__ tmp, int rows, int C,
                 const W* __restrict__ qv, const W* __restrict__ kv,
                 const W* __restrict__ psi, const W* __restrict__ Rs) {
    typedef typename Plan<W, LOGN>::S1 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;
    const int c = row % C;
    const int z = blockIdx.z;
    const U q = (U)qv[c], k = (U)kv[c];
    // selects, not in.x[z]: a parameter indexed at run time goes to the stack
    const W* x = z == 0   ? in.x[0]
                 : z == 1 ? in.x[1]
                 : z == 2 ? in.x[2]
                          : in.x[3];
    const W* xr = x + ((size_t)row << LOGN);
    fwd_strided_tile<W, LOGN>(
        [&](W(&v)[SC::R], const int(&xo)[SC::R]) {
#pragma unroll
            for (int i = 0; i < SC::R; ++i) v[i] = xr[xo[i]];
            const W rs = Rs[c];  // R^2 mod q
#pragma unroll
            for (int i = 0; i < SC::R; ++i) v[i] = redc_by(v[i], rs, q, k);
        },
        tmp + (((size_t)z * rows + row) << LOGN), psi + ((size_t)c << LOGN),
        q, k);
}

// tmp [4, rows, N] (x0, x1, y0, y1 after pass 1); d0, d1, d2 [rows, N].
template <typename W, int LOGN>
__global__ void __launch_bounds__(Plan<W, LOGN>::T2)
tensor_contig_k(const W* __restrict__ tmp, W* __restrict__ d0,
                W* __restrict__ d1, W* __restrict__ d2, int rows, int C,
                const W* __restrict__ qv, const W* __restrict__ kv,
                const W* __restrict__ psi) {
    typedef Plan<W, LOGN> P;
    typedef typename P::S2 SC;
    typedef typename Lane<W>::U U;
    const int row = blockIdx.y;
    const int c = row % C;
    const int cl = threadIdx.x / P::TPC;
    const int t = threadIdx.x & (P::TPC - 1);
    const int j1 = blockIdx.x * P::CH + cl;
    const U q = (U)qv[c], k = (U)kv[c];
    const W q2 = (W)(q << 1);
    const size_t off = ((size_t)row << LOGN) + ((size_t)j1 << P::L2);
    const size_t plane = (size_t)rows << LOGN;
    W* T = smem<W>() + cl * P::CHUNK;
    chunk_twiddles<W, P::L1, P::L2, P::TPC>(T, psi + ((size_t)c << LOGN), j1,
                                            t);
    tile_sync<P::WARP2>();
    // X0 and X1 wait in shared memory after the chunks, word i of thread
    // x at [i * T2 + x] (conflict-free): in registers the four lines need
    // 130-odd registers a thread in the 62-bit lane, one block an SM
    W* s0 = smem<W>() + P::CH * P::CHUNK + threadIdx.x;
    W* s1 = s0 + P::T2 * SC::R;
    W Y[SC::R], m[SC::R], d[SC::R];
    fwd_chunk<W, LOGN>(Y, tmp + off, t, T, q, k, q2);
#pragma unroll
    for (int i = 0; i < SC::R; ++i) s0[i * P::T2] = Y[i];
    fwd_chunk<W, LOGN>(Y, tmp + plane + off, t, T, q, k, q2);
#pragma unroll
    for (int i = 0; i < SC::R; ++i) s1[i * P::T2] = Y[i];
    fwd_chunk<W, LOGN>(Y, tmp + 2 * plane + off, t, T, q, k, q2);  // Y0
    // after the last round thread t holds words tR .. tR+R-1 of the chunk
    const size_t o = off + (size_t)t * SC::R;
#pragma unroll
    for (int i = 0; i < SC::R; ++i) {
        d[i] = redc(s0[i * P::T2], Y[i], q, k);
        m[i] = redc(s1[i * P::T2], Y[i], q, k);
    }
    st_vec(d0 + o, d);
    fwd_chunk<W, LOGN>(Y, tmp + 3 * plane + off, t, T, q, k, q2);  // Y1
#pragma unroll
    for (int i = 0; i < SC::R; ++i)
        d[i] = tile_add(redc(s0[i * P::T2], Y[i], q, k), m[i], q2);
    st_vec(d1 + o, d);
#pragma unroll
    for (int i = 0; i < SC::R; ++i) d[i] = redc(s1[i * P::T2], Y[i], q, k);
    st_vec(d2 + o, d);
}

template <typename W, int LOGN>
static int tensor_n(const W* x0, const W* x1, const W* y0, const W* y1,
                    W* tmp, W* d0, W* d1, W* d2, int rows, int C, const W* q,
                    const W* k, const W* psi, const W* Rs, cudaStream_t s) {
    typedef Plan<W, LOGN> P;
    // pass 2: the chunks' tables and exchange buffers, then X0 and X1
    constexpr int SMEM = P::SMEM2 + 2 * P::T2 * P::S2::R * (int)sizeof(W);
    static const bool ready =
        allow_smem(tensor_strided_k<W, LOGN>, P::SMEM1) &&
        allow_smem(tensor_contig_k<W, LOGN>, SMEM);
    if (!ready) return (int)cudaErrorInvalidValue;
    const Quad<W> in = {{x0, x1, y0, y1}};
    tensor_strided_k<W, LOGN><<<dim3(P::N2 / P::TC, rows, 4), P::T1,
                                P::SMEM1, s>>>(in, tmp, rows, C, q, k, psi,
                                               Rs);
    TT_CHECK();
    tensor_contig_k<W, LOGN><<<dim3(P::N1 / P::CH, rows), P::T2, SMEM,
                               s>>>(tmp, d0, d1, d2, rows, C, q, k, psi);
    TT_CHECK();
    return 0;
}

// x0, x1, y0, y1, d0, d1, d2: [rows, N]; tmp: [4, rows, N] scratch.
template <typename W>
static int ntt_tensor(const W* x0, const W* x1, const W* y0, const W* y1,
                      W* tmp, W* d0, W* d1, W* d2, int rows, int C, int logN,
                      const W* q, const W* k, const W* psi, const W* Rs,
                      void* stream) {
    TT_BY_LOGN(tensor_n, x0, x1, y0, y1, tmp, d0, d1, d2, rows, C, q, k, psi,
               Rs, (cudaStream_t)stream)
}

#if TT_I64
extern "C" int tt_ntt_tensor(const i64* x0, const i64* x1, const i64* y0,
                             const i64* y1, i64* tmp, i64* d0, i64* d1,
                             i64* d2, int rows, int C, int logN,
                             const i64* q, const i64* k, const i64* psi,
                             const i64* Rs, void* stream) {
    return ntt_tensor(x0, x1, y0, y1, tmp, d0, d1, d2, rows, C, logN, q, k,
                      psi, Rs, stream);
}
#endif

#if TT_I32
extern "C" int tt_ntt_tensor_30(const i32* x0, const i32* x1, const i32* y0,
                                const i32* y1, i32* tmp, i32* d0, i32* d1,
                                i32* d2, int rows, int C, int logN,
                                const i32* q, const i32* k, const i32* psi,
                                const i32* Rs, void* stream) {
    return ntt_tensor(x0, x1, y0, y1, tmp, d0, d1, d2, rows, C, logN, q, k,
                      psi, Rs, stream);
}
#endif
