// Tensor product of two ciphertexts in the NTT domain (K5, ntt_tensor).
//
// Replaces the Pallas kernel _make_tensor_kernel run by _run_tensor_group
// (tiberate_tpu/ops/pallas_mxu.py:1084, :1194; entry ntt_tensor :1252):
// four enter-NTTs (x0, x1, y0, y1), then
//     d0 = x0 y0,   d1 = x0 y1 + x1 y0,   d2 = x1 y1   (Montgomery).
//
// Pass 1 is the forward NTT's first pass with the x R entry (ntt.cu's
// fwd_pass1, one launch per input).  Pass 2 loads the same coefficient
// chunk of all four intermediates, finishes the four transforms in shared
// memory and writes d0, d1, d2, so the finished transforms never reach
// device memory: 4 reads and 3 writes per coefficient in pass 2 instead of
// 4 writes plus 4 more reads for separate products.
//
// Two lanes, as in ntt.cu: tt_ntt_tensor over i64 words (R = 2^62) and
// tt_ntt_tensor_30 over i32 words (R = 2^30), the single-lane variant of
// the TPU kernel (pallas_mxu.py:1268).
//
// What bounds it on the H100: not the bytes (it reaches 8-9% of the HBM
// bound of its inputs and outputs in both lanes) but the same REDC
// butterflies as ntt.cu, plus 4 REDCs per coefficient for the products
// (ops/roofline.py counts them; PERF.md has its share of that bound).
// Shared memory per pass-2 block is
// 4 x N2 words (8 KB of i64 at logN15), so many blocks stay resident per
// SM.
#include <cuda_runtime.h>

#include "ntt.cuh"

template <typename W>
__global__ void tensor_pass2(const W* __restrict__ tmp, W* __restrict__ d0,
                             W* __restrict__ d1, W* __restrict__ d2, Geo g,
                             int rows, int C, const W* __restrict__ qv,
                             const W* __restrict__ kv,
                             const W* __restrict__ psi) {
    typedef typename Lane<W>::U U;
    W* s = smem<W>();
    const int row = blockIdx.y;
    const int c = row % C;
    const int j1 = blockIdx.x;
    const U q = (U)qv[c], k = (U)kv[c];
    const size_t off = ((size_t)row << g.logN) + ((size_t)j1 << g.L2);
    const size_t plane = (size_t)rows << g.logN;
    for (int i = 0; i < 4; ++i)
        for (int e = threadIdx.x; e < g.N2; e += blockDim.x)
            s[i * g.N2 + e] = tmp[i * plane + off + e];
    __syncthreads();
    const W* tw = psi + ((size_t)c << g.logN);
    for (int i = 0; i < 4; ++i) fwd_contig(s + i * g.N2, g, j1, tw, q, k);
    const W q2 = (W)(q << 1);
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) {
        const W X0 = s[e], X1 = s[g.N2 + e];
        const W Y0 = s[2 * g.N2 + e], Y1 = s[3 * g.N2 + e];
        d0[off + e] = redc(X0, Y0, q, k);
        d1[off + e] = lazy_add(redc(X0, Y1, q, k), redc(X1, Y0, q, k), q2);
        d2[off + e] = redc(X1, Y1, q, k);
    }
}

// x0, x1, y0, y1, d0, d1, d2: [rows, N]; tmp: [4, rows, N] scratch.
template <typename W>
static int ntt_tensor(const W* x0, const W* x1, const W* y0, const W* y1,
                      W* tmp, W* d0, W* d1, W* d2, int rows, int C, int logN,
                      const W* q, const W* k, const W* psi, const W* Rs,
                      void* stream) {
    const Geo g = make_geo(logN);
    cudaStream_t st = (cudaStream_t)stream;
    const size_t sm1 = (size_t)g.N1 * g.TC * sizeof(W);
    const size_t plane = (size_t)rows << logN;
    dim3 g1(g.N2 / g.TC, rows), g2(g.N1, rows);
    const W* in[4] = {x0, x1, y0, y1};
    for (int i = 0; i < 4; ++i) {
        fwd_pass1<W, true><<<g1, TT_THREADS, sm1, st>>>(
            in[i], tmp + i * plane, g, C, 0, 0, q, k, psi, Rs);
        TT_CHECK();
    }
    tensor_pass2<W><<<g2, contig_threads(g), 4 * g.N2 * sizeof(W), st>>>(
        tmp, d0, d1, d2, g, rows, C, q, k, psi);
    TT_CHECK();
    return 0;
}

extern "C" int tt_ntt_tensor(const i64* x0, const i64* x1, const i64* y0,
                             const i64* y1, i64* tmp, i64* d0, i64* d1,
                             i64* d2, int rows, int C, int logN,
                             const i64* q, const i64* k, const i64* psi,
                             const i64* Rs, void* stream) {
    return ntt_tensor(x0, x1, y0, y1, tmp, d0, d1, d2, rows, C, logN, q, k,
                      psi, Rs, stream);
}

extern "C" int tt_ntt_tensor_30(const i32* x0, const i32* x1, const i32* y0,
                                const i32* y1, i32* tmp, i32* d0, i32* d1,
                                i32* d2, int rows, int C, int logN,
                                const i32* q, const i32* k, const i32* psi,
                                const i32* Rs, void* stream) {
    return ntt_tensor(x0, x1, y0, y1, tmp, d0, d1, d2, rows, C, logN, q, k,
                      psi, Rs, stream);
}
