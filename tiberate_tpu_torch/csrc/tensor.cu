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
// What bounds it on the H100: the same 64-bit REDC butterflies as ntt.cu
// (integer multiply throughput), plus 4 REDCs per coefficient for the
// products.  Shared memory per pass-2 block is 4 x N2 x 8 B (8 KB at
// logN15), so many blocks stay resident per SM.
#include <cuda_runtime.h>

#include "ntt.cuh"

__global__ void tensor_pass2(const i64* __restrict__ tmp,
                             i64* __restrict__ d0, i64* __restrict__ d1,
                             i64* __restrict__ d2, Geo g, int rows, int C,
                             const i64* __restrict__ qv,
                             const i64* __restrict__ kv,
                             const i64* __restrict__ psi) {
    extern __shared__ i64 s[];
    const int row = blockIdx.y;
    const int c = row % C;
    const int j1 = blockIdx.x;
    const u64 q = (u64)qv[c], k = (u64)kv[c];
    const size_t off = ((size_t)row << g.logN) + ((size_t)j1 << g.L2);
    const size_t plane = (size_t)rows << g.logN;
    for (int i = 0; i < 4; ++i)
        for (int e = threadIdx.x; e < g.N2; e += blockDim.x)
            s[i * g.N2 + e] = tmp[i * plane + off + e];
    __syncthreads();
    const i64* tw = psi + ((size_t)c << g.logN);
    for (int i = 0; i < 4; ++i) fwd_contig(s + i * g.N2, g, j1, tw, q, k);
    const i64 q2 = (i64)(q << 1);
    for (int e = threadIdx.x; e < g.N2; e += blockDim.x) {
        const i64 X0 = s[e], X1 = s[g.N2 + e];
        const i64 Y0 = s[2 * g.N2 + e], Y1 = s[3 * g.N2 + e];
        d0[off + e] = redc(X0, Y0, q, k);
        d1[off + e] = lazy_add(redc(X0, Y1, q, k), redc(X1, Y0, q, k), q2);
        d2[off + e] = redc(X1, Y1, q, k);
    }
}

// x0, x1, y0, y1, d0, d1, d2: [rows, N]; tmp: [4, rows, N] scratch.
extern "C" int tt_ntt_tensor(const i64* x0, const i64* x1, const i64* y0,
                             const i64* y1, i64* tmp, i64* d0, i64* d1,
                             i64* d2, int rows, int C, int logN,
                             const i64* q, const i64* k, const i64* psi,
                             const i64* Rs, void* stream) {
    const Geo g = make_geo(logN);
    cudaStream_t st = (cudaStream_t)stream;
    const size_t sm1 = (size_t)g.N1 * g.TC * sizeof(i64);
    const size_t plane = (size_t)rows << logN;
    dim3 g1(g.N2 / g.TC, rows), g2(g.N1, rows);
    const i64* in[4] = {x0, x1, y0, y1};
    for (int i = 0; i < 4; ++i) {
        fwd_pass1<true><<<g1, TT_THREADS, sm1, st>>>(in[i], tmp + i * plane,
                                                     g, C, 0, 0, q, k, psi,
                                                     Rs);
        TT_CHECK();
    }
    tensor_pass2<<<g2, contig_threads(g), 4 * g.N2 * sizeof(i64), st>>>(
        tmp, d0, d1, d2, g, rows, C, q, k, psi);
    TT_CHECK();
    return 0;
}
