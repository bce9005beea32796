// The engine's stacked linear op (CkksEngine.mult_matrix) as one kernel:
// a modular matrix product over a stack of ciphertexts,
//
//   out[p][j][c][n] = (acc[p][j][c][n] +) sum_i W[i][j] x[p][i][c][n]  mod q_c
//
// for both polynomials p of F_in input ciphertexts x [F_in, C, N] (rows N
// words apart, one feature stride) and F_out outputs [F_out, C, N]
// (contiguous), with one signed integer weight W[i][j] for every channel
// (the mult_scalar encoding of a real weight).  With features as
// ciphertexts and tokens in the slots, a linear layer is this product and
// needs no rotation and no key.
//
// It replaces no TPU kernel: the JAX package has no such op.  The engine
// ran it, one output at a time, as a per-row product by a column, a tree
// of additions and a rescale: tens of GB of traffic an output.
//
// What bounds it: products, F_in F_out 2 N C of them, each of a residue
// of up to 60 bits by a weight of about 40.  Bytes are few by comparison
// (the inputs and outputs once, the weights from L2).  The products run
// exactly on the int8 tensor cores (mma.sync m16n8k32, signed weight bytes
// by unsigned residue bytes, int32 sums):
//
//   * a residue x < q of channel c is its own XL_c low bytes, XL_c =
//     ceil(bit_length(q_c) / 8) (5 at 40 bits, 6 at 41, 8 at 60; at most
//     4 in the 30-bit lane), read from q_c in the block; a weight is L
//     balanced signed bytes, each in [-128, 127] (the host splits the
//     weights once, ops/matmul.py; L = 8 holds any weight below 2^62);
//   * byte a of x times byte b of W lands in the int32 sum of shift class
//     s = a + b: XL + L - 1 sums a word, not XL L.  A class takes at most
//     min(XL, L) <= L products a feature, each below 255 128 = 32,640 in
//     magnitude, so its sum stays below 2^31 for K up to ops/matmul.py's
//     matmul_run (13,158 features at L = 5, 8,224 at L = 8); the wrapper
//     splits a longer sum into runs, each run's output the next one's
//     accumulator;
//   * each output word reduces once its run is complete: classes 0..11,
//     shifted and added (four at a time in a 64-bit word by multiply-adds,
//     then the three words and the accumulator's word as one signed
//     128-bit integer, below 2^31 2^88 256/255 < 2^120 in magnitude), go
//     through mont.cuh's redc_sum_signed (the fold by 2^64 mod q and one
//     REDC: |hi| < 2^56, inside its 2^62); classes 12..14 (XL + L >= 14:
//     the 60-bit base at L >= 6, which would reach 2^143) sum into one
//     64-bit word h = sum T_s 2^(8 (s - 12)) (below 2^48) that goes in at
//     2^96 through a REDC by 2^96 mod q (h 2^96 2^-62); one REDC by 2^124
//     mod q of the total takes the 2^-62 back out (62-bit lane).  The
//     30-bit lane sums the classes by Horner's rule in 64-bit integers,
//     taken mod q every fourth class.
//
// Output canonical in [0, q), byte for byte ops/matmul.py's plain version.
//
// Tiling: a block of 256 threads (8 warps) owns 64 outputs by 32
// coefficients of one channel of one polynomial and walks the input
// features 64 at a time (a stage: two MMA steps of 32).  A warp owns 16
// outputs by 16 coefficients (two m16n8 tiles) and keeps XM + L - 1 class
// sums of each (XM = 8, or 4 in the 30-bit lane): 96 int32 registers a
// thread at L = 5.  That, not shared memory, sets the tile: the 60-bit
// base needs 12 classes, and a wider warp tile would spill them.  Each
// stage, every thread loads eight words of x (four features at one
// coefficient, twice; a warp reads 256 contiguous bytes a feature) and
// one 16-byte piece of each weight limb's row (the weights F_in fastest)
// into registers for the next stage while the block works on the current
// one from shared memory: x as XL planes of 32-bit words, four features'
// byte a at one coefficient (the B fragment's order, [a][16][32 + 8
// pad]); the weights as [L][64][16 + 4 pad] words (the A fragment's).
// The pads keep the fragments' reads free of bank conflicts.  Per MMA
// step a warp reads L A fragments and, per residue byte, two B
// fragments, and issues 2 L XL MMAs.  Shared memory: (XM 16 40 + L 64
// 20) 4 bytes, 46,080 at L = 5.  The blocks of one column tile run next
// to each other (the output tile varies fastest), so x is read from
// device memory about once and the weights (int8, 5 bytes a weight at L
// = 5) stay in L2.
//
// What bounds the design on this card is issue, not bytes: 208 registers
// a thread at L = 5 allow one block of 8 warps an SM, and the warps run
// the MMA steps, the stage's loads and byte planes, and the epilogue in
// turn.  Taken apart at the up block's shape (768 -> 512 at level 0, 46
// ms a call): the MMA steps alone (mma.sync with the fragments' shared-
// memory reads, about 100 bytes an MMA) take 27 ms, 43% of the int8
// rate; the epilogue (about 200 instructions a word) 3 ms; the stage's
// loads and planes the rest, which overlaps the MMAs little.  Loads that
// hit L1 instead of L2, weights copied by cp.async, a second stage
// buffer, L2 prefetches and two blocks of 4 warps an SM each gained
// nothing or lost; the next step is warp specialisation (producer warps
// staging through setmaxnreg) or wgmma.
//
// Two lanes: tt_matmul (62-bit, i64 words) and tt_matmul_30 (30-bit, i32);
// the build compiles this file once per lane (TT_LANE).  The host build of
// the tests (TT_HOST) runs a plain C++ model of the MMA.
#include "ntt.cuh"

#define TT_MM_T 256     // threads a block: 8 warps, 4 along j, 2 along n
#define TT_MM_TJ 64     // outputs a block
#define TT_MM_TN 32     // coefficients a block
#define TT_MM_TK 64     // input features a stage
#define TT_MM_NI 2      // m16n8 tiles a warp, along n
#define TT_MM_L 8       // most bytes of a weight
#define TT_MM_MAIN 12   // classes summed into the 128-bit word
#define TT_MM_XP (TT_MM_TN + 8)       // words a row of an x plane
#define TT_MM_WP (TT_MM_TK / 4 + 4)   // words a row of a weight limb

#if TT_HOST
// The host build's model of one warp's mma.sync: the lanes leave their
// fragments in shared memory, then each sums its four outputs from them.
static u32 tt_mma_a[TT_MM_T / 32][32][4], tt_mma_b[TT_MM_T / 32][32][2];
#endif

// d += A B on one warp's m16n8k32 tile, in PTX's fragment layout for lane
// 4 g + t: A (16 x 32 signed bytes, rows j) a[0] row g bytes 4t..4t+3,
// a[1] row g + 8, a[2] and a[3] the same at byte 16 + 4t; B (32 x 8
// unsigned bytes, columns n) b[0] column g rows 4t..4t+3, b[1] rows 16 +
// 4t..; d[0], d[1] row g columns 2t, 2t + 1, d[2], d[3] row g + 8.
__device__ __forceinline__ void mm_mma(int* d, const u32* a, const u32* b) {
#if TT_HOST
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    for (int i = 0; i < 4; ++i) tt_mma_a[w][l][i] = a[i];
    for (int i = 0; i < 2; ++i) tt_mma_b[w][l][i] = b[i];
    __syncwarp();
    const int g = l / 4, t = l % 4;
    for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i / 2), n = 2 * t + i % 2;
        int s = 0;
        for (int kk = 0; kk < 32; ++kk) {
            const int h = kk / 16, u = kk % 16 / 4, by = 8 * (kk % 4);
            s += (signed char)(tt_mma_a[w][4 * (r % 8) + u][r / 8 + 2 * h] >>
                               by) *
                 (unsigned char)(tt_mma_b[w][4 * n + u][h] >> by);
        }
        d[i] += s;
    }
    __syncwarp();
#else
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// byte a of four words, as one word: byte e from word e
template <typename W>
__device__ __forceinline__ u32 mm_plane(const W* v, int a) {
    typedef typename Lane<W>::U U;
    u32 w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = (u32)((u64)(U)v[e] >> (32 * (a / 4)));
    const u32 s = (u32)(a % 4) | (u32)(a % 4 + 4) << 4;
    return __byte_perm(__byte_perm(w[0], w[1], s), __byte_perm(w[2], w[3], s),
                       0x5410);
}

// the NS class sums of one output word, plus acc (in [0, q)), mod q
template <typename W, int NS>
struct MmReduce;

template <int NS>
struct MmReduce<i64, NS> {
    static __device__ __forceinline__ i64 run(const int* s, i64 acc, i64 q,
                                              i64 k, i64 f, i64 r2,
                                              i64 c96) {
        // three words of four classes each (below 2^55 in magnitude, a
        // multiply-add a class), then one 128-bit sum
        constexpr int M = NS < TT_MM_MAIN ? NS : TT_MM_MAIN;
        i64 g[3] = {0, 0, 0};
#pragma unroll
        for (int i = 0; i < M; ++i)
            g[i / 4] += (i64)s[i] * (1LL << (8 * (i % 4)));
        const u128 t = (u128)((__int128)g[0] + ((__int128)g[1] << 32) +
                              ((__int128)g[2] << 64) + acc);
        i64 v = redc_sum_signed(t, (u64)f, (u64)q, (u64)k);   // (-q, 2q)
        if constexpr (NS > TT_MM_MAIN) {
            i64 h = s[NS - 1];
#pragma unroll
            for (int i = NS - 2; i >= TT_MM_MAIN; --i) h = h * 256 + s[i];
            v += redc_by(h, c96, (u64)q, (u64)k);   // h 2^34: (-q, 2q)
        }
        return canon(redc_by(v, r2, (u64)q, (u64)k), q);
    }
};

template <int NS>
struct MmReduce<i32, NS> {
    static __device__ __forceinline__ i32 run(const int* s, i32 acc, i32 q,
                                              i32, i32, i32, i32) {
        // |h| < 2^28 after each reduction, below 2^61 four classes later
        const long long m = q;
        long long h = 0;
#pragma unroll
        for (int i = NS - 1; i >= 0; --i) {
            h = h * 256 + s[i];
            if (i % 4 == 0) h %= m;
        }
        h = (h + acc) % m;
        return (i32)(h < 0 ? h + m : h);
    }
};

struct MmArgs {
    long long x_fs, w_ls, w_rs;
    int F_in, F_out, C, N, tiles_j, tiles_n, wvec;
};

template <typename W, int L>
__device__ __forceinline__ void mm_body(const W* __restrict__ x,
                                        const signed char* __restrict__ wl,
                                        const W* acc, W* out, const MmArgs a,
                                        int c, int j0, int n0, W q, W k, W f,
                                        W r2) {
    typedef typename Lane<W>::U U;
    constexpr int XM = (int)sizeof(W);   // most bytes of a residue
    constexpr int NS = XM + L - 1;       // shift classes
    constexpr int KW = TT_MM_TK / 4;     // words a row of a stage
    u32* xs = smem<u32>();                          // [XM][KW][XP]
    u32* ws = xs + XM * KW * TT_MM_XP;              // [L][TJ][WP]
    int xl = 1;                                     // bytes of this channel
    while (xl < XM && ((u64)(U)q >> (8 * xl)) != 0) ++xl;
    W c96 = 0;                                      // 2^96 mod q
    if constexpr (NS > TT_MM_MAIN)
        c96 = canon(redc_by((W)1 << 34, r2, (u64)q, (u64)k), q);

    // XR rows of four features of x a pass, XH passes a stage; a weight
    // row in TK / 16 pieces of 16 bytes, one a thread
    constexpr int WJ = TT_MM_TJ / 16, XR = TT_MM_T / TT_MM_TN,
                  XH = KW / XR, WQ = TT_MM_TK / 16;
    static_assert(TT_MM_T == 32 * WJ * (TT_MM_TN / 16) &&
                  TT_MM_T == TT_MM_TJ * WQ && KW % XR == 0);
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int g = lane / 4, tg = lane % 4;
    const int wj = 16 * (warp % WJ), wn = 16 * (warp / WJ);
    // the stage's loads: x at coefficient t % TN, rows of four features
    // t / TN + XR h; weights row t / WQ, 16 bytes at 16 (t % WQ)
    const int sn = t % TT_MM_TN, sk = t / TT_MM_TN, sr = t / WQ, sq = t % WQ;
    const W* xg = x + (size_t)c * a.N + n0 + sn;
    const bool wrow = j0 + sr < a.F_out;
    const signed char* wg = wl + (long long)(j0 + sr) * a.w_rs + 16 * sq;

    W xv[XH][4];
    uint4 wv[L];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int h = 0; h < XH; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kk = k0 + 4 * (sk + XR * h) + e;
                xv[h][e] = kk < a.F_in ? xg[kk * a.x_fs] : (W)0;
            }
        const int kb = k0 + 16 * sq;
#pragma unroll
        for (int b = 0; b < L; ++b) {
            const signed char* p = wg + b * a.w_ls + k0;
            uint4 v = {0, 0, 0, 0};
            if (wrow && kb < a.F_in) {
                if (a.wvec) {
                    v = *reinterpret_cast<const uint4*>(p);
                } else {
                    u32 u[4] = {0, 0, 0, 0};
#pragma unroll
                    for (int e = 0; e < 16; ++e)
                        if (kb + e < a.F_in)
                            u[e / 4] |= (u32)(unsigned char)p[e]
                                        << (8 * (e % 4));
                    v = {u[0], u[1], u[2], u[3]};
                }
            }
            wv[b] = v;
        }
    };

    int s[NS][TT_MM_NI][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int m = 0; m < TT_MM_NI; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][m][e] = 0;

    auto stage = [&]() {
#pragma unroll
        for (int h = 0; h < XH; ++h)
#pragma unroll
            for (int b = 0; b < XM; ++b)
                if (b < xl)
                    xs[(b * KW + sk + XR * h) * TT_MM_XP + sn] =
                        mm_plane<W>(xv[h], b);
#pragma unroll
        for (int b = 0; b < L; ++b)
            *reinterpret_cast<uint4*>(
                ws + ((b * TT_MM_TJ + sr) * TT_MM_WP + 4 * sq)) = wv[b];
    };

    fetch(0);
    for (int k0 = 0; k0 < a.F_in; k0 += TT_MM_TK) {
        __syncthreads();   // the last stage's reads are done
        stage();
        __syncthreads();
        if (k0 + TT_MM_TK < a.F_in) fetch(k0 + TT_MM_TK);
#pragma unroll
        for (int ks = 0; ks < TT_MM_TK / 32; ++ks) {
            u32 af[L][4];
#pragma unroll
            for (int b = 0; b < L; ++b) {
                const u32* r =
                    ws + (b * TT_MM_TJ + wj + g) * TT_MM_WP + 8 * ks + tg;
                af[b][0] = r[0];
                af[b][1] = r[8 * TT_MM_WP];
                af[b][2] = r[4];
                af[b][3] = r[8 * TT_MM_WP + 4];
            }
#pragma unroll
            for (int xa = 0; xa < XM; ++xa) {
                if (xa >= xl) break;
                u32 bf[TT_MM_NI][2];
#pragma unroll
                for (int m = 0; m < TT_MM_NI; ++m) {
                    const u32* r = xs + (xa * KW + 8 * ks + tg) * TT_MM_XP +
                                   wn + 8 * m + g;
                    bf[m][0] = r[0];
                    bf[m][1] = r[4 * TT_MM_XP];
                }
#pragma unroll
                for (int b = 0; b < L; ++b)
#pragma unroll
                    for (int m = 0; m < TT_MM_NI; ++m)
                        mm_mma(s[xa + b][m], af[b], bf[m]);
            }
        }
    }

#pragma unroll
    for (int m = 0; m < TT_MM_NI; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int j = j0 + wj + g + 8 * (e / 2);
            if (j >= a.F_out) continue;
            const size_t o = ((size_t)j * a.C + c) * a.N + n0 + wn + 8 * m +
                             2 * tg + e % 2;
            int v[NS];
#pragma unroll
            for (int i = 0; i < NS; ++i) v[i] = s[i][m][e];
            out[o] = MmReduce<W, NS>::run(v, acc ? acc[o] : (W)0, q, k, f, r2,
                                          c96);
        }
}

// grid (tiles_j * C * tiles_n, 2): block b owns output tile b % tiles_j
// of column tile b / tiles_j (channel, then coefficients) of polynomial
// blockIdx.y.  acc may be null or out itself (each word is read before
// the same thread writes it).
template <typename W, int L>
__global__ void __launch_bounds__(TT_MM_T, 1)
matmul_k(const W* __restrict__ x0, const W* __restrict__ x1,
         const signed char* __restrict__ wl, const W* acc0, const W* acc1,
         W* out0, W* out1, const MmArgs a, const W* __restrict__ qv,
         const W* __restrict__ kv, const W* __restrict__ fv,
         const W* __restrict__ rv) {
    const long long b = blockIdx.x;
    const int jt = (int)(b % a.tiles_j);
    const long long col = b / a.tiles_j;
    const int c = (int)(col / a.tiles_n);
    const int n0 = (int)(col % a.tiles_n) * TT_MM_TN;
    const bool p1 = blockIdx.y != 0;
    mm_body<W, L>(p1 ? x1 : x0, wl, p1 ? acc1 : acc0, p1 ? out1 : out0, a,
                  c, jt * TT_MM_TJ, n0, qv[c], kv[c], fv[c], rv[c]);
}

template <typename W, int L>
static int mm_launch(dim3 grid, void* stream, const W* x0, const W* x1,
                     const signed char* wl, const W* acc0, const W* acc1,
                     W* out0, W* out1, const MmArgs& a, const W* q,
                     const W* k, const W* f, const W* r2) {
    const int sm = ((int)sizeof(W) * (TT_MM_TK / 4) * TT_MM_XP +
                    L * TT_MM_TJ * TT_MM_WP) * (int)sizeof(u32);
    if (!allow_smem(matmul_k<W, L>, sm)) return (int)cudaErrorInvalidValue;
    matmul_k<W, L><<<grid, TT_MM_T, sm, (cudaStream_t)stream>>>(
        x0, x1, wl, acc0, acc1, out0, out1, a, q, k, f, r2);
    TT_CHECK();
    return 0;
}

// x0, x1 [F_in, C, N] (feature stride x_fs, rows N apart); wl [L][F_out]
// [F_in] signed bytes, byte b of weight (i, j) at wl + b w_ls + j w_rs + i;
// acc0, acc1 null or [F_out, C, N]; out0, out1 [F_out, C, N]; q, k, f
// (2^64 mod q), r2 (2^124 mod q): [C].
template <typename W>
static int matmul(const W* x0, const W* x1, long long x_fs,
                  const signed char* wl, long long w_ls, long long w_rs,
                  int L, int F_in, int F_out, const W* acc0, const W* acc1,
                  W* out0, W* out1, int C, int N, const W* q, const W* k,
                  const W* f, const W* r2, void* stream) {
    if (F_in < 1 || F_out < 1 || C < 1 || N < TT_MM_TN || N % TT_MM_TN ||
        L < 1 || L > TT_MM_L || w_rs < F_in ||
        (acc0 == nullptr) != (acc1 == nullptr))
        return (int)cudaErrorInvalidValue;
    MmArgs a;
    a.x_fs = x_fs;
    a.w_ls = w_ls;
    a.w_rs = w_rs;
    a.F_in = F_in;
    a.F_out = F_out;
    a.C = C;
    a.N = N;
    a.tiles_j = (F_out + TT_MM_TJ - 1) / TT_MM_TJ;
    a.tiles_n = N / TT_MM_TN;
    // 16-byte loads of the weights where every row's start is aligned
    a.wvec = ((unsigned long long)(size_t)wl | (unsigned long long)w_ls |
              (unsigned long long)w_rs) % 16 == 0;
    const long long blocks = (long long)a.tiles_j * C * a.tiles_n;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks, 2);
    switch (L) {
#define TT_MM_CASE(LL)                                                      \
    case LL:                                                                \
        return mm_launch<W, LL>(grid, stream, x0, x1, wl, acc0, acc1, out0, \
                                out1, a, q, k, f, r2);
        TT_MM_CASE(1)
        TT_MM_CASE(2)
        TT_MM_CASE(3)
        TT_MM_CASE(4)
        TT_MM_CASE(5)
        TT_MM_CASE(6)
        TT_MM_CASE(7)
        TT_MM_CASE(8)
#undef TT_MM_CASE
    }
    return (int)cudaErrorInvalidValue;
}

#define TT_MATMUL_ENTRY(SFX, W)                                              \
    extern "C" int tt_matmul##SFX(                                           \
        const W* x0, const W* x1, long long x_fs, const signed char* wl,     \
        long long w_ls, long long w_rs, int L, int F_in, int F_out,          \
        const W* acc0, const W* acc1, W* out0, W* out1, int C, int N,        \
        const W* q, const W* k, const W* f, const W* r2, void* stream) {     \
        return matmul(x0, x1, x_fs, wl, w_ls, w_rs, L, F_in, F_out, acc0,    \
                      acc1, out0, out1, C, N, q, k, f, r2, stream);          \
    }

#if TT_I64
TT_MATMUL_ENTRY(, i64)
#endif

#if TT_I32
TT_MATMUL_ENTRY(_30, i32)
#endif
