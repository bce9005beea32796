// The ChaCha20 CSPRNG's device work (R1-R4): the RFC 7539 block function
// fused with each sampler and with the counter step.
//
// The JAX package runs the CSPRNG under jax.jit, which XLA fuses into a
// few kernels: tiberate_tpu/rng/chacha20.py:39-75 and tiberate_tpu/rng/
// csprng.py:79-128, :195-215.  The port's plain versions
// (rng/chacha20.py, rng/csprng.py) run it as torch ops on int64 words:
// about 630 launches a draw.  Each kernel here is one launch:
//
//   R1 words_k      replaces _chacha_and_step (csprng.py:195-199):
//                   the keystream words [rows, 16];
//   R2 randint_k    replaces _randint_from_words (:79-104): per 128-bit
//                   group of four words, (u128 q_c) >> 128 + shift, q_c
//                   the modulus of the row's channel (row / L);
//   R3 dgauss_k     replaces _dgauss_from_words (:106-125): CDT inversion
//                   of the 127-bit uniform over the expanded binary tree
//                   (depth DEPTH, a template parameter), the sign from bit
//                   0 of the high word;
//   R4 randround_k  replaces _randround_core (:201-215): f64 coefficients
//                   -> int64, sign (floor|c| + (w < rint(frac 2^32))),
//                   sixteen thresholds a row.
//
// One thread a base state row.  It loads the row's 16 words (eight 16-byte
// loads of the int64 row, each word below 2^32), runs the block function
// in uint32 registers (10 double rounds, __funnelshift_l rotations, the
// feed-forward add) once for each of B replicas, writes each replica's
// samples, and last writes the row's stepped counter in place.
//
// Counter trajectories (struct Traj): replica k reads the row with its
// 64-bit counter (word 12 low, word 13 high) advanced by adv0 + k stride,
// one 32-bit add whose wrap carries into word 13, as step_counter(rows,
// k inc) does.  The wrappers (ops/csprng_kernels.py) keep every advance
// below 2^32, so the 32-bit product and sum are exact.  Rows from `split`
// on take stride1 and step1: encrypt_noise_batch's first repeating
// channel serves two draws a message, its second one.
//
// Where trouble lies, and what the design does about it:
//
// * Counters stepped in place while replicas read the same base rows.
//   The batch forms read each base row B times; a thread that wrote the
//   stepped counter while another still read the row would race.  So one
//   thread owns each base row, loops over the replicas, and writes the
//   stepped counter once, after its last read (randround_batch at logN15:
//   N/16 = 2048 threads of 8 replicas each).  encrypt_noise_batch's R2
//   reads the first repeating channel without writing it and is launched
//   before R3, which steps both channels; one stream orders them.
// * Exactness.  R2's carry chain is floor(x q / 2^128): with x = xh 2^64
//   + xl, that is the high word of q xh + umulhi(q, xl) (the dropped low
//   product adds less than one unit below bit 128), two __umul64hi and a
//   carry.  R3's compare is a native unsigned 128-bit compare, where the
//   plain version flips sign bits.  R4 is f64 arithmetic with explicit
//   round-to-nearest intrinsics (no contraction); __double2ll_rn rounds
//   half to even as torch.round does, and sign(+-0) = 0 survives.  The
//   unit is never built with --use_fast_math.
// * Word layouts.  A sample's words w0..w3 are bits 32-63, 0-31, 96-127
//   and 64-95 (_words_to_u128_parts); R4's thresholds are the words of
//   rows 0 .. N/16 in row-major order, coefficient 16 r + j against word j
//   of row r.
// * The CDT tree (2^DEPTH - 1 nodes of two 64-bit halves) lives in shared
//   memory: the threads of a warp walk to different nodes.
//
// What bounds them on the H100 (ops/roofline.py): bytes, narrowly.  A
// block is about a thousand 32-bit operations (20 rounds x 4 quarter
// rounds x 12, plus the feed-forward; 1100-1700 SASS instructions with the
// samples), which at 132 SMs x 4 warp issues a cycle take a little less
// time than a row's 144 bytes of state and 32 (R2, R3) or 128 (R1) bytes
// of samples at 3.35 TB/s; the batch forms, which read a row once for B
// replicas, are bound by issue.  Nothing is tuned: stores are 16-byte
// vectors, but neither the 128-byte row loads nor R1's and R4's 128-byte
// row stores are coalesced across the warp (each thread its own line).
#include <cuda_runtime.h>

#define TT_RNG_T 128       // threads a block, one base row each
#define TT_RNG_MAXDEPTH 8  // deepest CDT tree: 255 nodes

typedef unsigned int u32;
typedef unsigned long long u64;

#define TT_RNG_CHECK()                               \
    do {                                             \
        cudaError_t err_ = cudaGetLastError();       \
        if (err_ != cudaSuccess) return (int)err_;   \
    } while (0)

struct Traj {
    u32 adv0;     // replica k's advance: adv0 + k * stride (stride1 from
    u32 stride;   // row `split` on)
    u32 stride1;
    u32 step;     // the stored counters' advance (step1 from `split` on),
    u32 step1;    // written after the last replica when `write` is set
    int split;
    int B;
    int write;
};

__device__ __forceinline__ u32 rotl(u32 x, int n) {
    return __funnelshift_l(x, x, n);
}

#define TT_QR(a, b, c, d)                   \
    a += b; d = rotl(d ^ a, 16);            \
    c += d; b = rotl(b ^ c, 12);            \
    a += b; d = rotl(d ^ a, 8);             \
    c += d; b = rotl(b ^ c, 7);

// The block of state s with its counter words replaced by (lo, hi).
__device__ __forceinline__ void chacha_block(const u32* s, u32 lo, u32 hi,
                                             u32* x) {
    u32 in[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) in[i] = s[i];
    in[12] = lo;
    in[13] = hi;
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = in[i];
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        TT_QR(x[0], x[4], x[8], x[12]);
        TT_QR(x[1], x[5], x[9], x[13]);
        TT_QR(x[2], x[6], x[10], x[14]);
        TT_QR(x[3], x[7], x[11], x[15]);
        TT_QR(x[0], x[5], x[10], x[15]);
        TT_QR(x[1], x[6], x[11], x[12]);
        TT_QR(x[2], x[7], x[8], x[13]);
        TT_QR(x[3], x[4], x[9], x[14]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] += in[i];
}

// The counter of s advanced by adv: low word + adv, its wrap into the high.
__device__ __forceinline__ void advance(const u32* s, u32 adv, u32& lo,
                                        u32& hi) {
    lo = s[12] + adv;
    hi = s[13] + (lo < s[12] ? 1u : 0u);
}

// Every replica of base row r: emit(k, x) gets replica k's keystream
// block; then the row's stepped counter is stored (words 12 and 13: one
// 16-byte store).
template <typename Emit>
__device__ __forceinline__ void replicas(long long* st, int r, const Traj& t,
                                         Emit emit) {
    longlong2* row = reinterpret_cast<longlong2*>(st + (size_t)r * 16);
    u32 s[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const longlong2 v = row[i];
        s[2 * i] = (u32)v.x;
        s[2 * i + 1] = (u32)v.y;
    }
    const bool upper = r >= t.split;
    const u32 stride = upper ? t.stride1 : t.stride;
    for (int k = 0; k < t.B; ++k) {
        u32 lo, hi, x[16];
        advance(s, t.adv0 + (u32)k * stride, lo, hi);
        chacha_block(s, lo, hi, x);
        emit(k, x);
    }
    if (t.write) {
        u32 lo, hi;
        advance(s, upper ? t.step1 : t.step, lo, hi);
        row[6] = make_longlong2((long long)lo, (long long)hi);
    }
}

// Four int64 samples: two 16-byte stores.
__device__ __forceinline__ void store4(long long* o, const long long* v) {
    longlong2* p = reinterpret_cast<longlong2*>(o);
    p[0] = make_longlong2(v[0], v[1]);
    p[1] = make_longlong2(v[2], v[3]);
}

__device__ __forceinline__ u64 low64(const u32* w) {   // bits 0-63
    return ((u64)w[0] << 32) | w[1];
}

__device__ __forceinline__ u64 high64(const u32* w) {  // bits 64-127
    return ((u64)w[2] << 32) | w[3];
}

// R1: out [rows, 16].
__global__ void __launch_bounds__(TT_RNG_T)
words_k(long long* st, int rows, Traj t, long long* __restrict__ out) {
    const int r = blockIdx.x * TT_RNG_T + threadIdx.x;
    if (r >= rows) return;
    replicas(st, r, t, [&](int, const u32* x) {
        longlong2* o = reinterpret_cast<longlong2*>(out + (size_t)r * 16);
#pragma unroll
        for (int i = 0; i < 8; ++i)
            o[i] = make_longlong2((long long)x[2 * i],
                                  (long long)x[2 * i + 1]);
    });
}

// R2: out [B, rows, 4]; q [rows / L], the modulus of each channel.
__global__ void __launch_bounds__(TT_RNG_T)
randint_k(long long* st, int rows, Traj t, int L,
          const long long* __restrict__ q, long long shift,
          long long* __restrict__ out) {
    const int r = blockIdx.x * TT_RNG_T + threadIdx.x;
    if (r >= rows) return;
    const u64 p = (u64)q[r / L];
    replicas(st, r, t, [&](int k, const u32* x) {
        long long v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const u64 xl = low64(x + 4 * i), xh = high64(x + 4 * i);
            const u64 lo = p * xh;
            const u64 sum = lo + __umul64hi(p, xl);
            v[i] = (long long)(__umul64hi(p, xh) + (sum < lo ? 1u : 0u)
                               + (u64)shift);
        }
        store4(out + ((size_t)k * rows + r) * 4, v);
    });
}

// R3: out [B, rows, 4]; the tree's low and high halves, 2^DEPTH - 1 nodes.
template <int DEPTH>
__global__ void __launch_bounds__(TT_RNG_T)
dgauss_k(long long* st, int rows, Traj t,
         const long long* __restrict__ tree_lo,
         const long long* __restrict__ tree_hi,
         long long* __restrict__ out) {
    constexpr int NODES = (1 << DEPTH) - 1;
    __shared__ u64 tl[NODES], th[NODES];
    for (int i = threadIdx.x; i < NODES; i += TT_RNG_T) {
        tl[i] = (u64)tree_lo[i];
        th[i] = (u64)tree_hi[i];
    }
    __syncthreads();
    const int r = blockIdx.x * TT_RNG_T + threadIdx.x;
    if (r >= rows) return;
    replicas(st, r, t, [&](int k, const u32* x) {
        long long v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const u64 xl = low64(x + 4 * i), h = high64(x + 4 * i);
            const u64 xh = h >> 1;
            int cur = 0, base = 0;
#pragma unroll
            for (int d = 0; d < DEPTH; ++d) {
                const int node = base + cur;
                const u64 nh = th[node];
                const int ge = xh > nh || (xh == nh && xl >= tl[node]);
                cur = 2 * cur + ge;
                base = 2 * base + 1;
            }
            v[i] = (h & 1) ? cur : -cur;
        }
        store4(out + ((size_t)k * rows + r) * 4, v);
    });
}

// R4: coef and out [B, rows * 16].
__global__ void __launch_bounds__(TT_RNG_T)
randround_k(long long* st, int rows, Traj t,
            const double* __restrict__ coef, long long* __restrict__ out) {
    const int r = blockIdx.x * TT_RNG_T + threadIdx.x;
    if (r >= rows) return;
    replicas(st, r, t, [&](int k, const u32* x) {
        const size_t base = ((size_t)k * rows + r) * 16;
        longlong2* o = reinterpret_cast<longlong2*>(out + base);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            long long v[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const double c = coef[base + 2 * i + j];
                const double a = fabs(c);
                const double whole = floor(a);
                const long long thr = __double2ll_rn(
                    __dmul_rn(__dsub_rn(a, whole), 4294967296.0));
                const double up = (long long)x[2 * i + j] < thr ? 1.0 : 0.0;
                const double sign = c > 0.0 ? 1.0 : (c < 0.0 ? -1.0 : 0.0);
                v[j] = __double2ll_rz(__dmul_rn(sign, __dadd_rn(whole, up)));
            }
            o[i] = make_longlong2(v[0], v[1]);
        }
    });
}

static Traj traj(int B, u32 adv0, u32 stride, u32 stride1, int split,
                 u32 step, u32 step1, int write) {
    Traj t;
    t.adv0 = adv0;
    t.stride = stride;
    t.stride1 = stride1;
    t.step = step;
    t.step1 = step1;
    t.split = split;
    t.B = B;
    t.write = write;
    return t;
}

static bool rng_grid_ok(int rows, int B) { return rows >= 1 && B >= 1; }

static dim3 rng_grid(int rows) {
    return dim3((rows + TT_RNG_T - 1) / TT_RNG_T);
}

extern "C" int tt_chacha_words(long long* st, int rows, unsigned step,
                               long long* out, void* stream) {
    if (!rng_grid_ok(rows, 1)) return (int)cudaErrorInvalidValue;
    words_k<<<rng_grid(rows), TT_RNG_T, 0, (cudaStream_t)stream>>>(
        st, rows, traj(1, 0, 0, 0, rows, step, step, 1), out);
    TT_RNG_CHECK();
    return 0;
}

extern "C" int tt_chacha_randint(long long* st, int rows, int B,
                                 unsigned adv0, unsigned stride,
                                 unsigned step, int write, int L,
                                 const long long* q, long long shift,
                                 long long* out, void* stream) {
    if (!rng_grid_ok(rows, B) || L < 1) return (int)cudaErrorInvalidValue;
    randint_k<<<rng_grid(rows), TT_RNG_T, 0, (cudaStream_t)stream>>>(
        st, rows, traj(B, adv0, stride, stride, rows, step, step, write), L,
        q, shift, out);
    TT_RNG_CHECK();
    return 0;
}

#define TT_DGAUSS_CASE(D)                                                  \
    case D:                                                                \
        dgauss_k<D><<<rng_grid(rows), TT_RNG_T, 0, (cudaStream_t)stream>>>( \
            st, rows, t, tree_lo, tree_hi, out);                           \
        break;

extern "C" int tt_chacha_dgauss(long long* st, int rows, int B,
                                unsigned stride, unsigned stride1, int split,
                                unsigned step, unsigned step1,
                                const long long* tree_lo,
                                const long long* tree_hi, int depth,
                                long long* out, void* stream) {
    if (!rng_grid_ok(rows, B)) return (int)cudaErrorInvalidValue;
    const Traj t = traj(B, 0, stride, stride1, split, step, step1, 1);
    switch (depth) {
        TT_DGAUSS_CASE(1)
        TT_DGAUSS_CASE(2)
        TT_DGAUSS_CASE(3)
        TT_DGAUSS_CASE(4)
        TT_DGAUSS_CASE(5)
        TT_DGAUSS_CASE(6)
        TT_DGAUSS_CASE(7)
        TT_DGAUSS_CASE(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
    TT_RNG_CHECK();
    return 0;
}

extern "C" int tt_chacha_randround(long long* st, int rows, int B,
                                   unsigned stride, unsigned step,
                                   const double* coef, long long* out,
                                   void* stream) {
    if (!rng_grid_ok(rows, B)) return (int)cudaErrorInvalidValue;
    randround_k<<<rng_grid(rows), TT_RNG_T, 0, (cudaStream_t)stream>>>(
        st, rows, traj(B, 0, stride, stride, rows, step, step, 1), coef,
        out);
    TT_RNG_CHECK();
    return 0;
}
