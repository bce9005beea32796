// The elementwise glue of the cc_mult step (G1-G3): rescale, keyswitch
// digits, and the special-row phase of the P-division; and the engine's
// lazy-modular elementwise ops (G4): add, subtract, product by a column.
//
// The TPU runs the step as one jax.jit (tiberate_tpu/parallel/sharded.py:
// 173-240), so XLA fuses this glue into a few fusions around the Pallas
// calls; it has no Pallas kernel of its own.  The port ran it eagerly, one
// aten kernel per torch op (ops/mont.py's mont_mult_raw alone is about 30
// int64 passes over the whole operand).  Each kernel here is one pass:
//
//   G1 rescale_k replaces _rescale_core (tiberate_tpu/engine/
//     ckks_engine.py:527-540): per kept row c and coefficient,
//       canon(REDC((row - rescaler) scale[c]) + [rescaler > round_at]);
//     grid (N / T, ceil(c / RR), B): a thread reads its coefficient's
//     rescaler once and walks RR rows;
//   G2 digits_k replaces _pre_extend (:236-262) for every part at once:
//     one thread per (batch, part, coefficient) loads the part's alpha
//     residues into registers, runs the Garner recurrence in the order of
//     _pre_extend and writes the part's amax rows of K6's operand st,
//     zeros past alpha;
//   G3 pdiv_p0_k replaces the special-row phase of _pdiv_fused
//     (:279-313): one thread per (batch, coefficient) holds the S special
//     rows in registers and replays the successive division on them,
//     writing the row each division subtracts, in division order.
//
// Every REDC is mont.cuh's redc_by(): a signed difference or digit by a
// constant of the program's tables (the rescale scales, Y, L and PiRs,
// each in [0, q)), exact for every value of the first operand.  The plain
// versions' half-word REDC (ops/mont.py) equals it while the operand stays
// below 2^62 (62-bit lane) or 2^30 (30-bit lane) in magnitude; the glue's
// operands are differences of canonical residues and the Garner digits'
// lazy sums, a few q at most (tests/test_torch_glue.py bounds them for
// every preset).  The lazy row sums of G2 and every difference are formed
// in the lane's unsigned type, so they wrap as torch's int64 / int32 ops
// do, bit for bit.
//
// Strides: each input is [B, rows, N] with contiguous coefficients, rows N
// words apart and one batch stride (a view of the caller's tensor: G1
// reads d[..., 0:1, :] and d[..., 1:, :] in place); outputs are
// contiguous.  The wrappers (ops/glue_kernels.py) refuse anything else.
//
// What bounds them on the H100 (ops/roofline.py, at the REDC rate the
// fold-rate probe measures): bytes.  G1 does one REDC per word it writes,
// G2 alpha (alpha - 1) / 2 per part and coefficient against 2 alpha words
// or fewer; G3's S (S - 1) / 2 against 2S words reaches the crossing only
// at S = 6 in the 62-bit lane.  Each thread's loads are coalesced 4- or
// 8-byte words, every word is read once and written once, and nothing
// goes through shared memory.
//
// G4 modew_k replaces three engine cores (tiberate_tpu_torch/engine/
// ckks_engine.py): _mont_scalar_core (reduce_2q(mont_mult(d, col))),
// _cc_add_core and _cc_sub_core (reduce_2q(mont_add / mont_sub(a, b))).
// It replaces no TPU kernel: the JAX package runs these ops inside its
// jitted code, where XLA fuses each into one loop; the port ran them as
// torch ops, about 46 passes over the operand for the product and 8 for
// an add.  Bytes bound it (one REDC at most per word), so its design is
// that of a copy: a thread moves 16-byte words (two i64 or four i32
// residues) where every operand's base, batch stride and row length
// allow, one word at a time otherwise; the grid is (coefficient blocks,
// rows, batch), so a block's channel constants (q, k and the column's
// value) are loaded once per thread; each input word is read once and
// each output word written once, and nothing goes through shared memory.
// The ops are the plain versions' selects, in the lane's wrapping
// arithmetic, so the output is theirs for every input of their contract
// (operands in [0, 2q) for add and sub; d and the column, constants of
// the program's tables, in [0, q) for the product): canonical in [0, q).
// The second operand may have batch stride 0 (one ciphertext against a
// stack), and the column one value per row ([C, 1], col_bs 0) or per row
// and batch element ([B, C, 1], col_bs C).
//
// Two lanes: tt_*(62-bit, i64 words) and tt_*_30 (30-bit, i32 words); the
// build compiles this file once per lane (TT_LANE).
#include "ntt.cuh"

#define TT_GLUE_T 256    // threads a block, along the coefficients
#define TT_GLUE_RR 8     // rows a rescale thread walks
#define TT_GLUE_MAXA 8   // most digits a keyswitch part has
#define TT_GLUE_MAXS 8   // most special primes
#define TT_MODEW_T 256   // G4's threads a block
#define TT_MODEW_ITEMS 2 // 16-byte (or one-word) accesses a thread makes
// G2's constants per part, words of W: lo, alpha, q[M], k[M], Y[M],
// L[M][M] (M = TT_GLUE_MAXA; ops/glue_kernels.py builds the table)
#define TT_GLUE_PART (2 + 3 * TT_GLUE_MAXA + TT_GLUE_MAXA * TT_GLUE_MAXA)

template <typename W>
__device__ __forceinline__ W wrap_add(W a, W b) {
    typedef typename Lane<W>::U U;
    return (W)((U)a + (U)b);
}

template <typename W>
__device__ __forceinline__ W wrap_sub(W a, W b) {
    typedef typename Lane<W>::U U;
    return (W)((U)a - (U)b);
}

template <typename W>
__global__ void __launch_bounds__(TT_GLUE_T)
rescale_k(const W* __restrict__ rows, long long rows_bs,
          const W* __restrict__ resc, long long resc_bs, W* __restrict__ out,
          int c, int N, const W* __restrict__ scale,
          const W* __restrict__ qv, const W* __restrict__ kv,
          long long round_at, int exact) {
    typedef typename Lane<W>::U U;
    const int n = blockIdx.x * TT_GLUE_T + threadIdx.x;
    if (n >= N) return;
    const int b = blockIdx.z;
    const int r0 = blockIdx.y * TT_GLUE_RR;
    const W r = resc[b * resc_bs + n];
    const W up = exact && (long long)r > round_at ? 1 : 0;
    const W* x = rows + b * rows_bs + (size_t)r0 * N + n;
    W* o = out + ((size_t)b * c + r0) * N + n;
    W v[TT_GLUE_RR];
#pragma unroll
    for (int i = 0; i < TT_GLUE_RR; ++i)
        if (r0 + i < c) v[i] = x[(size_t)i * N];
#pragma unroll
    for (int i = 0; i < TT_GLUE_RR; ++i) {
        const int ch = r0 + i;
        if (ch < c) {
            const W q = qv[ch];
            const W d =
                redc_by(wrap_sub(v[i], r), scale[ch], (U)q, (U)kv[ch]);
            o[(size_t)i * N] = canon(wrap_add(d, up), q);
        }
    }
}

template <typename W>
__global__ void __launch_bounds__(TT_GLUE_T)
digits_k(const W* __restrict__ a, long long a_bs, W* __restrict__ st,
         int n_parts, int amax, int N, const W* __restrict__ tab,
         int lo_base) {
    typedef typename Lane<W>::U U;
    constexpr int M = TT_GLUE_MAXA;
    const int n = blockIdx.x * TT_GLUE_T + threadIdx.x;
    if (n >= N) return;
    const int p = blockIdx.y, b = blockIdx.z;
    const W* t = tab + (size_t)p * TT_GLUE_PART;
    const int lo = (int)t[0] - lo_base, alpha = (int)t[1];
    const W* q = t + 2;
    const W* k = q + M;
    const W* Y = k + M;
    const W* L = Y + M;
    const W* x = a + b * a_bs + (size_t)lo * N + n;
    W v[M];
#pragma unroll
    for (int r = 0; r < M; ++r)
        if (r < alpha) v[r] = x[(size_t)r * N];
    // rows[r] starts as digit 0 and gathers the lazy sums of the digits
    // below it; rows[i + 1] becomes digit i + 1
    W rows[M];
#pragma unroll
    for (int r = 0; r < M; ++r) rows[r] = v[0];
#pragma unroll
    for (int i = 0; i + 1 < M; ++i) {
        if (i + 1 < alpha) {
            const W y = redc_by(wrap_sub(v[i + 1], rows[i + 1]), Y[i],
                                (U)q[i + 1], (U)k[i + 1]);
            rows[i + 1] = y;
#pragma unroll
            for (int r = i + 2; r < M; ++r)
                if (r < alpha)
                    rows[r] = wrap_add(
                        rows[r],
                        redc_by(y, L[i * M + r], (U)q[r], (U)k[r]));
        }
    }
    W* o = st + ((size_t)b * n_parts + p) * amax * N + n;
#pragma unroll
    for (int r = 0; r < M; ++r)
        if (r < amax) o[(size_t)r * N] = r < alpha ? rows[r] : (W)0;
}

// The S - 1 columns PiRs[i][C:] of the division, by value.
template <typename W>
struct PiCols {
    const W* c[TT_GLUE_MAXS];
};

template <typename W>
__global__ void __launch_bounds__(TT_GLUE_T)
pdiv_p0_k(const W* __restrict__ cur, long long cur_bs, W* __restrict__ p0,
          int S, int N, PiCols<W> pi, const W* __restrict__ qv,
          const W* __restrict__ kv) {
    typedef typename Lane<W>::U U;
    constexpr int M = TT_GLUE_MAXS;
    const int n = blockIdx.x * TT_GLUE_T + threadIdx.x;
    if (n >= N) return;
    const int b = blockIdx.y;
    const W* x = cur + b * cur_bs + n;
    W v[M], q[M], k[M];
#pragma unroll
    for (int j = 0; j < M; ++j)
        if (j < S) {
            v[j] = x[(size_t)j * N];
            q[j] = qv[j];
            k[j] = kv[j];
        }
    W* o = p0 + (size_t)b * S * N + n;
#pragma unroll
    for (int i = 0; i < M; ++i) {
        if (i < S) {
            // division i subtracts row S - 1 - i; only the rows below it
            // are read again
            const int top = S - 1 - i;
            W r = 0;
#pragma unroll
            for (int j = 0; j < M; ++j)
                if (j == top) r = v[j];
            o[(size_t)i * N] = r;
#pragma unroll
            for (int j = 0; j < M; ++j)
                if (j < top)
                    v[j] = redc_by(tile_sub(v[j], r, (W)(2 * q[j])),
                                   pi.c[i][j], (U)q[j], (U)k[j]);
        }
    }
}

// G4's ops
enum { TT_MONT_SCALAR = 0, TT_MOD_ADD = 1, TT_MOD_SUB = 2 };

// 16 bytes of a lane's words, as one vector access
template <typename W> struct Vec16;
template <> struct Vec16<i64> { typedef longlong2 T; };
template <> struct Vec16<i32> { typedef int4 T; };

template <typename W, int V> struct Words {
    typedef typename Vec16<W>::T T;
    union {
        T v;
        W w[16 / sizeof(W)];
    } u;
    __device__ __forceinline__ void load(const W* p) {
        if (V == 1)
            u.w[0] = *p;
        else
            u.v = *reinterpret_cast<const T*>(p);
    }
    __device__ __forceinline__ void store(W* p) const {
        if (V == 1)
            *p = u.w[0];
        else
            *reinterpret_cast<T*>(p) = u.v;
    }
};

// [0, 2q) -> [0, q): ops/mont.py's reduce_2q
template <typename W>
__device__ __forceinline__ W reduce_2q(W a, W q) {
    return a < q ? a : a - q;
}

// a [B, rows, N] (batch stride a_bs), b likewise (b_bs, 0 for one operand
// against the batch; unread by the product) -> out [B, rows, N]; V words a
// vector access (16 / sizeof(W), or 1), N a multiple of V.
template <typename W, int OP, int V>
__global__ void __launch_bounds__(TT_MODEW_T)
modew_k(const W* __restrict__ a, long long a_bs, const W* __restrict__ b,
        long long b_bs, W* __restrict__ out, int N,
        const W* __restrict__ col, long long col_bs,
        const W* __restrict__ qv, const W* __restrict__ kv) {
    typedef typename Lane<W>::U U;
    const int r = blockIdx.y, bz = blockIdx.z;
    const W q = qv[r];
    const W q2 = wrap_add(q, q);
    W c = 0;
    U k = 0;
    if (OP == TT_MONT_SCALAR) {
        c = col[bz * col_bs + r];
        k = (U)kv[r];
    }
    const W* x = a + bz * a_bs + (size_t)r * N;
    const W* y = b + bz * b_bs + (size_t)r * N;
    W* o = out + ((size_t)bz * gridDim.y + r) * N;
    const int n0 = (blockIdx.x * TT_MODEW_ITEMS * TT_MODEW_T + threadIdx.x) * V;
#pragma unroll
    for (int it = 0; it < TT_MODEW_ITEMS; ++it) {
        const int n = n0 + it * TT_MODEW_T * V;
        if (n < N) {
            Words<W, V> s, t;
            s.load(x + n);
            if (OP != TT_MONT_SCALAR) t.load(y + n);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                W v;
                if (OP == TT_MONT_SCALAR) {
                    v = redc_by(s.u.w[i], c, (U)q, k);
                } else {
                    v = OP == TT_MOD_ADD
                            ? wrap_add(s.u.w[i], t.u.w[i])
                            : wrap_sub(wrap_add(s.u.w[i], q2), t.u.w[i]);
                    v = v < q2 ? v : wrap_sub(v, q2);
                }
                s.u.w[i] = reduce_2q(v, q);
            }
            s.store(o + n);
        }
    }
}

static bool glue_grid_ok(int B, int ys, int N) {
    return B >= 1 && B <= 65535 && ys >= 1 && ys <= 65535 && N >= 1;
}

#define TT_GLUE_GRID(ys) dim3((N + TT_GLUE_T - 1) / TT_GLUE_T, (ys), B)

// rows [B, c, N] (batch stride rows_bs), rescaler [B, 1, N] (resc_bs) ->
// out [B, c, N]; scale, q, k: [c].
template <typename W>
static int rescale(const W* rows, long long rows_bs, const W* resc,
                   long long resc_bs, W* out, int B, int c, int N,
                   const W* scale, const W* q, const W* k, long long round_at,
                   int exact, void* stream) {
    const int ys = (c + TT_GLUE_RR - 1) / TT_GLUE_RR;
    if (c < 1 || !glue_grid_ok(B, ys, N)) return (int)cudaErrorInvalidValue;
    rescale_k<W><<<TT_GLUE_GRID(ys), TT_GLUE_T, 0, (cudaStream_t)stream>>>(
        rows, rows_bs, resc, resc_bs, out, c, N, scale, q, k, round_at,
        exact);
    TT_CHECK();
    return 0;
}

// a [B, C, N] (batch stride a_bs) -> st [B, n_parts, amax, N]; tab:
// [n_parts, TT_GLUE_PART], each part's lo counted from row lo_base of a.
template <typename W>
static int parts_digits(const W* a, long long a_bs, W* st, int B,
                        int n_parts, int amax, int N, const W* tab,
                        int lo_base, void* stream) {
    if (amax < 1 || amax > TT_GLUE_MAXA || !glue_grid_ok(B, n_parts, N))
        return (int)cudaErrorInvalidValue;
    digits_k<W><<<TT_GLUE_GRID(n_parts), TT_GLUE_T, 0,
                  (cudaStream_t)stream>>>(a, a_bs, st, n_parts, amax, N,
                                          tab, lo_base);
    TT_CHECK();
    return 0;
}

// cur [B, S, N] (batch stride cur_bs) -> p0 [B, S, N]; pi: a host array
// of the S - 1 device pointers PiRs[i][C:] ([S] words each); q, k: [S].
template <typename W>
static int pdiv_p0(const W* cur, long long cur_bs, W* p0, int B, int S,
                   int N, const unsigned long long* pi, const W* q,
                   const W* k, void* stream) {
    if (S < 1 || S > TT_GLUE_MAXS || !glue_grid_ok(B, 1, N))
        return (int)cudaErrorInvalidValue;
    PiCols<W> cols = {};
    for (int i = 0; i + 1 < S; ++i) cols.c[i] = (const W*)pi[i];
    pdiv_p0_k<W><<<dim3((N + TT_GLUE_T - 1) / TT_GLUE_T, B), TT_GLUE_T, 0,
                   (cudaStream_t)stream>>>(cur, cur_bs, p0, S, N, cols, q,
                                           k);
    TT_CHECK();
    return 0;
}

// 16-byte accesses (vec) or one word at a time
template <typename W, int OP>
static void modew_launch(bool vec, const W* a, long long a_bs, const W* b,
                         long long b_bs, W* out, int B, int rows, int N,
                         const W* col, long long col_bs, const W* q,
                         const W* k, void* stream) {
    constexpr int V = 16 / sizeof(W);
    const int per = TT_MODEW_ITEMS * TT_MODEW_T * (vec ? V : 1);
    const dim3 grid((N + per - 1) / per, rows, B);
    if (vec)
        modew_k<W, OP, V><<<grid, TT_MODEW_T, 0, (cudaStream_t)stream>>>(
            a, a_bs, b, b_bs, out, N, col, col_bs, q, k);
    else
        modew_k<W, OP, 1><<<grid, TT_MODEW_T, 0, (cudaStream_t)stream>>>(
            a, a_bs, b, b_bs, out, N, col, col_bs, q, k);
}

static bool aligned16(const void* p, long long words, int word) {
    return ((unsigned long long)p % 16) == 0 && (words * word) % 16 == 0;
}

// op TT_MONT_SCALAR: out = reduce_2q(REDC(a, col)), col [B or 1, rows]
// (batch stride col_bs, 0 or rows), b unread; TT_MOD_ADD / TT_MOD_SUB: out
// = reduce_2q of the lazy a + b / a - b.  a, b [B, rows, N] (batch strides
// a_bs, b_bs; rows N words apart) -> out [B, rows, N] contiguous; q, k:
// [rows].  16-byte accesses where a, b and out start on 16 bytes and their
// batch strides and rows are whole 16-byte words.
template <typename W>
static int modew(int op, const W* a, long long a_bs, const W* b,
                 long long b_bs, W* out, int B, int rows, int N,
                 const W* col, long long col_bs, const W* q, const W* k,
                 void* stream) {
    if (!glue_grid_ok(B, rows, N)) return (int)cudaErrorInvalidValue;
    const int w = (int)sizeof(W);
    const bool scalar = op == TT_MONT_SCALAR;
    if (scalar ? col == nullptr : b == nullptr)
        return (int)cudaErrorInvalidValue;
    const bool vec = aligned16(a, a_bs, w) && aligned16(out, 0, w) &&
                     (scalar || aligned16(b, b_bs, w)) &&
                     ((long long)N * w) % 16 == 0;
    switch (op) {
    case TT_MONT_SCALAR:
        modew_launch<W, TT_MONT_SCALAR>(vec, a, a_bs, b, b_bs, out, B, rows,
                                        N, col, col_bs, q, k, stream);
        break;
    case TT_MOD_ADD:
        modew_launch<W, TT_MOD_ADD>(vec, a, a_bs, b, b_bs, out, B, rows, N,
                                    col, col_bs, q, k, stream);
        break;
    case TT_MOD_SUB:
        modew_launch<W, TT_MOD_SUB>(vec, a, a_bs, b, b_bs, out, B, rows, N,
                                    col, col_bs, q, k, stream);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    TT_CHECK();
    return 0;
}

#define TT_GLUE_ENTRIES(SFX, W)                                              \
    extern "C" int tt_rescale##SFX(                                          \
        const W* rows, long long rows_bs, const W* resc, long long resc_bs,  \
        W* out, int B, int c, int N, const W* scale, const W* q, const W* k, \
        long long round_at, int exact, void* stream) {                       \
        return rescale(rows, rows_bs, resc, resc_bs, out, B, c, N, scale, q, \
                       k, round_at, exact, stream);                          \
    }                                                                        \
    extern "C" int tt_parts_digits##SFX(                                     \
        const W* a, long long a_bs, W* st, int B, int n_parts, int amax,     \
        int N, const W* tab, int lo_base, void* stream) {                    \
        return parts_digits(a, a_bs, st, B, n_parts, amax, N, tab, lo_base,  \
                            stream);                                         \
    }                                                                        \
    extern "C" int tt_pdiv_p0##SFX(const W* cur, long long cur_bs, W* p0,    \
                                   int B, int S, int N,                      \
                                   const unsigned long long* pi, const W* q, \
                                   const W* k, void* stream) {               \
        return pdiv_p0(cur, cur_bs, p0, B, S, N, pi, q, k, stream);          \
    }                                                                        \
    extern "C" int tt_modew##SFX(int op, const W* a, long long a_bs,         \
                                 const W* b, long long b_bs, W* out, int B,  \
                                 int rows, int N, const W* col,              \
                                 long long col_bs, const W* q, const W* k,   \
                                 void* stream) {                             \
        return modew(op, a, a_bs, b, b_bs, out, B, rows, N, col, col_bs, q,  \
                     k, stream);                                             \
    }

#if TT_I64
TT_GLUE_ENTRIES(, i64)
#endif

#if TT_I32
TT_GLUE_ENTRIES(_30, i32)
#endif
