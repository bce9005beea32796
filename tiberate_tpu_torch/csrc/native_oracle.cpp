// Native host oracle of tiberate_tpu_torch: exact negacyclic polynomial
// products, Montgomery residue verification (R = 2^62), bulk ChaCha20
// blocks, a 64-bit primality test and Shoup key rows, in __int128
// arithmetic, sharing no code with the device path or the plain torch
// versions.
//
// The port's own copy of the JAX package's native/tiberate_native.cpp, with
// one fix: the cyclic transform inside negacyclic_mul takes its order-len
// root as psi^(2N/len).  psi has order 2N; the original raised it to
// (q-1)/len, which is an order-len root only when (q-1)/2N is odd.
//
// Built as a plain shared library with g++ at first use and loaded through
// ctypes (tiberate_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstring>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;
using u128 = unsigned __int128;

static inline u64 mulmod(u64 a, u64 b, u64 q) {
  return (u64)(((u128)a * b) % q);
}

static inline u64 powmod(u64 a, u64 e, u64 q) {
  u64 r = 1 % q;
  a %= q;
  while (e) {
    if (e & 1) r = mulmod(r, a, q);
    a = mulmod(a, a, q);
    e >>= 1;
  }
  return r;
}

extern "C" {

// ---------------------------------------------------------------------
// Exact negacyclic product: out = a * b mod (X^N + 1, q), coeffs in [0,q).
// Uses an internal iterative NTT with its own root search (independent of
// the device implementation).  Returns 0 on success, -1 if q is not
// NTT-friendly for N.
// ---------------------------------------------------------------------
int negacyclic_mul(const i64* a, const i64* b, i64* out, i64 N, i64 q_) {
  u64 q = (u64)q_;
  if ((q - 1) % (u64)(2 * N) != 0) return -1;

  // find a primitive 2N-th root psi (same search as the device path,
  // smallest witness; any valid root gives the same product)
  u64 K = (q - 1) / (u64)(2 * N);
  u64 psi = 0;
  for (u64 x = 2; x < (u64)N + 2; ++x) {
    u64 g = powmod(x, K, q);
    if (powmod(g, (u64)N, q) != 1) {
      psi = g;
      break;
    }
  }
  if (!psi) return -1;
  u64 ipsi = powmod(psi, q - 2, q);
  u64 Ninv = powmod((u64)N, q - 2, q);

  std::vector<u64> fa(N), fb(N);
  // twist by psi^i for negacyclic wrap
  u64 p = 1;
  for (i64 i = 0; i < N; ++i) {
    fa[i] = mulmod((u64)a[i] % q, p, q);
    fb[i] = mulmod((u64)b[i] % q, p, q);
    p = mulmod(p, psi, q);
  }

  // iterative radix-2 DIT cyclic transform (bit reversal, butterflies);
  // root has order 2N
  auto fft = [&](std::vector<u64>& v, u64 root) {
    i64 n = (i64)v.size();
    for (i64 i = 1, j = 0; i < n; ++i) {
      i64 bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      if (i < j) std::swap(v[i], v[j]);
    }
    for (i64 len = 2; len <= n; len <<= 1) {
      u64 wl = powmod(root, (u64)(2 * N / len), q);
      for (i64 i = 0; i < n; i += len) {
        u64 wn = 1;
        for (i64 k = 0; k < len / 2; ++k) {
          u64 u = v[i + k], t = mulmod(wn, v[i + k + len / 2], q);
          v[i + k] = u + t < q ? u + t : u + t - q;
          v[i + k + len / 2] = u >= t ? u - t : u + q - t;
          wn = mulmod(wn, wl, q);
        }
      }
    }
  };

  // the cyclic transform of order N: fft(v, psi) uses the roots
  // psi^(2N/len), so its length-N root is psi^2; fft(v, ipsi) is the
  // inverse sum X[k] = sum_j x[j] psi^(-2jk), which leaves only the 1/N
  fft(fa, psi);
  fft(fb, psi);
  for (i64 i = 0; i < N; ++i) fa[i] = mulmod(fa[i], fb[i], q);
  fft(fa, ipsi);
  for (i64 i = 0; i < N; ++i) fa[i] = mulmod(fa[i], Ninv, q);

  // untwist by psi^{-i}
  p = 1;
  for (i64 i = 0; i < N; ++i) {
    out[i] = (i64)mulmod(fa[i], p, q);
    p = mulmod(p, ipsi, q);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Montgomery residue verification: checks that every element of `got`
// satisfies got ≡ a*b*R^-1 (mod q) and 0 <= got < 2q, with R = 2^62.
// Returns the number of violations.
// ---------------------------------------------------------------------
i64 mont_mult_verify(const i64* a, const i64* b, const i64* got, i64 n,
                     i64 q_) {
  u64 q = (u64)q_;
  u64 Rinv = powmod(powmod(2, 62, q), q - 2, q);
  i64 bad = 0;
  for (i64 i = 0; i < n; ++i) {
    u64 expect = mulmod(mulmod((u64)a[i] % q, (u64)b[i] % q, q), Rinv, q);
    u64 g = (u64)got[i];
    if (g >= 2 * q || g % q != expect) ++bad;
  }
  return bad;
}

// ---------------------------------------------------------------------
// Bulk ChaCha20 block function (RFC 7539): n_rows states of 16 words.
// ---------------------------------------------------------------------
static inline u32 rotl(u32 x, int n) { return (x << n) | (x >> (32 - n)); }

void chacha20_blocks(const u32* states, u32* out, i64 n_rows) {
  for (i64 r = 0; r < n_rows; ++r) {
    const u32* s = states + 16 * r;
    u32 x[16];
    std::memcpy(x, s, sizeof(x));
    for (int i = 0; i < 10; ++i) {
      auto qr = [&](int a, int b, int c, int d) {
        x[a] += x[b]; x[d] = rotl(x[d] ^ x[a], 16);
        x[c] += x[d]; x[b] = rotl(x[b] ^ x[c], 12);
        x[a] += x[b]; x[d] = rotl(x[d] ^ x[a], 8);
        x[c] += x[d]; x[b] = rotl(x[b] ^ x[c], 7);
      };
      qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15);
      qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14);
    }
    u32* o = out + 16 * r;
    for (int i = 0; i < 16; ++i) o[i] = x[i] + s[i];
  }
}

// Deterministic Miller-Rabin for 64-bit n (base set valid < 3.3e24).
int is_prime_u64(u64 n) {
  if (n < 2) return 0;
  for (u64 p : {2ull, 3ull, 5ull, 7ull, 11ull, 13ull, 17ull, 19ull, 23ull,
                29ull, 31ull, 37ull}) {
    if (n % p == 0) return n == p;
  }
  u64 d = n - 1;
  int r = 0;
  while ((d & 1) == 0) d >>= 1, ++r;
  for (u64 a : {2ull, 3ull, 5ull, 7ull, 11ull, 13ull, 17ull, 19ull, 23ull,
                29ull, 31ull, 37ull}) {
    u64 x = powmod(a, d, n);
    if (x == 1 || x == n - 1) continue;
    bool comp = true;
    for (int i = 0; i < r - 1; ++i) {
      x = mulmod(x, x, n);
      if (x == n - 1) { comp = false; break; }
    }
    if (comp) return 0;
  }
  return 1;
}

// Shoup-form key row: w[i] = k[i] * rinv mod q (the plain-domain key)
// and s[i] = floor(w[i] << rbits / q) (the Shoup companion) — the
// 124-bit division the Python side cannot vectorize.  k values may be
// lazy [0, 2q).
void shoup_key_row(const u64* k, i64 n, u64 q, u64 rinv, i64 rbits,
                   u64* w, u64* s) {
  for (i64 i = 0; i < n; ++i) {
    u64 wi = mulmod(k[i] % q, rinv, q);
    w[i] = wi;
    s[i] = (u64)(((unsigned __int128)wi << rbits) / q);
  }
}

}  // extern "C"
