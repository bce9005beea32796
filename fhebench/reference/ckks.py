"""Plain CKKS over RNS residues, as the configurations define it: the
reference every cell's outputs are compared with.

It takes the prime chain from the configuration file and everything else
from the inputs the benchmark hands it (ciphertexts, messages and the
keys' residues); it works out its own roots, twiddles, key parts and
division constants, and imports nothing of the program under test.

The layout (the upstream project's): primes ``[scale primes..., base,
specials...]``, ``P`` ordinary and ``S`` special; a ciphertext at level
``l`` holds the ordinary primes ``l .. P-1`` as rows of ``[..., C, N]``
canonical coefficient residues.  Keys hold all ``P + S`` rows in the
evaluation domain (:mod:`ntt`), times ``2^62`` (Montgomery form).

The algorithm, stage by stage, with the exact integer each stage takes
where the result depends on more than its residue class:

* **rescale** at level l: ``round(x / q_l)`` on the remaining primes,
  rounding half up (``x`` in ``[0, Q)``);
* **tensor product**: ``d0 = x0 y0``, ``d1 = x0 y1 + x1 y0``, ``d2 = x1 y1``
  in ``Z_q[X] / (X^N + 1)``;
* **keyswitch** of ``a``: the ordinary primes of the level fall into parts,
  the fixed groups ``[iS, (i+1)S)`` of level 0 cut at the level, and the
  base prime alone; key part ``i`` serves group ``i``, the last the base.
  Each part's residues become mixed-radix (Garner) digits by Montgomery
  reductions and plain sums (:func:`garner`), the digits' integer
  ``X = v0 + v1 m0 + v2 m0 m1 + ...`` is taken modulo every prime of the
  level and the specials, multiplied by the part's two key polynomials,
  and summed over the parts; then
* **P-division**: the sums are divided by each special prime in turn,
  last first, ``x <- (x - p0) / P_i`` with ``p0`` the special row as the
  successive division leaves it (:func:`pdiv`);
* **relinearization**: ``(d0 + c0, d1 + c1)`` of ``d2``'s keyswitch;
* **rotation** by ``delta``: the Galois map ``X -> X^(3^delta)`` of both
  polynomials, then the keyswitch of the second with the rotation key;
  ``sum`` adds the rotations by 1, 2, 4, ..., N/4 into the running sum.

Decryption takes ``c0 + c1 s`` on every prime of the level, rebuilds the
integer from three by Garner's method, checks the others hold it too,
and divides it by the scale; decoding evaluates the
polynomial at ``zeta^(g^j)``, ``zeta = exp(i pi / N)``, ``g = 3^-1 mod 2N``
for slot ``j``.
"""

import math

import numpy as np
import torch

from fhebench.reference import modarith as ma
from fhebench.reference.ntt import Transform

I64 = torch.int64


class Params:
    """The prime chain of a configuration on a device."""

    def __init__(self, primes, logN: int, num_special: int, device,
                 scale_bits: int, word_bits: int = 62):
        self.primes = [int(p) for p in primes]
        self.S = int(num_special)
        self.P = len(self.primes) - self.S
        self.logN = logN
        self.N = 1 << logN
        self.scale_bits = scale_bits
        self.device = torch.device(device)
        self.mod = ma.Moduli(self.primes, self.device)
        self.ntt = Transform(self.mod, logN)
        # keys are stored times 2^word_bits: mul by this leaves them plain
        self.unmont = ma.col([pow(2, ma.W - word_bits, p)
                              for p in self.primes], self.device)

    def ordinary(self, level):
        return slice(level, self.P)

    def with_special(self, level):
        return slice(level, None)

    def parts(self, level):
        """[(first prime, end prime, key part)] at ``level``."""
        P, S = self.P, self.S
        out = []
        g = level // S
        while g * S < P - 1:
            lo, hi = max(g * S, level), min((g + 1) * S, P - 1)
            if hi > lo:
                out.append((lo, hi, g))
            g += 1
        out.append((P - 1, P, g))
        return out


# ----------------------------------------------------------------------
# The stages.
# ----------------------------------------------------------------------


def rescale(pr: Params, x, level):
    """x [..., C, N] at ``level`` -> round(x / q_level) at level + 1."""
    ql = pr.primes[level]
    mod = ma.Moduli(pr.primes[level + 1:pr.P], pr.device)
    r0 = x[..., 0:1, :]
    d = mod.mod(x[..., 1:, :] - r0)
    out = mod.mul(d, mod.const([pow(ql, -1, p) for p in mod.primes]))
    return mod.add(out, (r0 > ql // 2).to(I64))


def tensor(pr: Params, x0, x1, y0, y1, level):
    """The tensor product of two ciphertexts at ``level``: (d0, d1, d2),
    canonical coefficients."""
    T = pr.ntt.rows(pr.ordinary(level))
    mod = T.mod
    X0, X1 = T.forward(x0), T.forward(x1)
    Y0, Y1 = mod.mont(T.forward(y0)), mod.mont(T.forward(y1))
    d0 = mod.mul(X0, Y0)
    d1 = mod.add(mod.mul(X0, Y1), mod.mul(X1, Y0))
    d2 = mod.mul(X1, Y1)
    return T.inverse(d0), T.inverse(d1), T.inverse(d2)


def garner(a, primes):
    """Mixed-radix digits of residues ``a`` [..., alpha, N] modulo
    ``primes``: digit i + 1 is the Montgomery reduction of
    ``(a_{i+1} - r_{i+1}) * L_i^-1 R`` (``L_i = m_0 ... m_i``), where
    ``r_j`` starts at ``a_0`` and gains the reduction of ``digit * L_i R``
    modulo ``m_j`` for each digit before it; a list of int64 tensors."""
    m = [int(p) for p in primes]
    rows = [a[..., 0, :]] * len(m)
    for i in range(len(m) - 1):
        L = math.prod(m[:i + 1])
        q = m[i + 1]
        y = ma.redc(a[..., i + 1, :] - rows[i + 1],
                    pow(L, -1, q) * ma.R % q, q, ma.k_of(q))
        rows[i + 1] = y
        for r in range(i + 2, len(m)):
            rows[r] = rows[r] + ma.redc(y, L * ma.R % m[r], m[r],
                                        ma.k_of(m[r]))
    return rows


def extend(digits, primes, mod: ma.Moduli):
    """The digits' integer sum(v_i L_{i-1}) modulo every prime of ``mod``:
    [..., C, N] canonical."""
    ext = mod.mod(digits[0][..., None, :])
    for i in range(1, len(digits)):
        L = math.prod(int(p) for p in primes[:i])
        term = mod.mul(mod.mod(digits[i][..., None, :]),
                       mod.const([L] * len(mod)))
        ext = mod.add(ext, term)
    return ext


def pdiv(pr: Params, A, level):
    """P-division of a keyswitch sum ``A`` [..., C + S, N] (canonical
    coefficients, the level's ordinary rows then the specials) ->
    [..., C, N] canonical."""
    C, S = pr.P - level, pr.S
    spec = pr.primes[pr.P:]
    order = spec[::-1]                 # division order: last special first
    cur = A[..., C:, :]
    p0 = []
    for i in range(S):
        top = S - 1 - i
        p0.append(cur[..., top, :])
        if top:
            q = ma.col(spec[:top], pr.device)
            twoq = 2 * q
            s = cur[..., :top, :] + twoq - cur[..., top:top + 1, :]
            s = torch.where(s < twoq, s, s - twoq)
            inv = ma.col([pow(order[i], -1, p) * ma.R % p for p in spec[:top]],
                         pr.device)
            cur = ma.redc(s, inv, q, ma.col([ma.k_of(p) for p in spec[:top]],
                                             pr.device))
    mod = ma.Moduli(pr.primes[level:pr.P], pr.device)

    def inv_prod(divisors):
        return [math.prod(pow(d, -1, p) for d in divisors) % p
                for p in mod.primes]

    out = mod.mul(A[..., :C, :], mod.const(inv_prod(order)))
    for i in range(S):
        term = mod.mul(mod.mod(p0[i][..., None, :]),
                       mod.const(inv_prod(order[i:])))
        out = mod.sub(out, term)
    return out


def keyswitch(pr: Params, a, key, level):
    """Keyswitch ``a`` [..., C, N] (canonical coefficients at ``level``)
    with ``key``, a list over key parts of (k0, k1) [P + S, N] residues in
    the evaluation domain, Montgomery form -> (c0, c1) [..., C, N]."""
    sl = pr.with_special(level)
    T = pr.ntt.rows(sl)
    mod = T.mod
    acc = [None, None]
    for lo, hi, g in pr.parts(level):
        digits = garner(a[..., lo - level:hi - level, :], pr.primes[lo:hi])
        E = T.forward(extend(digits, pr.primes[lo:hi], mod))
        for j in range(2):
            prod = mod.mul(E, mod.mod(key[g][j][sl]))
            acc[j] = prod if acc[j] is None else mod.add(acc[j], prod)
    return tuple(pdiv(pr, T.inverse(x), level) for x in acc)


def cc_mult(pr: Params, a0, a1, b0, b1, evk, level):
    """rescale -> tensor product -> relinearize: the product of two
    ciphertexts at ``level``, at ``level + 1``."""
    x0, x1, y0, y1 = (rescale(pr, x, level) for x in (a0, a1, b0, b1))
    d0, d1, d2 = tensor(pr, x0, x1, y0, y1, level + 1)
    c0, c1 = keyswitch(pr, d2, evk, level + 1)
    mod = ma.Moduli(pr.primes[level + 1:pr.P], pr.device)
    return mod.add(d0, c0), mod.add(d1, c1)


def galois(N, p, device):
    """(src, negate): ``out[j] = +-x[src[j]]`` is x(X^p)."""
    i = torch.arange(N, device=device)
    e = i * p % (2 * N)
    src = torch.empty_like(i)
    neg = torch.empty(N, dtype=torch.bool, device=device)
    src[e % N] = i
    neg[e % N] = e >= N
    return src, neg


def permute(x, src, neg, q):
    y = x[..., src]
    return torch.where(neg & (y != 0), q - y, y)


def rotate(pr: Params, c0, c1, key, delta, level):
    p = pow(3, delta, 2 * pr.N)
    src, neg = galois(pr.N, p, pr.device)
    q = pr.mod.q[pr.ordinary(level)]
    r0, r1 = permute(c0, src, neg, q), permute(c1, src, neg, q)
    k0, k1 = keyswitch(pr, r1, key, level)
    return ma.add(r0, k0, q), k1


def rot_sum(pr: Params, c0, c1, keys, level):
    """Every slot the sum of all: ``keys[i]`` rotates by 2^i."""
    q = pr.mod.q[pr.ordinary(level)]
    for i in range(pr.logN - 1):
        r0, r1 = rotate(pr, c0, c1, keys[i], 1 << i, level)
        c0, c1 = ma.add(r0, c0, q), ma.add(r1, c1, q)
    return c0, c1


# ----------------------------------------------------------------------
# Keys, decryption, decoding.
# ----------------------------------------------------------------------


def centered(x, q):
    return torch.where(x > q // 2, x - q, x)


def secret(pr: Params, sk):
    """The secret polynomial from the key's rows [P + S, N] (evaluation
    domain, Montgomery form): (s [N] int64, rows that are not the same
    ternary polynomial)."""
    mod = pr.mod
    coef = pr.ntt.inverse(mod.mul(mod.mod(sk.to(I64)), pr.unmont))
    c = centered(coef, mod.q)
    s = c[0]
    bad = ((c != s).any(dim=-1) | (s.abs() > 1).any()).sum()
    return s, int(bad)


def key_noise(pr: Params, key, S_from, s, channels):
    """The largest error of a keyswitch key on the sampled ``channels``
    (global prime indices): part g's rows must satisfy
    ``k0 + k1 s = e + [channel in part g] P s_from`` with one small e
    over all of them.  ``S_from``: s_from in the evaluation domain on
    every prime, plain residues.  Returns max |e| and, where two channels
    disagree, the largest disagreement."""
    T = pr.ntt.rows(channels)
    mod = T.mod
    Pprod = math.prod(pr.primes[pr.P:])
    Sv = T.forward(mod.mod(s.expand(len(channels), -1)))
    unm = pr.unmont[channels]
    worst = 0
    for lo, hi, g in pr.parts(0):   # the primes where key part g holds P
        k0 = mod.mul(mod.mod(key[g][0][channels].to(I64)), unm)
        k1 = mod.mul(mod.mod(key[g][1][channels].to(I64)), unm)
        e = mod.add(k0, mod.mul(k1, mod.mont(Sv)))
        inpart = mod.const([Pprod % p if lo <= c < hi else 0
                            for c, p in zip(channels, mod.primes)])
        e = mod.sub(e, mod.mul(S_from[channels], inpart))
        e = centered(T.inverse(e), mod.q)
        worst = max(worst, int(e.abs().max()), int((e - e[0]).abs().max()))
    return worst


def decrypt(pr: Params, c0, c1, s, level, scale):
    """c0 + c1 s divided by ``scale``: (float64 [..., N] numpy, the
    residues on which the primes disagree).  The integer is rebuilt from
    the base prime and the level's first two, which hold it whole while it
    is below half their product; every other prime of the level must hold
    the same integer."""
    T = pr.ntt.rows(pr.ordinary(level))
    mod = T.mod
    S = mod.mont(T.forward(mod.mod(s.expand(len(mod), -1))))
    x = mod.add(c0, T.inverse(mod.mul(T.forward(c1), S)))
    rows = [pr.P - 1 - level, 0, 1]
    # balanced mixed-radix digits: X = v0 + pa (v1 + pb v2), each digit
    # centered, so a small X has small digits and loses nothing in float
    pa, pb, pc = (mod.primes[r] for r in rows)
    r_a, r_b, r_c = (x[..., r, :] for r in rows)
    v0 = centered(r_a, pa)
    v1 = centered(ma.mul(torch.remainder(r_b - v0, pb),
                         pow(pa, -1, pb) * ma.R % pb, pb, ma.k_of(pb)), pb)
    u = ma.add(torch.remainder(v0, pc),
               ma.mul(torch.remainder(v1, pc), pa * ma.R % pc, pc,
                      ma.k_of(pc)), pc)
    v2 = centered(ma.mul(ma.sub(r_c, u, pc), pow(pa * pb, -1, pc) * ma.R % pc,
                         pc, ma.k_of(pc)), pc)
    # X modulo every prime of the level, against the residues
    hi = mod.add(mod.mod(v1[..., None, :]),
                 mod.mul(mod.mod(v2[..., None, :]), mod.const([pb] * len(mod))))
    X = mod.add(mod.mod(v0[..., None, :]),
                mod.mul(hi, mod.const([pa] * len(mod))))
    bad = int((X != x).sum())
    val = v0.double() + float(pa) * (v1.double() + float(pb) * v2.double())
    return (val / float(scale)).cpu().numpy(), bad


def decode(y):
    """Coefficients / scale [..., N] (float) -> complex slots [..., N/2]."""
    N = y.shape[-1]
    zeta = np.exp(1j * np.pi * np.arange(N) / N)
    Y = np.fft.ifft(y * zeta, axis=-1) * N
    g = pow(3, -1, 2 * N)
    e = np.array([pow(g, j, 2 * N) for j in range(N // 2)])
    return Y[..., (e - 1) // 2]


def fresh_scale(pr: Params):
    """The scale of a fresh ciphertext: the message times 2^scale_bits,
    rounded, times 2^scale_bits again."""
    return 2.0 ** (2 * pr.scale_bits)


def mult_scale(pr: Params, level):
    """The scale of a product of two level-``level`` fresh-scale
    ciphertexts, after the rescale by q_level."""
    return (fresh_scale(pr) / pr.primes[level]) ** 2
