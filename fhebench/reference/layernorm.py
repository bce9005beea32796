"""LayerNorm over features as ciphertexts (one per feature, tokens in the
slots), as the configurations define it: the exact circuit on residues,
the same circuit in float64 on the messages, and exact LayerNorm.

The circuit (the feature-wise layer of the upstream project's HE-NN
extension), for F features x_f at level 0:

    mu = (sum_f x_f) * (1/F)                       mult_scalar
    d_f = level_up(x_f, level(mu)) - mu
    v = (sum_f d_f * d_f) * (1/F) + eps            cc_mult, scalar ops
    y = v * b + a                                  the linear fit of v^-1/2
    vh = v * 0.5                                   on [lo, hi]
    iters times:  y2 = y * y;  p = level_up(vh) * y2;
                  w = -p + 1.5;  y = level_up(y) * w
    out_f = (level_up(d_f, level(y)) * y) * gamma_f + beta_f

on RNS residues with the scale bookkeeping of the configurations' CKKS
(the upstream project's): a ciphertext at level l holds its message at
``2^(2 scale_bits) * dev[l]``, where ``dev[0] = 1`` and ``dev[l + 1] =
dev[l]^2 (2^scale_bits / q_l)^2`` in float64, and

* ``mult_scalar(ct, c)`` multiplies by the integer
  ``int(c * 2^scale_bits * sqrt(dev[l + 1]) + 0.5)``, then rescales;
* ``add_scalar(ct, c)`` adds ``int(c * 2^scale_bits * dev[l] + 0.5) *
  2^scale_bits`` to coefficient 0 of the first polynomial;
* ``level_up(ct, t)`` rescales once (to ``l + 1``), drops the rows of the
  primes ``l + 1 .. t - 1`` and multiplies by ``round(2^scale_bits *
  dev[t] / sqrt(dev[l + 1]))``;
* ``cc_mult`` is :func:`ckks.cc_mult` (one unstacked operand broadcasts
  against a stack), sums are modular additions (exact, in any order).

It imports nothing of the program under test; on the card it works in
blocks of features so that it fits beside what the program left.
"""

import numpy as np
import torch

from fhebench.reference import ckks as ref
from fhebench.reference import modarith as ma

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def deviations(pr: ref.Params):
    """dev[l] for every level, in the configurations' float64 order."""
    scale = np.float64(2**pr.scale_bits)
    dev = [1.0]
    for q in pr.primes[:pr.P - 1]:
        dev.append(dev[-1] ** 2 * (scale / np.float64(q)) ** 2)
    return dev


def linear_seed(var_range):
    """(a, b): the line through (lo, lo^-1/2) and (hi, hi^-1/2)."""
    lo, hi = (float(x) for x in var_range)
    b = (hi ** -0.5 - lo ** -0.5) / (hi - lo)
    return lo ** -0.5 - b * lo, b


def per_row(c, f):
    """``f(c)`` for one scalar; for a sequence, the list of ``f`` of
    each."""
    return f(c) if np.ndim(c) == 0 else [f(x) for x in c]


class Ct:
    """A ciphertext of the reference: (c0, c1) [..., C, N] at ``level``."""

    def __init__(self, c0, c1, level):
        self.c0, self.c1, self.level = c0, c1, level


class Circuit:
    """The LayerNorm circuit on residues for one prime chain."""

    def __init__(self, pr: ref.Params, evk, eps, var_range, iters):
        self.pr, self.evk = pr, evk
        self.eps, self.iters = float(eps), int(iters)
        self.a, self.b = linear_seed(var_range)
        self.dev = deviations(pr)
        self.scale = np.float64(2**pr.scale_bits)

    def mod(self, level):
        return ma.Moduli(self.pr.primes[level:self.pr.P], self.pr.device)

    def consts(self, level, ints):
        """Per-row python ints -> [rows, C, 1] residues (plain), or
        [C, 1] for one int."""
        primes = self.pr.primes[level:self.pr.P]
        rows = [[int(v) % p for p in primes] for v in np.atleast_1d(ints)]
        t = torch.tensor(rows, dtype=torch.int64, device=self.pr.device)
        t = t[..., None]
        return t[0] if np.ndim(ints) == 0 else t

    def times(self, x, level, ints):
        """x [..., C, N] times per-row integers, modulo each prime."""
        mod = self.mod(level)
        return mod.mul(x, mod.mont(self.consts(level, ints)))

    def add(self, u: Ct, v: Ct):
        m = self.mod(u.level)
        return Ct(m.add(u.c0, v.c0), m.add(u.c1, v.c1), u.level)

    def sub(self, u: Ct, v: Ct):
        m = self.mod(u.level)
        return Ct(m.sub(u.c0, v.c0), m.sub(u.c1, v.c1), u.level)

    def negate(self, u: Ct):
        m = self.mod(u.level)
        z = torch.zeros_like(u.c0)
        return Ct(m.sub(z, u.c0), m.sub(z, u.c1), u.level)

    def rescale(self, u: Ct):
        return Ct(ref.rescale(self.pr, u.c0, u.level),
                  ref.rescale(self.pr, u.c1, u.level), u.level + 1)

    def mult_scalar(self, u: Ct, c):
        """``c``: one scalar, or one a row of a stack."""
        root = np.sqrt(self.dev[u.level + 1])
        ints = per_row(c, lambda x: int(x * self.scale * root + 0.5))
        return self.rescale(Ct(self.times(u.c0, u.level, ints),
                               self.times(u.c1, u.level, ints), u.level))

    def add_scalar(self, u: Ct, c):
        ints = per_row(c, lambda x: int(x * self.scale * self.dev[u.level]
                                        + 0.5) * 2**self.pr.scale_bits)
        col = self.consts(u.level, ints)
        c0 = u.c0.clone()
        c0[..., 0] = self.mod(u.level).add(c0[..., 0:1], col)[..., 0]
        return Ct(c0, u.c1, u.level)

    def level_up(self, u: Ct, dst):
        if u.level == dst:
            return u
        r = self.rescale(u)
        delta = round(self.scale
                      * (self.dev[dst] / np.sqrt(self.dev[r.level])))
        drop = dst - r.level
        return Ct(self.times(r.c0[..., drop:, :], dst, delta),
                  self.times(r.c1[..., drop:, :], dst, delta), dst)

    def mult(self, u: Ct, v: Ct):
        """``cc_mult`` of two ciphertexts at one level."""
        c0, c1 = ref.cc_mult(self.pr, u.c0, u.c1, v.c0, v.c1, self.evk,
                             u.level)
        return Ct(c0, c1, u.level + 1)

    def total(self, u: Ct):
        """The sum over a stack's leading dim (modular, exact), unstacked."""
        m = self.mod(u.level)
        c0, c1 = u.c0, u.c1
        while c0.shape[0] > 1:
            h = c0.shape[0] // 2
            odd0, odd1 = c0[2 * h:], c1[2 * h:]
            c0 = torch.cat([m.add(c0[:h], c0[h:2 * h]), odd0])
            c1 = torch.cat([m.add(c1[:h], c1[h:2 * h]), odd1])
        return Ct(c0[0], c1[0], u.level)

    def rsqrt(self, v: Ct):
        y = self.add_scalar(self.mult_scalar(v, self.b), self.a)
        vh = self.mult_scalar(v, 0.5)
        for _ in range(self.iters):
            y2 = self.mult(y, y)
            p = self.mult(self.level_up(vh, y2.level), y2)
            w = self.add_scalar(self.negate(p), 1.5)
            y = self.mult(self.level_up(y, w.level), w)
        return y

    def forward(self, x0, x1, gamma, beta, block):
        """The circuit on a stack of F feature ciphertexts ``x0, x1``
        [F, C, N] at level 0: yields ``(start, Ct)`` for each block of
        ``block`` features' outputs, in order."""
        F = x0.shape[0]
        blocks = range(0, F, block)

        def x(i):
            return Ct(x0[i:i + block], x1[i:i + block], 0)

        s = None
        for i in blocks:
            t = self.total(x(i))
            s = t if s is None else self.add(s, t)
        mu = self.mult_scalar(s, 1.0 / F)

        def centred(i):
            return self.sub(self.level_up(x(i), mu.level), mu)

        v = None
        for i in blocks:
            d = centred(i)
            t = self.total(self.mult(d, d))
            v = t if v is None else self.add(v, t)
        v = self.add_scalar(self.mult_scalar(v, 1.0 / F), self.eps)
        y = self.rsqrt(v)
        for i in blocks:
            z = self.mult(self.level_up(centred(i), y.level), y)
            z = self.mult_scalar(z, np.asarray(gamma[i:i + block]))
            yield i, self.add_scalar(z, np.asarray(beta[i:i + block]))


def output_level(iters):
    """The level of the outputs: mu 1, the squares 2, v 3, the seed 4,
    3 a Newton step, the product with y 1 and gamma 1."""
    return 4 + 3 * int(iters) + 2


def scale_at(pr: ref.Params, level):
    """The scale of a message at ``level``: 2^(2 scale_bits) dev[level]."""
    return ref.fresh_scale(pr) * deviations(pr)[level]


def decrypt(pr: ref.Params, c0, c1, s, level, scale):
    """:func:`ckks.decrypt`, and at a level of two primes (the last but
    one) the integer from those two: (float64 [..., N], mismatches)."""
    if pr.P - level >= 3:
        return ref.decrypt(pr, c0, c1, s, level, scale)
    T = pr.ntt.rows(pr.ordinary(level))
    mod = T.mod
    S = mod.mont(T.forward(mod.mod(s.expand(len(mod), -1))))
    x = mod.add(c0, T.inverse(mod.mul(T.forward(c1), S)))
    pa, pb = mod.primes[-1], mod.primes[0]
    v0 = ref.centered(x[..., -1, :], pa)
    v1 = ref.centered(ma.mul(torch.remainder(x[..., 0, :] - v0, pb),
                             pow(pa, -1, pb) * ma.R % pb, pb, ma.k_of(pb)),
                      pb)
    val = v0.double() + float(pa) * v1.double()
    return (val / float(scale)).cpu().numpy(), 0


def float_circuit(x, gamma, beta, eps, var_range, iters):
    """The same circuit in float64 on the messages x [F, T]."""
    x = np.asarray(x, dtype=np.float64)
    F = x.shape[0]
    a, b = linear_seed(var_range)
    mu = x.sum(axis=0) * (1.0 / F)
    d = x - mu
    v = (d * d).sum(axis=0) * (1.0 / F) + eps
    y = v * b + a
    vh = v * 0.5
    for _ in range(int(iters)):
        y = y * (1.5 - vh * (y * y))
    return np.asarray(gamma)[:, None] * (d * y) + np.asarray(beta)[:, None]


def exact(x, gamma, beta, eps):
    """LayerNorm over the feature axis of x [F, T]."""
    x = np.asarray(x, dtype=np.float64)
    mu = x.mean(axis=0)
    var = ((x - mu) ** 2).mean(axis=0)
    return (np.asarray(gamma)[:, None] * (x - mu) / np.sqrt(var + eps)
            + np.asarray(beta)[:, None])


def messages(rng, features, tokens, var_range, centre=0.5):
    """Messages [features, tokens] whose variance over the features lies
    in ``var_range`` for every token: standard normal draws made exactly
    mean 0 and variance 1 per token, scaled by the root of a variance
    drawn uniformly from the middle 90% of the range, shifted by a mean
    drawn from [-centre, centre]."""
    lo, hi = (float(v) for v in var_range)
    pad = 0.05 * (hi - lo)
    z = rng.standard_normal((features, tokens))
    z = (z - z.mean(axis=0)) / z.std(axis=0)
    var = rng.uniform(lo + pad, hi - pad, tokens)
    mean = rng.uniform(-centre, centre, tokens)
    return mean + np.sqrt(var) * z

