"""The feed-forward sub-layer of an encrypted BERT-base encoder, features
as ciphertexts (one per feature, tokens in the slots), with MPCFormer's
Quad in the place of GELU, as the configurations define it: the exact
circuit on residues, the same circuit in float64 on the messages, and
the float forward ``y = x + w2^T quad(w1^T x + b1) + b2``, ``quad(h) =
0.125 h^2 + 0.25 h + 0.5``.

The circuit, for H features x at level l (``reference/layernorm.py``
gives the scale bookkeeping of ``mult_scalar``, ``add_scalar``,
``level_up`` and ``cc_mult``), with s = sqrt(0.125):

* a stacked linear op ``lin(x, w, level)``: every weight the integer
  ``W = int(w * 2^scale_bits * sqrt(dev[level + 1]) + 0.5)`` (as
  ``mult_scalar`` encodes a scalar), ``sum_i W[i, j] x_i`` modulo each
  prime, then one rescale;
* up: ``g = add_scalar(lin(x, s w1, l), s b1)`` at l + 1;
* Quad: ``g2 = cc_mult(g, g)`` and ``u = mult_scalar(g, 0.25 / s)`` at
  l + 2, ``a = add_scalar(g2 + u, 0.5)``; the square transforms g's two
  polynomials once, where ``reference/ckks.py``'s ``cc_mult`` transforms
  both factors (the same residues: every product is canonical);
* down: ``add_scalar(lin(a, w2, l + 2), b2)`` at l + 3, the sum over the
  intermediate features taken whole (modular, so in any blocks);
* residual: ``level_up(x, l + 3)`` plus the down output.

The weighted sums run as float64 matrix products of limbs: each residue's
21-bit limbs (unsigned), each weight's balanced 21-bit limbs (at most
2^20 in magnitude), one product for each pair of limbs, so that a sum of
up to 4096 terms stays an integer below 2^53 and the product is exact;
each sum is then reduced modulo the prime and shifted into place
exactly.  TF32 is off.

It imports nothing of the program under test; on the card it works in
blocks of features so that it fits beside what the program left.
"""

import numpy as np
import torch

from fhebench.reference import ckks as ref
from fhebench.reference import layernorm as lnref
from fhebench.reference import modarith as ma

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

QUAD = (0.125, 0.25, 0.5)     # quad(h) = QUAD[0] h^2 + QUAD[1] h + QUAD[2]
LIMB = 21
MAX_TERMS = 4096              # terms a float64 limb sum takes exactly


def encode(w, pr: ref.Params, level):
    """The integers of a real weight matrix at ``level`` (int64 numpy)."""
    root = np.sqrt(lnref.deviations(pr)[level + 1])
    scaled = np.asarray(w, dtype=np.float64) * np.float64(
        2**pr.scale_bits) * root + 0.5
    assert np.all(np.abs(scaled) < 2.0**53)
    return np.trunc(scaled).astype(np.int64)


def limbs_signed(W):
    """Balanced limbs of int64 ``W``: [w_0, w_1, ...], W = sum w_l
    2^(21 l), each |w_l| <= 2^20."""
    half = 1 << (LIMB - 1)
    out, r = [], W
    while True:
        lo = ((r + half) & ((1 << LIMB) - 1)) - half
        if bool((r.abs() <= half).all()):
            return out + [r]
        out.append(lo)
        r = (r - lo) >> LIMB


class Circuit(lnref.Circuit):
    """The feed-forward circuit on residues for one prime chain."""

    def __init__(self, pr: ref.Params, evk):
        self.pr, self.evk = pr, evk
        self.dev = lnref.deviations(pr)
        self.scale = np.float64(2**pr.scale_bits)
        c2, c1, self.c0 = QUAD
        self.s = np.sqrt(c2)
        self.lin_c = c1 / self.s

    def weighted_sum(self, x: lnref.Ct, W, acc=None):
        """``sum_i W[i, j] x_i`` modulo each prime, not rescaled: ``W``
        [F_in, F_out] int64 numpy, ``x`` a stack of F_in; plus ``acc``."""
        pr = self.pr
        mod = self.mod(x.level)
        Wt = torch.from_numpy(np.ascontiguousarray(W))
        wl = [w.to(pr.device, torch.float64)
              for w in limbs_signed(Wt)]
        F_in, C, N = x.c0.shape
        F_out = W.shape[1]
        assert F_in <= MAX_TERMS
        outs = []
        for poly in (x.c0, x.c1):
            out = torch.empty((F_out, C, N), dtype=torch.int64,
                              device=pr.device)
            for c, q in enumerate(mod.primes):
                xc = poly[:, c, :]
                nl = -(-q.bit_length() // LIMB)
                tot = torch.zeros((F_out, N), dtype=torch.int64,
                                  device=pr.device)
                for a in range(nl):
                    xa = ((xc >> (LIMB * a)) & ((1 << LIMB) - 1)).double()
                    for b, w in enumerate(wl):
                        s = (w.t() @ xa).to(torch.int64)
                        s = torch.remainder(s, q)
                        k = ma.k_of(q)
                        f = pow(2, LIMB * (a + b), q) * ma.R % q
                        tot = ma.add(tot, ma.mul(s, f, q, k), q)
                out[:, c, :] = tot
            outs.append(out)
        y = lnref.Ct(outs[0], outs[1], x.level)
        return y if acc is None else self.add(acc, y)

    def linear(self, x, w, b):
        """``add_scalar(rescale(sum_i W x_i), b)`` of real weights ``w``."""
        y = self.rescale(self.weighted_sum(x, encode(w, self.pr, x.level)))
        return self.add_scalar(y, np.asarray(b))

    def square(self, u: lnref.Ct):
        """``cc_mult(u, u)``: rescale, the tensor product of a square (d1
        = 2 x0 x1), relinearize."""
        pr, level = self.pr, u.level + 1
        x0, x1 = (ref.rescale(pr, x, u.level) for x in (u.c0, u.c1))
        T = pr.ntt.rows(pr.ordinary(level))
        mod = T.mod
        X0, X1 = T.forward(x0), T.forward(x1)
        del x0, x1
        M1 = mod.mont(X1)
        p = mod.mul(X0, M1)
        d1 = T.inverse(mod.add(p, p))
        del p
        d0 = T.inverse(mod.mul(X0, mod.mont(X0)))
        del X0
        d2 = T.inverse(mod.mul(X1, M1))
        del X1, M1
        c0, c1 = ref.keyswitch(pr, d2, self.evk, level)
        del d2
        return lnref.Ct(self.mod(level).add(d0, c0),
                        self.mod(level).add(d1, c1), level)

    def act(self, g: lnref.Ct, chunk):
        """quad of the up output g (= s h): g^2 by ``cc_mult`` in chunks,
        plus g (0.25 / s), plus 0.5."""
        sq = [self.square(lnref.Ct(g.c0[i:i + chunk], g.c1[i:i + chunk],
                                   g.level))
              for i in range(0, g.c0.shape[0], chunk)]
        g2 = lnref.Ct(torch.cat([z.c0 for z in sq]),
                      torch.cat([z.c1 for z in sq]), sq[0].level)
        del sq
        u = self.mult_scalar(g, self.lin_c)
        return self.add_scalar(self.add(g2, u), self.c0)

    def forward(self, x0, x1, w1, b1, w2, b2, block, chunk, level=0):
        """The circuit on a stack of H feature ciphertexts ``x0, x1`` [H,
        C, N] at ``level``, the intermediate features ``block`` at a time,
        their squares ``chunk`` at a time: the output Ct, at level + 3."""
        x = lnref.Ct(x0, x1, level)
        I = w1.shape[1]
        acc = None
        for i in range(0, I, block):
            j = min(i + block, I)
            g = self.linear(x, self.s * w1[:, i:j], self.s * b1[i:j])
            a = self.act(g, chunk)
            del g
            acc = self.weighted_sum(a, encode(w2[i:j], self.pr, a.level),
                                    acc)
            del a
        y = self.add_scalar(self.rescale(acc), np.asarray(b2))
        return self.add(self.level_up(x, y.level), y)


def output_level(level=0):
    return level + 3


def float_circuit(pr: ref.Params, x, w1, b1, w2, b2, level=0):
    """The same circuit in float64 on the messages x [H, T] at ``level``,
    with the encoded weights and constants (each the integer the circuit
    takes, over its scale) and ``level_up``'s integer factor."""
    dev = lnref.deviations(pr)
    scale = np.float64(2**pr.scale_bits)
    s = np.sqrt(QUAD[0])

    def wq(w, level):
        return encode(w, pr, level) / (scale * np.sqrt(dev[level + 1]))

    def cq(c, level):
        c = np.asarray(c, dtype=np.float64)
        ints = np.trunc(c * scale * dev[level] + 0.5)
        return ints / (scale * dev[level])

    def mq(c, level):
        return int(c * scale * np.sqrt(dev[level + 1]) + 0.5) / (
            scale * np.sqrt(dev[level + 1]))

    x = np.asarray(x, dtype=np.float64)
    lv = level
    g = wq(s * w1, lv).T @ x + cq(s * b1, lv + 1)[:, None]
    a = g * g + g * mq(QUAD[1] / s, lv + 1) + cq(QUAD[2], lv + 2)
    y = wq(w2, lv + 2).T @ a + cq(b2, lv + 3)[:, None]
    ratio = dev[lv + 3] / np.sqrt(dev[lv + 1])
    return x * (round(scale * ratio) / (scale * ratio)) + y


def float_forward(x, w1, b1, w2, b2):
    """y = x + w2^T quad(w1^T x + b1) + b2 in float64, x [H, T]."""
    x = np.asarray(x, dtype=np.float64)
    h = w1.T @ x + b1[:, None]
    c2, c1, c0 = QUAD
    return x + w2.T @ (c2 * h * h + c1 * h + c0) + b2[:, None]


def messages(rng, features, tokens):
    """LayerNorm outputs [features, tokens]: standard normal draws made
    exactly mean 0 and variance 1 per token, times gamma ~ U(0.5, 1.5)
    plus beta ~ U(-0.5, 0.5) per feature."""
    z = rng.standard_normal((features, tokens))
    z = (z - z.mean(axis=0)) / z.std(axis=0)
    gamma = rng.uniform(0.5, 1.5, features)
    beta = rng.uniform(-0.5, 0.5, features)
    return gamma[:, None] * z + beta[:, None]
