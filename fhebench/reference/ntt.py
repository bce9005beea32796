"""The negacyclic number-theoretic transform over each prime, plain torch.

The configurations' keys and intermediate products live in one evaluation
domain: for a row of coefficients ``x`` modulo ``q``, entry ``j`` is
``x(psi^(2 br(j) + 1)) mod q``, where ``br`` reverses the logN bits of
``j`` and ``psi`` is the primitive 2N-th root of unity ``g^((q-1)/2N)`` of
the smallest ``g = 2, 3, ...`` for which it has order 2N (the rule of the
upstream project's parameter set).  The reference works the roots out
from the primes and evaluates by the textbook radix-2 transforms
(Cooley-Tukey forward, natural order in and bit-reversed out;
Gentleman-Sande inverse), in canonical residues.
"""

import torch

from fhebench.reference import modarith as ma


def primitive_root_2n(q: int, N: int) -> int:
    if (q - 1) % (2 * N):
        raise ValueError(f"{q} is not 1 mod 2N = {2 * N}")
    e = (q - 1) // (2 * N)
    for g in range(2, N):
        psi = pow(g, e, q)
        if pow(psi, N, q) != 1:
            return psi
    raise ValueError(f"no primitive 2N-th root modulo {q}")


def bitrev(logN: int, device):
    idx = torch.arange(1 << logN, device=device)
    out = torch.zeros_like(idx)
    for b in range(logN):
        out |= ((idx >> b) & 1) << (logN - 1 - b)
    return out


def _power_rows(mod: ma.Moduli, roots, logN: int):
    """[C, N]: row c holds roots[c]^i for i < N, canonical, by doubling."""
    p = torch.ones((len(mod), 1), dtype=torch.int64, device=mod.device)
    for b in range(logN):
        step = mod.const([pow(r, 1 << b, q) for r, q in zip(roots,
                                                          mod.primes)])
        p = torch.cat([p, mod.mul(p, step)], dim=1)
    return p


class Transform:
    """The forward and inverse transforms modulo each prime of ``mod``."""

    def __init__(self, mod: ma.Moduli, logN: int):
        self.mod = mod
        self.logN = logN
        self.N = N = 1 << logN
        psi = [primitive_root_2n(q, N) for q in mod.primes]
        ipsi = [pow(p, -1, q) for p, q in zip(psi, mod.primes)]
        br = bitrev(logN, mod.device)
        # twiddles in Montgomery form, bit-reversed: w[c, j] = psi^br(j) R
        self.w = mod.mont(_power_rows(mod, psi, logN)[:, br])
        self.iw = mod.mont(_power_rows(mod, ipsi, logN)[:, br])
        self.ninv = mod.const([pow(N, -1, q) for q in mod.primes])

    def rows(self, sel):
        """The transform modulo some of the primes: a slice or a list of
        their indices."""
        if not isinstance(sel, slice):
            sel = list(sel)
            primes = [self.mod.primes[i] for i in sel]
        else:
            primes = self.mod.primes[sel]
        t = object.__new__(Transform)
        t.mod = ma.Moduli(primes, self.mod.device)
        t.logN, t.N = self.logN, self.N
        t.w, t.iw, t.ninv = self.w[sel], self.iw[sel], self.ninv[sel]
        return t

    def forward(self, x):
        """x [..., C, N] canonical coefficients -> the evaluation domain."""
        q, k, N = self.mod.q[..., None], self.mod.k[..., None], self.N
        lead = x.shape[:-1]
        C = self.w.shape[0]
        m = 1
        while m < N:
            t = N // (2 * m)
            xv = x.reshape(*lead, m, 2, t)
            u, o = xv[..., 0, :], xv[..., 1, :]
            v = ma.mul(o, self.w[:, m:2 * m].reshape(C, m, 1), q, k)
            x = torch.stack([ma.add(u, v, q), ma.sub(u, v, q)],
                            dim=-2).reshape(*lead, N)
            m *= 2
        return x

    def inverse(self, x):
        """The evaluation domain -> canonical coefficients."""
        q, k, N = self.mod.q[..., None], self.mod.k[..., None], self.N
        lead = x.shape[:-1]
        C = self.iw.shape[0]
        h = N // 2
        while h >= 1:
            t = N // (2 * h)
            xv = x.reshape(*lead, h, 2, t)
            u, v = xv[..., 0, :], xv[..., 1, :]
            d = ma.mul(ma.sub(u, v, q), self.iw[:, h:2 * h].reshape(C, h, 1),
                       q, k)
            x = torch.stack([ma.add(u, v, q), d], dim=-2).reshape(*lead, N)
            h //= 2
        return self.mod.mul(x, self.ninv)
