"""Negacyclic NTT / iNTT on ``[..., C, N]`` RNS tensors (radix 2).

The torch counterpart of ``tiberate_tpu/ops/ntt.py``, for both storage
dtypes: the twiddle tables and data carry the pack's dtype (int64 at
R = 2^62, int32 at R = 2^30) and :mod:`mont` picks the mode from it.  Each
stage is a reshape,

    stage ``logm`` (m = 2^logm groups, t = N / 2m):
        view x as [..., m, 2, t]; U = x[..., 0, :], O = x[..., 1, :]
        V = mont_mult(psi[m + i], O)     (CT butterfly, forward)
        x <- [U + V, U - V]  (lazy mod 2q)

with the bit-reversed ψ power series in Montgomery form as the twiddle bank.
Forward = Cooley-Tukey (natural order in, bit-reversed out); inverse =
Gentleman-Sande (bit-reversed in, natural out) with the ``N^-1 R`` fold-in.

These are the plain versions the Hopper NTT kernels (``ops/ntt_kernels.py``)
are checked against: a kernel runs the same butterflies with the same
twiddles and the same lazy reductions, so its outputs are bit-identical.
"""

import torch

from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops.mont import ModPack


def _butterfly_consts(pack: ModPack):
    return (pack.ql[..., None], pack.qh[..., None], pack.kl[..., None],
            pack.kh[..., None], pack._2q[..., None])


def ntt(x, psi, pack: ModPack, signed: bool = False):
    """Forward negacyclic NTT, in Montgomery domain, lazy [0,2q) bounds.

    x: [..., C, N] in the pack's dtype (Montgomery form, < 2q).  ``signed``
    documents that negative representatives are accepted (key-material
    rotation); the signed butterflies handle both, so the path is the same.
    psi: [C, N] — bit-reversed ψ power series in Montgomery form.
    """
    del signed
    N = x.shape[-1]
    logN = N.bit_length() - 1
    lead = x.shape[:-1]
    ql, qh, kl, kh, _2q = _butterfly_consts(pack)

    for logm in range(logN):
        m = 1 << logm
        t = N >> (logm + 1)
        xv = x.reshape(*lead, m, 2, t)
        U = xv[..., 0, :]
        O = xv[..., 1, :]
        # Twiddle for group i is psi[m + i], broadcast over t coefficients.
        S = psi[:, m : 2 * m].reshape(-1, m, 1)
        V = mont.mont_mult_raw(S, O, ql, qh, kl, kh)
        UplusV = U + V
        UminusV = U + _2q - V
        UplusV = torch.where(UplusV < _2q, UplusV, UplusV - _2q)
        UminusV = torch.where(UminusV < _2q, UminusV, UminusV - _2q)
        x = torch.stack([UplusV, UminusV], dim=-2).reshape(*lead, N)
    return x


def intt_core(x, ipsi, pack: ModPack):
    """Inverse butterflies only (Gentleman-Sande), no N^-1 scaling."""
    N = x.shape[-1]
    logN = N.bit_length() - 1
    lead = x.shape[:-1]
    ql, qh, kl, kh, _2q = _butterfly_consts(pack)

    for logm in range(logN, 0, -1):
        h = 1 << (logm - 1)  # number of groups
        t = N >> logm
        xv = x.reshape(*lead, h, 2, t)
        U = xv[..., 0, :]
        V = xv[..., 1, :]
        S = ipsi[:, h : 2 * h].reshape(-1, h, 1)
        W = U + V
        W = torch.where(W < _2q, W, W - _2q)
        D = U + _2q - V
        D = torch.where(D < _2q, D, D - _2q)
        Vn = mont.mont_mult_raw(S, D, ql, qh, kl, kh)
        x = torch.stack([W, Vn], dim=-2).reshape(*lead, N)
    return x


def intt(x, ipsi, Ninv, pack: ModPack):
    """Inverse NTT staying in the Montgomery domain.

    Ninv: [C, 1] = N^-1 * R mod q; the final mont_mult folds the 1/N
    normalization and keeps the R factor.
    """
    return mont.mont_mult(intt_core(x, ipsi, pack), Ninv, pack)


def enter_ntt(x, Rs, psi, pack: ModPack):
    """mont_enter then forward NTT (inputs are unsigned residues)."""
    return ntt(mont.mont_enter(x, Rs, pack), psi, pack)


def intt_exit(x, ipsi, Ninv, pack: ModPack):
    """iNTT then exit Montgomery."""
    return mont.mont_reduce(intt(x, ipsi, Ninv, pack), pack)


def intt_exit_reduce(x, ipsi, Ninv, pack: ModPack):
    return mont.reduce_2q(intt_exit(x, ipsi, Ninv, pack), pack)


def intt_exit_reduce_signed(x, ipsi, Ninv, pack: ModPack):
    """iNTT, exit, reduce, then the centred representative (-q/2, q/2]."""
    return mont.make_signed(intt_exit_reduce(x, ipsi, Ninv, pack), pack)


# ----------------------------------------------------------------------
# Host-side table construction (python ints).
# ----------------------------------------------------------------------


def primitive_root_2N(q: int, N: int) -> int:
    """Smallest-witness primitive 2N-th root of unity mod q: scan x = 2, 3, …
    and take g = x^((q-1)/2N); accept when g^N != 1 (so ord(g) = 2N)."""
    _2N = 2 * N
    if (q - 1) % _2N != 0:
        raise ValueError(f"q={q} is not NTT-friendly for N={N} (q != 1 mod 2N)")
    K = (q - 1) // _2N
    for x in range(2, N):
        g = pow(x, K, q)
        if pow(g, N, q) != 1:
            return g
    raise RuntimeError(f"no primitive 2N-th root found for q={q}")


def bit_reverse(a: int, nbits: int) -> int:
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (a & 1)
        a >>= 1
    return r


def negacyclic_ntt_oracle(coeffs, q: int, logN: int):
    """O(N^2) exact negacyclic evaluation for tests: the polynomial at
    ψ^(2k+1) for k = 0 .. N-1 in natural order (ψ from
    :func:`primitive_root_2N`), plain ints."""
    N = 1 << logN
    g = primitive_root_2N(q, N)
    out = []
    for k in range(N):
        root = pow(g, 2 * k + 1, q)
        acc = 0
        x = 1
        for c in coeffs:
            acc = (acc + c * x) % q
            x = x * root % q
        out.append(acc)
    return out


def make_psi_tables(q_list, logN: int):
    """Bit-reversed ψ / ψ^-1 power series per prime (plain ints):
    ``psi[c][j] = ψ_c^{bitrev(j, logN)} mod q_c``."""
    N = 1 << logN
    brind = [bit_reverse(i, logN) for i in range(N)]
    psi_out, ipsi_out = [], []
    for q in q_list:
        g = primitive_root_2N(q, N)
        gi = pow(g, -1, q)
        ps = [1] * N
        ips = [1] * N
        for i in range(1, N):
            ps[i] = ps[i - 1] * g % q
            ips[i] = ips[i - 1] * gi % q
        psi_out.append([ps[b] for b in brind])
        ipsi_out.append([ips[b] for b in brind])
    return psi_out, ipsi_out
