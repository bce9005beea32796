"""Device-resident CKKS parameter context.

The torch counterpart of ``tiberate_tpu/context/ntt_context.py``: every
parameter is ONE contiguous tensor over the full prime basis
``[scale primes..., base, specials...]``, ordered so that a *level view* is
a row slice:

* ordinary channels at level ``lvl``: rows ``lvl : P``
* with-special channels at level ``lvl``: rows ``lvl : P+S``

Row slices of a contiguous ``[C, N]`` tensor stay contiguous, so a level
view hands the CUDA kernels plain pointers.  Key-switch decomposition parts
are contiguous row ranges of the same tensors.

Basis-extension constants per part follow the reference math:
``Y_scalar[i] = L[i]^-1·R mod m[i+1]``, ``L_scalar[i][j] = L[i]·R mod m[j]``,
``L_enter[i][c] = L[i]·R^2 mod q_c`` over the full with-special basis.

There are no 4-step int8 limb tables and no Shoup companions: those exist
only because Mosaic lacks 64-bit vectors and products, and the Hopper NTT
is a butterfly NTT over one 64-bit (or, in the 30-bit mode, 32-bit) word
with a native wide product.
"""

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from tiberate_tpu_torch.context.mont_context import MontgomeryContext
from tiberate_tpu_torch.context.rns_partition import RnsPartition
from tiberate_tpu_torch.ops import mont
from tiberate_tpu_torch.ops import ntt as ntt_ops
from tiberate_tpu_torch.ops import ntt_kernels
from tiberate_tpu_torch.ops.mont import ModPack


def _col(vals, device, dtype):
    return torch.tensor(
        [int(v) for v in vals], dtype=dtype, device=device
    ).reshape(-1, 1)


@dataclass(frozen=True)
class LevelPack:
    """Everything the kernels need for one (level, include_special) view.

    ``pdc`` [C, 1+S] holds the P-division constants in the form the
    ``intt_pdiv`` kernel takes (see :class:`CkksParams`); zero on special
    rows, which are never P-divided.  ``fold`` and ``sum_runs`` are what
    K6's 62-bit lane needs to sum its products exactly
    (``ntt_kernels.sum_runs``): 2^64 mod q, and how many digits and parts
    a sum takes, from the largest modulus of the whole basis, so that
    every view of it holds the same.
    """

    pack: ModPack           # ql/qh/kl/kh/_2q [C, 1], q/k [C]
    psi: torch.Tensor       # [C, N] Montgomery-form bit-reversed twiddles
    ipsi: torch.Tensor      # [C, N]
    Ninv: torch.Tensor      # [C, 1] N^-1 R mod q
    Rs: torch.Tensor        # [C, 1] R^2 mod q
    Rs_scale: torch.Tensor  # [C, 1] R^2 * scale mod q
    pdc: torch.Tensor       # [C, 1+S] P-division constants
    fold: torch.Tensor      # [C] 2^64 mod q (K6, 62-bit lane)
    sum_runs: tuple         # (digits, parts) (K6, 62-bit lane)

    @property
    def num_channels(self):
        return self.psi.shape[0]

    def __getitem__(self, sl):
        """The channels ``sl`` selects: a slice (a view, contiguous rows)
        or a list of channel indices (a copy: a shard's rows)."""
        return LevelPack(
            pack=self.pack[sl],
            psi=self.psi[sl],
            ipsi=self.ipsi[sl],
            Ninv=self.Ninv[sl],
            Rs=self.Rs[sl],
            Rs_scale=self.Rs_scale[sl],
            pdc=self.pdc[sl],
            fold=self.fold[sl],
            sum_runs=self.sum_runs,
        )

    def to(self, device):
        return dataclasses.replace(
            self, pack=self.pack.to(device),
            **{f: getattr(self, f).to(device)
               for f in ("psi", "ipsi", "Ninv", "Rs", "Rs_scale", "pdc",
                         "fold")})


@dataclass(frozen=True)
class PartPack:
    """Key-switch decomposition part: basis-extension constants.

    ``g0`` is the part's first global prime index (contiguous); ``lo/hi``
    the local row range into the *ordinary* data at this level.
    """

    lo: int
    hi: int
    g0: int
    Y_scalar: torch.Tensor | None   # [alpha-1, 1] (mod m[i+1])
    L_scalar: tuple                 # tuple of [alpha-i-2, 1] tensors
    L_enter: torch.Tensor | None    # [alpha-1, P+S, 1]

    @property
    def alpha(self):
        return self.hi - self.lo

    def to(self, device):
        return dataclasses.replace(
            self,
            Y_scalar=None if self.Y_scalar is None
            else self.Y_scalar.to(device),
            L_scalar=tuple(t.to(device) for t in self.L_scalar),
            L_enter=None if self.L_enter is None
            else self.L_enter.to(device),
        )


class CkksParams:
    """Host-built parameter bundle for one config, resident on ``device``.

    Every tensor is in the storage dtype of ``cfg.buffer_bit_length``: int64
    with R = 2^62, or int32 with R = 2^30 (the 30-bit mode).
    """

    def __init__(self, cfg, device):
        if cfg.buffer_bit_length not in mont.DTYPES:
            raise ValueError(
                f"buffer_bit_length={cfg.buffer_bit_length}: 30 or 62"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.montCtx = MontgomeryContext.from_ckks_config(cfg)
        self.num_ordinary_primes = cfg.num_scales + 1
        self.num_special_primes = cfg.num_special_primes
        self.rnsPart = RnsPartition(
            self.num_ordinary_primes, self.num_special_primes, 1
        )

        P = self.num_ordinary_primes
        S = self.num_special_primes
        N = cfg.N
        R = self.montCtx.R
        q = self.montCtx.q
        self.q = q
        self.P = P
        self.S = S
        self.N = N
        self.logN = cfg.logN
        self.dtype = mont.DTYPES[cfg.buffer_bit_length]
        dev = self.device

        def col(vals):
            return _col(vals, dev, self.dtype)

        # --- full-basis parameter tensors ------------------------------
        self.pack = ModPack.from_q(q, R_bits=cfg.buffer_bit_length,
                                   device=dev)
        psi, ipsi = ntt_ops.make_psi_tables(q, cfg.logN)
        self.psi = self._mont_table(psi, q, R)
        self.ipsi = self._mont_table(ipsi, q, R)
        self.Ninv = col([pow(N, -1, qi) * R % qi for qi in q])
        self.Rs = col(self.montCtx.R_square)
        self.Rs_scale = col(
            [(Rsq * cfg.int_scale) % qi
             for Rsq, qi in zip(self.montCtx.R_square, q)]
        )

        self.num_levels = cfg.num_scales  # usable multiplicative levels

        # --- key-switch part structure per level -----------------------
        # Parts partition the *ordinary* primes [lvl..P-1] into contiguous
        # groups aligned to the fixed level-0 partitioning (groups of S,
        # plus the base prime as its own part).
        self.parts = []          # parts[lvl] = list[PartPack]
        self.parts_alloc = []    # parts_alloc[lvl] = list of global part ids
        for lvl in range(self.num_levels):
            self.parts.append(self._build_parts(lvl))
            first_part = lvl // S if S > 0 else 0
            n_parts = len(self.parts[lvl])
            self.parts_alloc.append(
                list(range(first_part, first_part + n_parts))
            )

        # --- rescale constants -----------------------------------------
        # rescale_scales[lvl][c] = q_lvl^-1 * R mod q_i for i in [lvl+1..P-1]
        self.rescale_scales = []
        for lvl in range(self.num_levels):
            m0 = q[lvl]
            self.rescale_scales.append(
                col([pow(m0, -1, q[i]) * R % q[i] for i in range(lvl + 1, P)])
            )

        # --- keyswitch P-division constants ----------------------------
        # PiRs[lvl][P_ind]: P_j^-1 * R mod q_i over with-special channels
        # at the level, zero-padded on the top P_ind+1 rows.  The plain
        # division chain (and the special-row phase of _pdiv_fused) uses
        # these.
        P_primes = q[P : P + S][::-1]
        self.PiRs = []
        for lvl in range(self.num_levels):
            dest = list(range(lvl, P)) + list(range(P, P + S))
            per_level = []
            for P_ind, Pj in enumerate(P_primes):
                cover = dest[: len(dest) - P_ind - 1]
                vals = [pow(Pj, -1, q[i]) * R % q[i] for i in cover]
                vals += [0] * (P_ind + 1)
                per_level.append(col(vals))
            self.PiRs.append(per_level)

        # mont_PR[c] = P * R mod q_c over ordinary channels at level 0.
        P_prod = math.prod(P_primes)
        self.mont_PR = col([(P_prod * R) % q[i] for i in range(P)])

        # P-division in affine form for the intt_pdiv kernel: the
        # successive rescale x_{i+1} = (x_i - p0_i) * P_i^-1 unrolls to
        #   out = x * prod_j P_j^-1 - sum_i p0_i * c_i,
        #   c_i = prod_{j>=i} P_j^-1.
        # The kernel holds x in Montgomery form (x*R, the "mont" iNTT) and
        # the p0 rows plain, and multiplies by REDC, so it takes
        #   pdc[c] = [prod_j P_j^-1,  c_0*R, ..., c_{S-1}*R]  (mod q_c).
        pdc_rows = []
        for ci, qi in enumerate(q):
            if ci >= P:   # special rows are never P-divided
                pdc_rows.append([0] * (1 + S))
                continue
            cx = 1
            for Pj in P_primes:
                cx = cx * pow(Pj, -1, qi) % qi
            row = [cx]
            for i in range(S):
                v = 1
                for Pj in P_primes[i:]:
                    v = v * pow(Pj, -1, qi) % qi
                row.append(v * R % qi)
            pdc_rows.append(row)
        self.pdc = torch.tensor(pdc_rows, dtype=self.dtype, device=dev)

        # K6's sums (62-bit lane): the fold word and the runs, checked
        # here once for every level
        fold = torch.tensor([(1 << 64) % qi for qi in q], dtype=self.dtype,
                            device=dev)
        runs = (ntt_kernels.sum_runs(q) if self.dtype == torch.int64
                else (0, 0))
        self._full = LevelPack(
            pack=self.pack, psi=self.psi, ipsi=self.ipsi,
            Ninv=self.Ninv, Rs=self.Rs, Rs_scale=self.Rs_scale,
            pdc=self.pdc, fold=fold, sum_runs=runs,
        )
        self._lp_cache = {}

        # --- decode constants ------------------------------------------
        scale = cfg.scale
        self.alpha = [
            (scale / np.float64(qi)) ** 2 for qi in q[: cfg.num_scales]
        ]
        self.deviations = [1.0]
        for al in self.alpha:
            self.deviations.append(self.deviations[-1] ** 2 * al)

        self.final_q = [q[lvl] for lvl in range(self.num_levels)]
        self.final_alpha = [
            (scale / np.float64(fq)) for fq in self.final_q
        ]
        self.corrections = [
            1.0 / (d * fa)
            for d, fa in zip(self.deviations, self.final_alpha)
        ]
        self.base_prime = q[P - 1]
        self.final_scalar = [
            col([pow(fq, -1, self.base_prime) * R % self.base_prime])
            for fq in self.final_q
        ]

    def _mont_table(self, table, q, R):
        arr = np.array(
            [[p * R % qi for p in row] for row, qi in zip(table, q)],
            dtype=self.cfg.numpy_dtype,
        )
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------------------------

    def lp(self, lvl: int, special: bool) -> LevelPack:
        """Level view: channel row slice of the full parameter tensors."""
        key = (lvl, special)
        if key not in self._lp_cache:
            # with-special view = rows [lvl:P] ++ [P:P+S] == rows [lvl:],
            # because specials sit at the end of the basis.
            sl = slice(lvl, None) if special else slice(lvl, self.P)
            self._lp_cache[key] = self._full[sl]
        return self._lp_cache[key]

    def base_lp(self) -> LevelPack:
        """The base-prime-only view (last ordinary channel)."""
        return self._full[self.P - 1 : self.P]

    def part_lp(self, part: PartPack, lvl: int) -> LevelPack:
        """Level view of one part's primes (contiguous global rows)."""
        return self._full[part.g0 : part.g0 + part.alpha]

    # ------------------------------------------------------------------

    def _build_parts(self, lvl):
        """Parts over ordinary primes [lvl..P-1], aligned to the fixed
        level-0 grouping: group i covers global primes [iS..(i+1)S), the
        base prime is its own part."""
        P, S = self.P, self.S
        out = []
        gi = lvl // S
        while gi * S < P - 1:
            glo = max(gi * S, lvl)
            ghi = min((gi + 1) * S, P - 1)
            if ghi > glo:
                out.append(self._make_part(glo, ghi, glo - lvl))
            gi += 1
        out.append(self._make_part(P - 1, P, P - 1 - lvl))
        return out

    def _make_part(self, glo, ghi, local_lo):
        """Basis-extension constants for primes [glo..ghi)."""
        alpha = ghi - glo
        q = self.q
        R = self.montCtx.R
        m = [q[i] for i in range(glo, ghi)]
        P, S = self.P, self.S
        dev = self.device

        if alpha == 1:
            return PartPack(
                lo=local_lo, hi=local_lo + 1, g0=glo,
                Y_scalar=None, L_scalar=(), L_enter=None,
            )

        L = [m[0]]
        for i in range(1, alpha - 1):
            L.append(L[-1] * m[i])

        Y_scalar = []
        L_scalar = []
        for i in range(alpha - 1):
            Y_scalar.append(pow(L[i], -1, m[i + 1]) * R % m[i + 1])
            if (i + 2) < alpha:
                L_scalar.append(
                    _col([(L[i] * R) % m[j] for j in range(i + 2, alpha)],
                         dev, self.dtype)
                )

        L_enter = torch.tensor(
            [
                [(L[i] * self.montCtx.R_square[c]) % q[c]
                 for c in range(P + S)]
                for i in range(alpha - 1)
            ],
            dtype=self.dtype, device=dev,
        )[..., None]

        return PartPack(
            lo=local_lo, hi=local_lo + alpha, g0=glo,
            Y_scalar=_col(Y_scalar, dev, self.dtype),
            L_scalar=tuple(L_scalar),
            L_enter=L_enter,
        )
