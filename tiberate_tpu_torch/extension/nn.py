"""HE-NN building blocks: encrypted layers over packed ciphertexts.

The torch counterpart of ``tiberate_tpu/extension/nn.py``, with its class
names and call signatures.  The layers are plain classes, not
``torch.nn.Module``: they hold ciphertexts and :class:`Plaintext` rows,
not parameters with gradients, and nothing here trains.

* :class:`HELinearFeatureWise`: a square-weight linear layer over
  feature-wise packed inputs, ``out[j] = sum_i x[i] * W[j, i]``, by one
  ``pc_mult`` per weight row, a log2(period) rotate-and-sum, a mask of
  every period-th slot and a rotation into output position ``j``.  The
  weight rows are :class:`Plaintext` objects, so repeated forwards reuse
  their per-level encode cache.
* :class:`HELayerNormFeatureWise`: LayerNorm over feature-wise packed
  inputs (one ciphertext per feature, samples in the slots), with a
  Newton reciprocal square root; depth 3 + 3 * iters + 2 levels.
"""

import math

import numpy as np

from tiberate_tpu_torch.extension.packing import (
    FeatureWisePacking,
    PackedCT,
    PackingMetadata,
)
from tiberate_tpu_torch.typing import Plaintext


class HEModule:
    """Interface of the encrypted-inference modules."""

    def forward(self, ct_in, **kwargs):
        raise NotImplementedError

    def __call__(self, ct_in, **kwargs):
        return self.forward(ct_in, **kwargs)


class HELinear(HEModule):
    pass


class HELayerNorm(HEModule):
    """LayerNorm interface; :class:`HELayerNormFeatureWise` implements
    it."""


class HELayerNormFeatureWise(HELayerNorm):
    """Encrypted LayerNorm over feature-wise packed inputs: samples fill
    the slot axis, features are separate ciphertexts (one list entry per
    feature), so every reduction is a ciphertext add and no rotation is
    needed.

        out_f = gamma_f * (x_f - mu) * rsqrt(var + eps) + beta_f

    The reciprocal square root runs Newton's method on g(y) = y^-2 - v,

        y_{k+1} = y_k * (1.5 - (v/2) * y_k^2),

    seeded with the two-point linear fit of 1/sqrt(v) over the declared
    variance range ``var_range``.

    Multiplicative depth: 3 + 3*iters + 2 levels.
    """

    def __init__(self, gamma, beta, engine, eps: float = 1e-3,
                 var_range=(0.25, 2.0), iters: int = 2):
        self.engine = engine
        self.gamma = None if gamma is None else np.asarray(
            gamma, dtype=np.float64).reshape(-1)
        self.beta = None if beta is None else np.asarray(
            beta, dtype=np.float64).reshape(-1)
        self.eps = float(eps)
        self.iters = int(iters)
        lo, hi = var_range
        if not 0 < lo < hi:
            raise ValueError("var_range must be a positive interval")
        self.var_range = (float(lo), float(hi))
        # two-point linear fit of 1/sqrt(v) on [lo, hi]
        b = (hi ** -0.5 - lo ** -0.5) / (hi - lo)
        a = lo ** -0.5 - b * lo
        self._y0_a, self._y0_b = a, b

    def forward(self, fcts, **kwargs):
        """fcts: list of F ciphertexts (one per feature, same level).
        Returns the normalized list (all at a deeper common level)."""
        eng = self.engine
        F = len(fcts)

        # mean over the feature axis (ciphertext adds + one scalar mult)
        s = fcts[0]
        for f in range(1, F):
            s = eng.cc_add(s, fcts[f])
        mu = eng.mult_scalar(s, 1.0 / F)

        # centered features and variance
        d = [eng.cc_sub(eng.level_up(x, mu.level), mu) for x in fcts]
        sq = [eng.cc_mult(df, df) for df in d]
        v = sq[0]
        for f in range(1, F):
            v = eng.cc_add(v, sq[f])
        v = eng.mult_scalar(v, 1.0 / F)
        v = eng.add_scalar(v, self.eps)

        # y ~= rsqrt(v): linear seed, then Newton
        y = eng.add_scalar(eng.mult_scalar(v, self._y0_b), self._y0_a)
        vh = eng.mult_scalar(v, 0.5)
        for _ in range(self.iters):
            y2 = eng.cc_mult(y, y)
            p = eng.cc_mult(eng.level_up(vh, y2.level), y2)
            w = eng.add_scalar(eng.negate(p), 1.5)
            y = eng.cc_mult(eng.level_up(y, w.level), w)

        out = []
        for f in range(F):
            z = eng.cc_mult(eng.level_up(d[f], y.level), y)
            if self.gamma is not None:
                z = eng.mult_scalar(z, float(self.gamma[f]))
            if self.beta is not None:
                z = eng.add_scalar(z, float(self.beta[f]))
            out.append(z)
        return out


class HELinearFeatureWise(HELinear):
    """Square-weight linear layer, feature-wise packed input and output."""

    def __init__(self, weight: np.ndarray, bias, engine):
        weight = np.asarray(weight, dtype=np.float64)
        if weight.ndim != 2 or weight.shape[0] != weight.shape[1]:
            raise ValueError(f"square weight required, got {weight.shape}")
        self.engine = engine
        self.dim = weight.shape[0]
        num_slots = engine.num_slots
        self.logical = FeatureWisePacking.find_logical_num_slots(
            num_slots, self.dim
        )
        self.fold = max(self.logical // num_slots, 1)

        # weight row j (the j-th output's coefficients), packed as the
        # input rows are
        packed_w = FeatureWisePacking.pack(
            weight, num_slots, self.logical
        )  # [dim, fold, num_slots]
        self.weight_rows = [
            [Plaintext(packed_w[j, f]) for f in range(self.fold)]
            for j in range(self.dim)
        ]

        if bias is not None:
            bias = np.asarray(bias, dtype=np.float64).reshape(-1)
            if bias.shape[0] != self.dim:
                raise ValueError(f"bias of {bias.shape[0]} for {self.dim} "
                                 f"outputs")
            packed_b = FeatureWisePacking.pack(
                bias.reshape(1, -1), num_slots, self.logical
            )[0]
            self.bias_rows = [
                Plaintext(packed_b[f]) for f in range(self.fold)
            ]
        else:
            self.bias_rows = None

        # the mask of every logical-period-th slot (the reduction leaves
        # the row's dot product there)
        period = min(self.logical, num_slots)
        mask = np.zeros(num_slots)
        mask[::period] = 1.0
        self.mask = Plaintext(mask)
        self.period = period

    @classmethod
    def from_weight(cls, weight, bias, engine):
        return cls(weight, bias, engine)

    def _reduce_row(self, ct):
        """Rotate-and-sum so that slot 0 holds the row's dot product."""
        eng = self.engine
        out = ct
        for r in range(int(math.log2(self.period))):
            rot = eng.rotate_single(out, eng.get_rotation_key(-(2**r)))
            out = eng.cc_add(rot, out)
        return out

    def forward(self, ct_in: PackedCT, memory_save: bool = False) -> PackedCT:
        eng = self.engine
        num_slots = eng.num_slots
        out_rows = []
        for row_cts in ct_in.cts:  # each logical input row (list of folds)
            acc = [None] * self.fold  # the output row, per fold position
            for j in range(self.dim):
                # partial = sum over folds of <x_f, w_jf>
                partial = None
                for f in range(self.fold):
                    prod = eng.pc_mult(self.weight_rows[j][f], row_cts[f])
                    partial = (prod if partial is None
                               else eng.cc_add(partial, prod))
                summed = self._reduce_row(partial)
                masked = eng.pc_mult(self.mask, summed)
                # place the scalar at output position j
                f_out, s_out = divmod(j, num_slots)
                if s_out:
                    masked = eng.rotate_single(
                        masked, eng.get_rotation_key(s_out)
                    )
                acc[f_out] = (masked if acc[f_out] is None
                              else eng.cc_add(acc[f_out], masked))
            if self.bias_rows is not None:
                acc = [
                    eng.pc_add(self.bias_rows[f], acc[f])
                    for f in range(self.fold)
                ]
            out_rows.append(acc)

        return PackedCT(
            cts=out_rows,
            metadata=PackingMetadata(
                original_shape=ct_in.metadata.original_shape,
                logical_num_slots=self.logical,
                packed_by=FeatureWisePacking,
                encoded_by=ct_in.metadata.encoded_by,
            ),
        )
