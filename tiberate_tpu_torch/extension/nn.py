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
  Newton reciprocal square root; depth 3 + 3 * iters + 2 levels, one
  more with gamma.  It takes a list of ciphertexts or one stacked
  ciphertext ``[F, ...]``.
* :class:`HEFeedForwardFeatureWise`: a transformer's feed-forward
  sub-layer with MPCFormer's Quad activation over one stack of feature
  ciphertexts, by two stacked linear ops (``CkksEngine.mult_matrix``);
  depth 3 levels.
"""

import math

import numpy as np
import torch

from tiberate_tpu_torch.extension.packing import (
    FeatureWisePacking,
    PackedCT,
    PackingMetadata,
)
from tiberate_tpu_torch.typing import Ciphertext, Plaintext
from tiberate_tpu_torch.utils.trace import annotate

# The stacked LayerNorm runs its per-feature work in chunks of the stack,
# so that what a chunk holds in flight stays under STEP_BUDGET_BYTES.  A
# chunk's pass holds at most STEP_TRANSIENT_CTS times the bytes of its
# ciphertexts at the centred level beyond its inputs and outputs (torch's
# peak allocation over the pass, on an H100 at logN15, stacks of 32 to
# 128): the centring (level_up to 1, cc_sub) 84 MiB a feature, 10.5 times
# a level-1 ciphertext; the fused cc_mult step at level 1 76.5 MiB, 9.6
# times; at level 13 6 times its smaller input.
STEP_BUDGET_BYTES = 8 << 30
STEP_TRANSIENT_CTS = 11


# The feed-forward sub-layer streams over blocks of its intermediate
# features: a block's h, its square, its linear term and its activation
# are FFN_BLOCK_CTS ciphertexts a feature at h's level at most, kept under
# FFN_BUDGET_BYTES (512 features at logN15, level 1; the block's squares
# run in stack_chunk chunks inside it).
FFN_BUDGET_BYTES = 16 << 30
FFN_BLOCK_CTS = 4


def stack_chunk(engine, level: int) -> int:
    """Stacked ciphertexts a chunk centred at ``level``: the transients of
    one, STEP_TRANSIENT_CTS times a ciphertext's bytes there, into
    STEP_BUDGET_BYTES (93 at logN15, level 1)."""
    cfg = engine.ckksCfg
    word = np.dtype(cfg.numpy_dtype).itemsize
    ct_bytes = 2 * (engine.params.P - level) * cfg.N * word
    return max(1, STEP_BUDGET_BYTES // (STEP_TRANSIENT_CTS * ct_bytes))


def ffn_block(engine, level: int) -> int:
    """Intermediate features a block of the feed-forward sub-layer whose
    h lies at ``level``: FFN_BLOCK_CTS ciphertexts a feature there into
    FFN_BUDGET_BYTES (512 at logN15, level 1)."""
    cfg = engine.ckksCfg
    word = np.dtype(cfg.numpy_dtype).itemsize
    ct_bytes = 2 * (engine.params.P - level) * cfg.N * word
    return max(1, FFN_BUDGET_BYTES // (FFN_BLOCK_CTS * ct_bytes))


def _rows(ct, start, stop):
    """Stacked ciphertexts ``start:stop`` of ``ct`` (views)."""
    return Ciphertext(data=tuple(d[start:stop] for d in ct.data),
                      level=ct.level, **ct.misc)


def _cat(cts):
    """One stack of the stacked ciphertexts ``cts``, in order."""
    if len(cts) == 1:
        return cts[0]
    return Ciphertext(data=tuple(torch.cat([c.data[i] for c in cts])
                                 for i in (0, 1)),
                      level=cts[0].level, **cts[0].misc)


def tree_sum(engine, ct):
    """The sum of a stack's ciphertexts by a halving tree of ``cc_add``s
    (exact in [0, q): the residues of the sequential sum), unstacked."""
    n = ct.data[0].shape[0]
    while n > 1:
        h = n // 2
        s = engine.cc_add(_rows(ct, 0, h), _rows(ct, h, 2 * h))
        ct = _cat([s, _rows(ct, 2 * h, n)]) if n % 2 else s
        n = h + n % 2
    return Ciphertext(data=tuple(d[0] for d in ct.data), level=ct.level,
                      **ct.misc)


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
    feature, or one row of a stacked ciphertext), so every reduction is a
    ciphertext add and no rotation is needed.

        out_f = gamma_f * (x_f - mu) * rsqrt(var + eps) + beta_f

    The reciprocal square root runs Newton's method on g(y) = y^-2 - v,

        y_{k+1} = y_k * (1.5 - (v/2) * y_k^2),

    seeded with the two-point linear fit of 1/sqrt(v) over the declared
    variance range ``var_range``.

    Multiplicative depth: 3 + 3*iters + 2 levels, one more with gamma
    (its ``mult_scalar`` rescales).

    A stacked input ``[F, 2-tuple of [C, N]]`` gives a stacked output
    whose row f has the residues of the list forward's feature f: the
    feature sums are halving trees of ``cc_add`` (exact), ``mu`` and
    ``y`` are broadcast against the stack, the per-feature work runs in
    chunks of :func:`stack_chunk` features, gamma and beta are one
    per-row ``mult_scalar`` and ``add_scalar``; the Newton chain on the
    single ``v`` and ``y`` is the list forward's.  Traced as the span
    ``layernorm`` with the children ``layernorm.mean``,
    ``layernorm.center``, ``layernorm.square``, ``layernorm.var``,
    ``layernorm.rsqrt`` and ``layernorm.out``.
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
        """fcts: list of F ciphertexts (one per feature, same level), or
        one stacked ciphertext of F rows.  Returns the normalized list, or
        stack (all at a deeper common level)."""
        if isinstance(fcts, Ciphertext):
            return self._forward_stacked(fcts)
        eng = self.engine
        F = len(fcts)

        with annotate("layernorm"):
            # mean over the feature axis (ciphertext adds + one scalar
            # mult)
            with annotate("layernorm.mean"):
                s = fcts[0]
                for f in range(1, F):
                    s = eng.cc_add(s, fcts[f])
                mu = eng.mult_scalar(s, 1.0 / F)

            # centered features and variance
            with annotate("layernorm.center"):
                d = [eng.cc_sub(eng.level_up(x, mu.level), mu) for x in fcts]
            with annotate("layernorm.square"):
                sq = [eng.cc_mult(df, df) for df in d]
                v = sq[0]
                for f in range(1, F):
                    v = eng.cc_add(v, sq[f])
            with annotate("layernorm.var"):
                v = self._var(v, F)

            with annotate("layernorm.rsqrt"):
                y = self._rsqrt(v)

            with annotate("layernorm.out"):
                out = []
                for f in range(F):
                    z = eng.cc_mult(eng.level_up(d[f], y.level), y)
                    if self.gamma is not None:
                        z = eng.mult_scalar(z, float(self.gamma[f]))
                    if self.beta is not None:
                        z = eng.add_scalar(z, float(self.beta[f]))
                    out.append(z)
        return out

    def _var(self, sum_sq, F):
        eng = self.engine
        v = eng.mult_scalar(sum_sq, 1.0 / F)
        return eng.add_scalar(v, self.eps)

    def _rsqrt(self, v):
        """y ~= rsqrt(v): linear seed, then Newton (one ciphertext)."""
        eng = self.engine
        y = eng.add_scalar(eng.mult_scalar(v, self._y0_b), self._y0_a)
        vh = eng.mult_scalar(v, 0.5)
        for _ in range(self.iters):
            y2 = eng.cc_mult(y, y)
            p = eng.cc_mult(eng.level_up(vh, y2.level), y2)
            w = eng.add_scalar(eng.negate(p), 1.5)
            y = eng.cc_mult(eng.level_up(y, w.level), w)
        return y

    def _forward_stacked(self, x):
        eng = self.engine
        F = x.data[0].shape[0]

        with annotate("layernorm"):
            with annotate("layernorm.mean"):
                mu = eng.mult_scalar(tree_sum(eng, x), 1.0 / F)

            n = stack_chunk(eng, mu.level)
            with annotate("layernorm.center"):
                d = [eng.cc_sub(eng.level_up(_rows(x, i, i + n), mu.level),
                                mu) for i in range(0, F, n)]

            # the squares' sum: each chunk's by a tree, then chunk by
            # chunk (exact, so the list forward's residues)
            with annotate("layernorm.square"):
                v = None
                for dc in d:
                    part = tree_sum(eng, eng.cc_mult(dc, dc))
                    v = part if v is None else eng.cc_add(v, part)
            with annotate("layernorm.var"):
                v = self._var(v, F)

            with annotate("layernorm.rsqrt"):
                y = self._rsqrt(v)

            with annotate("layernorm.out"):
                z = []
                while d:   # each chunk of d freed once it is used
                    z.append(eng.cc_mult(eng.level_up(d.pop(0), y.level),
                                         y))
                z = _cat(z)
                if self.gamma is not None:
                    z = eng.mult_scalar(z, self.gamma)
                if self.beta is not None:
                    z = eng.add_scalar(z, self.beta)
        return z


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


class HEFeedForwardFeatureWise(HEModule):
    """A transformer's feed-forward sub-layer over one stack of feature
    ciphertexts (features as ciphertexts, tokens in the slots), with
    MPCFormer's Quad in the place of GELU:

        y = x + w2^T quad(w1^T x + b1) + b2,
        quad(h) = 0.125 h^2 + 0.25 h + 0.5,

    ``w1`` [H, I], ``b1`` [I], ``w2`` [I, H], ``b2`` [H]: H hidden and I
    intermediate features.  The circuit, for x [H] at level l:

    * up, at level l: ``g = mult_matrix(x, s w1, s b1)`` with s =
      sqrt(0.125): the weights and bias scaled so that g = s h; one
      rescale, so g lies at l + 1;
    * Quad, at level l + 1: ``g2 = cc_mult(g, g)`` = 0.125 h^2 (the
      tensor product's rescale: level l + 2), in chunks of
      :func:`stack_chunk` features; ``u = mult_scalar(g, 0.25 / s)`` =
      0.25 h (its rescale: level l + 2, the square's scale, so the two
      add); ``a = add_scalar(cc_add(g2, u), 0.5)``;
    * down, at level l + 2: ``w2^T a`` summed unrescaled over the blocks,
      then one rescale and ``b2`` a row (``add_scalar``): level l + 3;
    * residual: ``cc_add(level_up(x, l + 3), down)``.

    So 0.125 is folded into the up weights' encoding, 0.25 is one
    ``mult_scalar`` and 0.5 one ``add_scalar``; the output lies at l + 3.
    The intermediate features stream in blocks of :func:`ffn_block`: a
    block's g, squares, linear term and activation are made, and its down
    product added into the accumulator, before the next block starts.  The residues do not depend on the block (the
    sums are exact modular sums).  The encoded weights are made once a
    level and kept (``weights(level)``).  Traced as the span ``ffn`` with
    the children ``ffn.up``, ``ffn.act``, ``ffn.down`` and
    ``ffn.residual``.
    """

    QUAD = (0.125, 0.25, 0.5)

    def __init__(self, w1, b1, w2, b2, engine):
        self.engine = engine
        self.w1 = np.asarray(w1, dtype=np.float64)
        self.w2 = np.asarray(w2, dtype=np.float64)
        H, I = self.w1.shape
        if self.w2.shape != (I, H):
            raise ValueError(f"w1 {self.w1.shape} and w2 {self.w2.shape}: "
                             f"want [H, I] and [I, H]")
        self.b1 = np.asarray(b1, dtype=np.float64).reshape(I)
        self.b2 = np.asarray(b2, dtype=np.float64).reshape(H)
        self.hidden, self.intermediate = H, I
        c2, c1, self.c0 = self.QUAD
        self.s = math.sqrt(c2)
        self.lin = c1 / self.s
        self._weights = {}

    def blocks(self, level: int):
        """The intermediate features' blocks for an input at ``level``."""
        n = ffn_block(self.engine, level + 1)
        return [(i, min(i + n, self.intermediate))
                for i in range(0, self.intermediate, n)]

    def weights(self, level: int):
        """Per block, the encoded (up, down) weights for an input at
        ``level``: made on first use and kept."""
        if level not in self._weights:
            eng = self.engine
            self._weights[level] = [
                (eng.encode_matrix(self.s * self.w1[:, i:j], level),
                 eng.encode_matrix(self.w2[i:j], level + 2))
                for i, j in self.blocks(level)]
        return self._weights[level]

    def forward(self, x: Ciphertext, **kwargs) -> Ciphertext:
        """x: one stacked ciphertext of H rows; returns the stack of H
        outputs, three levels down."""
        eng = self.engine
        if x.data[0].shape[0] != self.hidden:
            raise ValueError(f"{x.data[0].shape[0]} features for a layer of "
                             f"{self.hidden}")
        weights = self.weights(x.level)
        acc = None
        with annotate("ffn"):
            for (i, j), (up, down) in zip(self.blocks(x.level), weights):
                with annotate("ffn.up"):
                    g = eng.mult_matrix(x, up, self.s * self.b1[i:j])
                with annotate("ffn.act"):
                    n = stack_chunk(eng, g.level)
                    g2 = _cat([eng.cc_mult(c, c) for c in
                               (_rows(g, k, k + n)
                                for k in range(0, j - i, n))])
                    u = eng.mult_scalar(g, self.lin)
                    del g
                    a = eng.add_scalar(eng.cc_add(g2, u), self.c0)
                    del g2, u
                with annotate("ffn.down"):
                    acc = eng._matrix_sum(a, down, acc)
                    del a
            with annotate("ffn.down"):
                y = eng.add_scalar(eng.rescale(acc), self.b2)
                del acc
            with annotate("ffn.residual"):
                out = eng.cc_add(eng.level_up(x, y.level), y)
        return out
