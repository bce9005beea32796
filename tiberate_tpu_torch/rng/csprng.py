"""Counter-mode ChaCha20 CSPRNG with fused range-mapping samplers.

The torch counterpart of ``tiberate_tpu/rng/csprng.py``, bit-identical to
it for the same seed and nonce.  The channel model is the same:

* state rows = (channels + repeating_channels) x L, L = N/4; each row is
  one ChaCha20 block (16 words) yielding 4 samples,
* row counters are the global stream index, so *repeating* channels give
  the same stream on every shard without communication,
* after each generation the targeted rows' counters advance by
  ``inc = (total_channels + repeating) * L``.

Samplers:

* ``randint``: 128-bit uniform (4 words, layout w0:b32-63 w1:b0-31
  w2:b96-127 w3:b64-95) -> ``(u * q) >> 128`` multiply-shift into
  [0, q), plus shift,
* ``discrete_gaussian``: 127-bit uniform CDT binary-tree inversion
  (σ=3.2), sign from the LSB of the high word,
* ``randround``: stochastic rounding of f64 coefficients against 32-bit
  uniform thresholds (round-half-to-even on frac*2^32).

Words are ``int64`` tensors holding 32-bit values; the 64-bit quantities of
the samplers are ``int64`` tensors holding the unsigned bit pattern (torch
has no ``uint64`` arithmetic): products wrap mod 2^64 as ``uint64`` does,
every right shift of such a pattern is made logical with a mask, and the
one unsigned comparison flips the sign bit on both sides.  The states live
on ``device`` and every draw runs there: on the card as one kernel of
``csrc/csprng.cu`` (R1-R4, :mod:`tiberate_tpu_torch.ops.csprng_kernels`),
on the CPU as the plain torch functions of this module and of
:mod:`~tiberate_tpu_torch.rng.chacha20`, which the kernels' wrappers run
there.
"""

import os

import numpy as np
import torch

from tiberate_tpu_torch.ops import csprng_kernels as ck
from tiberate_tpu_torch.rng.chacha20 import (
    M32,
    NOTHING_UP_MY_SLEEVE,
    chacha20_block,
    step_counter,
)
from tiberate_tpu_torch.rng.discrete_gaussian_sampler import (
    build_CDT_binary_search_tree,
)
from tiberate_tpu_torch.rng.interface import RandNumGen

_I64 = torch.int64
_SIGN = -(1 << 63)      # bit 63 alone, as an int64


def _shr(x, n):
    """Logical right shift of an int64 bit pattern (torch's ``>>`` is
    arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _umul64hi(a, b):
    """High 64 bits of a 64x64-bit unsigned product, via 32-bit halves."""
    al = a & M32
    ah = _shr(a, 32)
    bl = b & M32
    bh = _shr(b, 32)
    lo = al * bl
    mid1 = al * bh
    mid2 = ah * bl
    hi = ah * bh
    carry = (_shr(lo, 32) + (mid1 & M32) + (mid2 & M32)) >> 32
    return hi + _shr(mid1, 32) + _shr(mid2, 32) + carry


def _words_to_u128_parts(w):
    """[..., 16] keystream words -> (x_low, x_hi_lo, x_hi_hi) per sample,
    each [..., 4]: for sample i of 4, from words 4i..4i+3,
    x_low = (w0 << 32) | w1 (bits 0..63), w3 = bits 64..95,
    w2 = bits 96..127."""
    w = w.reshape(*w.shape[:-1], 4, 4)
    x_low = (w[..., 0] << 32) | w[..., 1]
    return x_low, w[..., 3], w[..., 2]


def _randint_from_words(words, q, shift: int):
    """words: [rows, 16]; q: [rows] (or [1]) moduli below 2^63 -> samples
    [rows, 4] int64: (u128 * q) >> 128 + shift, the carry chain of the
    JAX package's ``_randint_from_words``."""
    x_low, xhl, xhh = _words_to_u128_parts(words)
    p = q.reshape(-1, 1)
    alpha = _umul64hi(p, x_low)
    pl = p & M32
    ph = _shr(p, 32)
    plxhl = pl * xhl
    plxhh = pl * xhh
    phxhl = ph * xhl
    phxhh = ph * xhh
    carry = ((plxhl & M32) + (alpha & M32)) >> 32
    carry = (
        carry + _shr(plxhl, 32) + _shr(alpha, 32) + (phxhl & M32)
        + (plxhh & M32)
    ) >> 32
    sample = carry + _shr(phxhl, 32) + _shr(plxhh, 32) + phxhh
    if shift:
        sample = sample + shift
    return sample


def _dgauss_from_words(words, btree_lo, btree_hi, depth: int):
    """CDT inversion sampling.  words [rows, 16] -> samples [rows, 4]
    int64; btree_lo / btree_hi: the tree's 64-bit halves as int64 bit
    patterns (every high half below 2^63)."""
    x_low, xhl, xhh = _words_to_u128_parts(words)
    x_high = (xhh << 32) | xhl
    sign_bit = x_high & 1
    x_high = _shr(x_high, 1)
    # unsigned x_low >= node_lo as a signed compare: flip both sign bits
    x_low = x_low ^ _SIGN
    lo_flipped = btree_lo ^ _SIGN

    current = torch.zeros_like(x_low)
    counter = 0
    jump = 1
    for _ in range(depth):
        node_lo = lo_flipped[counter + current]
        node_hi = btree_hi[counter + current]
        ge = (x_high > node_hi) | ((x_high == node_hi) & (x_low >= node_lo))
        current = 2 * current + ge.to(_I64)
        counter += jump
        jump *= 2
    return (sign_bit * 2 - 1) * current


def _encrypt_noise_core(rows_t, rows_u, btree_lo, btree_hi, amax: int,
                        B: int, depth: int, inc: int):
    """The plain version of :meth:`Csprng.encrypt_noise_batch`'s draws
    (``ops.csprng_kernels.encrypt_noise`` runs it on CPU tensors): ChaCha
    the B-replicated counter trajectories of the two repeating channels
    (one block call for all of them) and sample.  A k-fold counter advance as
    ONE 32-bit add carries exactly like k sequential ``step_counter``
    calls while ``k * inc < 2^32``."""
    if 2 * B * inc > M32:
        raise OverflowError(f"2 * B * inc = {2 * B * inc} exceeds the "
                            f"32-bit counter step")
    L = rows_t.shape[0]
    ks = torch.arange(B, dtype=_I64, device=rows_t.device)[:, None]
    tA = step_counter(rows_t, 2 * ks * inc)         # e0 (channel t)
    tB = step_counter(rows_u, ks * inc)             # e1 (channel u)
    tR = step_counter(rows_t, (2 * ks + 1) * inc)   # v  (channel t again)
    words = chacha20_block(torch.cat([tA, tB, tR], dim=1))  # [B, 3L, 16]
    # per-message row order of discrete_gaussian(repeats=2): [t rows, u rows]
    e = _dgauss_from_words(words[:, : 2 * L].reshape(-1, 16), btree_lo,
                           btree_hi, depth)
    q = torch.tensor([amax], dtype=_I64, device=rows_t.device)
    v = _randint_from_words(words[:, 2 * L :].reshape(-1, 16), q, 0)
    new_t = step_counter(rows_t, 2 * B * inc)
    new_u = step_counter(rows_u, B * inc)
    return e, v, new_t, new_u


def _randround_core(coef, words):
    """Stochastic rounding: compare the fraction against one 32-bit word
    per coefficient; ``torch.round`` rounds half to even, as ``jnp.rint``
    does."""
    rand = words.reshape(-1)
    sign = torch.sign(coef)
    abs_coef = torch.abs(coef)
    integ = torch.floor(abs_coef)
    frac = abs_coef - integ
    ifrac = torch.round(frac * 2.0**32).to(_I64)
    rounded = (rand < ifrac).to(torch.float64)
    return (sign * (integ + rounded)).to(_I64)


class Csprng(RandNumGen):
    def __init__(
        self,
        num_coefs=2**15,
        num_channels=None,
        num_repeating_channels=2,
        sigma=3.2,
        seed=None,
        nonce=None,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.num_coefs = num_coefs
        self.num_channels = (
            [8] if num_channels is None else list(num_channels)
        )
        # Single logical shard: all channels in one state tensor.
        self.shares = (
            self.num_channels
            if len(self.num_channels) == 1
            else [sum(self.num_channels)]
        )
        self.total_num_channels = sum(self.shares)
        self.num_repeating_channels = num_repeating_channels
        self.sigma = sigma

        self.L = self.num_coefs // 4

        btree, _, self.tree_depth = (
            build_CDT_binary_search_tree(security_bits=128, sigma=sigma)
        )
        # the sampler compares the high halves as signed int64
        assert int(btree[:, 1].max()) < 1 << 63
        self._btree_lo = torch.from_numpy(
            np.ascontiguousarray(btree[:, 0]).view(np.int64)).to(self.device)
        self._btree_hi = torch.from_numpy(
            btree[:, 1].astype(np.int64)).to(self.device)

        self.inc = (
            self.total_num_channels + self.num_repeating_channels
        ) * self.L
        self.repeating_start = self.total_num_channels * self.L

        self.refresh(seed, nonce)

    # ------------------------------------------------------------------
    # State management.
    # ------------------------------------------------------------------

    def refresh(self, seed=None, nonce=None):
        if nonce is None and isinstance(seed, int):
            # An explicit seed is fully deterministic: key and nonce come
            # from one seeded stream.
            words = np.random.default_rng(seed).integers(0, 2**32, 10)
            self.key = [int(x) for x in words[:8]]
            self.nonce = [int(x) for x in words[8:]]
        else:
            self.key = self._generate_words(32, seed)
            self.nonce = self._generate_words(8, nonce)
        rows = (
            self.total_num_channels + self.num_repeating_channels
        ) * self.L
        dev = self.device
        state = torch.zeros((rows, 16), dtype=_I64, device=dev)
        state[:, 0:4] = torch.tensor(NOTHING_UP_MY_SLEEVE.astype(np.int64),
                                     device=dev)
        state[:, 4:12] = torch.tensor(self.key, dtype=_I64, device=dev)
        state[:, 12] = torch.arange(rows, dtype=_I64, device=dev)
        state[:, 14:16] = torch.tensor(self.nonce, dtype=_I64, device=dev)
        self.states = state

    @staticmethod
    def _generate_words(nbytes, seed=None, part_bytes=4):
        if seed is None:
            raw = os.urandom(nbytes)
            return [
                int.from_bytes(raw[i : i + part_bytes], "little")
                for i in range(0, nbytes, part_bytes)
            ]
        if isinstance(seed, int):
            rng = np.random.default_rng(seed)
            return [
                int(x) for x in rng.integers(0, 2**32, nbytes // part_bytes)
            ]
        return [int(s) & M32 for s in seed]

    @property
    def channeled_states(self):
        """The states viewed per channel: [channels, L, 16]."""
        return self.states.reshape(-1, self.L, 16)

    def _chacha_and_step(self, r0, r1):
        """ChaCha state rows [r0, r1); step their counters (R1)."""
        return ck.chacha_words(self.states, r0, r1, self.inc)

    def _generate(self, start_channel, end_channel):
        """ChaCha the selected channel rows; step their counters."""
        return self._chacha_and_step(start_channel * self.L,
                                     end_channel * self.L)

    def _f64(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device)

    # ------------------------------------------------------------------
    # Public sampling API.
    # ------------------------------------------------------------------

    def randbytes(self, shares=None, repeats=0, reshape=False):
        nch = self.total_num_channels if shares is None else shares
        start = self.total_num_channels - nch
        end = self.total_num_channels + repeats
        words = self._generate(start, end)
        if reshape:
            return words.reshape(-1, self.L, 16)
        return words

    def randint(self, amax=3, shift=0, repeats=0):
        """Uniform ints in [shift, amax + shift).

        amax: scalar, or per-channel list of moduli (then channels used =
        len(amax), with the last ``repeats`` of them in repeating
        channels).  Returns int64 [channels, num_coefs].
        """
        if not isinstance(amax, (list, tuple, np.ndarray)):
            amax = [amax]
        nch = len(amax) - repeats  # non-repeating channels used
        start = self.total_num_channels - nch
        end = self.total_num_channels + repeats
        q = ck.device_table([int(a) for a in amax], self.device)
        samples = ck.chacha_randint(self.states, start * self.L,
                                    end * self.L, q, int(shift), self.inc)
        return samples.reshape(-1, self.num_coefs)

    def discrete_gaussian(self, non_repeats=0, repeats=1):
        nch = non_repeats
        start = self.total_num_channels - nch
        end = self.total_num_channels + repeats
        samples = ck.chacha_dgauss(
            self.states, start * self.L, end * self.L, self._btree_lo,
            self._btree_hi, self.tree_depth, self.inc,
        )
        return samples.reshape(-1, self.num_coefs)

    def encrypt_noise_batch(self, B: int, amax: int = 2):
        """Noise draws for B encryptions in one ChaCha call (on the card,
        one R2 and one R3 launch).

        Bit-identical to B sequential iterations of the encrypt loop's
        draw pair ``(discrete_gaussian(repeats=2),
        randint(amax=amax, shift=0, repeats=1)[0])``: per message the
        first repeating channel serves e0 then v (two counter steps of
        ``inc``), the second serves e1 (one step); replica k's rows are
        the stored states advanced to exactly where call k would have
        found them.  Returns ``(e [B, 2, N], v [B, N])``, int64.
        """
        return ck.encrypt_noise(
            self.states, self.repeating_start, self.L, self._btree_lo,
            self._btree_hi, self.tree_depth, int(amax), B, self.inc,
        )

    def randround(self, coef):
        """Stochastically round f64 coefficients [N] on the device, against
        the first N/16 state rows as the threshold stream; returns int64
        [N] on the device."""
        coef = self._f64(coef).reshape(1, -1).contiguous()
        return ck.chacha_randround(self.states, 0, coef, self.inc)[0]

    def randround_batch(self, coefs):
        """Stochastically round a batch of f64 coefficients [B, N] in one
        ChaCha call, bit-identical to B sequential :meth:`randround`
        calls: replica k's threshold states are the stored states with
        counters advanced by k * inc (exactly where call k would have
        found them), and the stored counters advance by B * inc."""
        coefs = self._f64(coefs)
        B = coefs.shape[0]
        if B * self.inc > M32:
            raise OverflowError(f"B * inc = {B * self.inc} exceeds the "
                                f"32-bit counter step")
        coefs = coefs.reshape(B, -1).contiguous()
        return ck.chacha_randround(self.states, 0, coefs, self.inc)
