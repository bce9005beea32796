"""Numpy-backed RandNumGen stand-in (the JAX package's
``tiberate_tpu/rng/simplerng.py``).

Same API and channel semantics as :class:`Csprng`, driven by numpy's
default generator: NOT cryptographically secure; for tests.  Repeating
channels use a second generator seeded from the same seed, so every shard
reproduces them.  For the same seed its draws are the JAX package's
``SimpleRNG`` draws, as int64 tensors on ``device``.
"""

import numpy as np
import torch

from tiberate_tpu_torch.rng.interface import RandNumGen


class SimpleRNG(RandNumGen):
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
        self.num_channels = [8] if num_channels is None else list(num_channels)
        self.shares = (
            self.num_channels
            if len(self.num_channels) == 1
            else [sum(self.num_channels)]
        )
        self.total_num_channels = sum(self.shares)
        self.num_repeating_channels = num_repeating_channels
        self.sigma = sigma
        self.refresh(seed, nonce)

    def refresh(self, seed=None, nonce=None):
        self._rng = np.random.default_rng(seed)
        self._rep_rng = np.random.default_rng(
            seed if seed is None else seed + 1
        )

    def _out(self, x):
        return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(
            self.device)

    def randbytes(self, shares=None, repeats=0, reshape=False):
        nch = self.total_num_channels if shares is None else shares
        rows = (nch + repeats) * (self.num_coefs // 4)
        words = self._rng.integers(0, 2**32, (rows, 16), dtype=np.uint32)
        if reshape:
            words = words.reshape(-1, self.num_coefs // 4, 16)
        return self._out(words)

    def randint(self, amax=3, shift=0, repeats=0):
        if not isinstance(amax, (list, tuple, np.ndarray)):
            amax = [amax]
        out = []
        for i, q in enumerate(amax):
            gen = self._rep_rng if i >= len(amax) - repeats else self._rng
            out.append(
                gen.integers(0, int(q), self.num_coefs, dtype=np.int64)
                + int(shift)
            )
        return self._out(np.stack(out))

    def discrete_gaussian(self, non_repeats=0, repeats=1):
        out = [
            np.rint(gen.normal(0, self.sigma, self.num_coefs))
            for gen in [self._rng] * non_repeats + [self._rep_rng] * repeats
        ]
        return self._out(np.stack(out))

    def randround(self, coef):
        coef = np.asarray(coef, dtype=np.float64)
        sign = np.sign(coef)
        a = np.abs(coef)
        integ = np.floor(a)
        frac = a - integ
        rounded = self._rng.random(coef.shape) < frac
        return self._out(sign * (integ + rounded))
