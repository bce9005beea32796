"""Keygen and encryption draws from an explicit ``torch.Generator``.

**This is not a CSPRNG.**  It stands in for the JAX package's counter-mode
ChaCha20 generator (``tiberate_tpu/rng/csprng.py``) until that is ported:
the distributions are the same (uniform ternary, uniform mod q per channel,
the CDT discrete Gaussian, stochastic rounding), the bits are torch's
Philox/Mersenne stream and not ChaCha20's, so keys and ciphertexts differ
from the JAX package's for the same seed.  Every draw comes from
``self.generator`` on the CPU; callers move the result to their device.
"""

import math

import numpy as np
import torch

from tiberate_tpu_torch.rng.discrete_gaussian_sampler import build_CDT

_I64 = torch.int64


class Sampler:
    def __init__(self, num_coefs: int, sigma: float = 3.2, seed=None):
        self.num_coefs = num_coefs
        self.generator = torch.Generator()
        if seed is None:
            self.generator.seed()
        else:
            self.generator.manual_seed(int(seed))
        # Inverse CDF on 62 of the 127 uniform bits the CDT tree compares:
        # magnitude = #{j >= 1 : cdt[j] <= x}, over the table's nodes
        # cdt[1 .. 2^depth - 1] (the reference tree's range).
        cdt = build_CDT(128, sigma)
        points = 2 ** math.ceil(math.log2(6 * sigma))
        self._thresholds = torch.tensor(
            [c >> 65 for c in cdt[1:points]], dtype=_I64
        )

    def _randint(self, low, high, shape):
        return torch.randint(low, high, shape, generator=self.generator,
                             dtype=_I64)

    def ternary(self) -> torch.Tensor:
        """[N] uniform in {-1, 0, 1}."""
        return self._randint(-1, 2, (self.num_coefs,))

    def binary(self) -> torch.Tensor:
        """[N] uniform in {0, 1} (the encryption mask ``v``)."""
        return self._randint(0, 2, (self.num_coefs,))

    def uniform(self, q_list) -> torch.Tensor:
        """[len(q_list), N]: row c uniform in [0, q_list[c])."""
        return torch.stack(
            [self._randint(0, int(q), (self.num_coefs,)) for q in q_list]
        )

    def discrete_gaussian(self, rows: int = 1) -> torch.Tensor:
        """[rows, N] signed draws from the CDT discrete Gaussian."""
        shape = (rows, self.num_coefs)
        x = self._randint(0, 1 << 62, shape)
        mag = torch.searchsorted(self._thresholds, x, right=True)
        sign = self._randint(0, 2, shape) * 2 - 1
        return sign * mag

    def randround(self, coef) -> torch.Tensor:
        """Stochastically round f64 coefficients [N] to int64: the fraction
        rounds up when a uniform u32 falls below ``rint(frac * 2^32)``."""
        coef = torch.as_tensor(np.asarray(coef, dtype=np.float64))
        rand = self._randint(0, 1 << 32, coef.shape)
        sign = torch.sign(coef)
        abs_coef = coef.abs()
        integ = torch.floor(abs_coef)
        ifrac = torch.round((abs_coef - integ) * 2.0**32).to(_I64)
        rounded = (rand < ifrac).to(torch.float64)
        return (sign * (integ + rounded)).to(_I64)
