"""Random-number-generator interface (the JAX package's
``tiberate_tpu/rng/interface.py``).

Implementations: :class:`~tiberate_tpu_torch.rng.csprng.Csprng` (ChaCha20
counter mode, the engine's generator) and
:class:`~tiberate_tpu_torch.rng.simplerng.SimpleRNG` (numpy stand-in for
tests).
"""

from abc import ABC, abstractmethod


class RandNumGen(ABC):
    @abstractmethod
    def randbytes(self, shares=None, repeats=0, reshape=False):
        """Raw keystream words for the selected channels."""

    @abstractmethod
    def randint(self, amax=3, shift=0, repeats=0):
        """Uniform integers in [shift, amax + shift) per channel."""

    @abstractmethod
    def discrete_gaussian(self, non_repeats=0, repeats=1):
        """Discrete Gaussian samples (sigma set at construction)."""

    @abstractmethod
    def randround(self, coef):
        """Stochastic rounding of float64 coefficients."""

    @abstractmethod
    def refresh(self, seed=None, nonce=None):
        """Reseed the generator."""
