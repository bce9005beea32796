"""Exception types for tiberate_tpu_torch.

The reference declares a partial set in ``tiberate/errors.py`` and *uses* several
undefined ones (``NTTStateError`` etc., see reference ``ckks_engine.py:631-637``).
Here the full set is defined properly.
"""


class TiberateError(Exception):
    """Base class for all tiberate_tpu_torch errors."""


class NotFoundMessageSpecialPrimes(TiberateError):
    def __init__(self, message_bit, N):
        super().__init__(
            f"Can't find message_bit = {message_bit} and N = {N} in the prime cache."
        )


class NotFoundScalePrimes(TiberateError):
    def __init__(self, scale_bits, N):
        super().__init__(
            f"Can't find scale bits = {scale_bits} and N = {N} in the prime cache."
        )


class NotEnoughPrimes(TiberateError):
    def __init__(self, scale_bits, N):
        super().__init__(
            f"Not enough scale primes at scale_bits = {scale_bits} and N = {N}."
        )


class ViolatedAllowedQbits(TiberateError):
    def __init__(self, scale_bits, N, num_scales, max_qbits, total_qbits):
        super().__init__(
            f"Maximum allowed qbits are violated: max_qbits={max_qbits:4d} "
            f"but the requested total is {total_qbits:4d} "
            f"(scale_bits={scale_bits}, N={N}, num_scales={num_scales})."
        )


class NotEnoughPrimesForBiasGuard(TiberateError):
    def __init__(self, bias_guard, num_special_primes):
        super().__init__(
            "Guarding against biased overflow requires more than 2 remaining "
            f"prime channels. bias_guard={bias_guard}, "
            f"num_special_primes={num_special_primes}."
        )


class MaximumLevelError(TiberateError):
    def __init__(self, level, level_max):
        super().__init__(
            "The multiplicative level budget of this ciphertext is depleted. "
            f"maximum: {level_max}, now: {level}."
        )


class NTTStateError(TiberateError):
    def __init__(self, expected: bool):
        super().__init__(
            f"Operand is {'not ' if expected else ''}in the NTT domain, "
            f"but the operation requires NTT_STATE={expected}."
        )


class MontgomeryStateError(TiberateError):
    def __init__(self, expected: bool):
        super().__init__(
            f"Operand is {'not ' if expected else ''}in the Montgomery domain, "
            f"but the operation requires MONTGOMERY_STATE={expected}."
        )


class DifferentTypeError(TiberateError):
    def __init__(self, a, b):
        super().__init__(f"Operand types mismatch: {a} vs {b}.")


class NotMatchType(TiberateError):
    def __init__(self, origin, to):
        super().__init__(f"Type mismatch: cannot convert {origin} to {to}.")


class SecretKeyNotIncludeSpecialPrime(TiberateError):
    def __init__(self):
        super().__init__(
            "The secret key does not carry special-prime channels, but the "
            "requested operation needs them (INCLUDE_SPECIAL)."
        )


class EngineHashMismatch(TiberateError):
    def __init__(self, expected, got):
        super().__init__(
            f"Data structure was created by a different engine "
            f"(hash {got}) than the one operating on it ({expected})."
        )
