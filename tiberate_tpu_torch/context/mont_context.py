"""Montgomery precompute (pure Python ints).

Behavioral equivalent of the reference ``tiberate/context/mont_context.py``:
R = 2^buffer_bit_length, per-prime R^2 mod q, 31-bit half splits of q and of
k = (R*R^-1 - 1)/q, doubled moduli, etc.  These exact constants feed the
branchless REDC used by every modular kernel (reference
``csrc/cuda/mont_cuda_kernel.cuh:11-60``).
"""

from dataclasses import dataclass

from tiberate_tpu_torch.config import CkksConfig


@dataclass
class MontgomeryContext:
    R: int
    R_square: list
    half_buffer_bit_length: int
    lower_bits_mask: int
    full_bits_mask: int
    q_lower_bits: list
    q_higher_bits: list
    q_double: list
    R_inv: list
    k: list
    k_lower_bits: list
    k_higher_bits: list
    q: list

    @classmethod
    def from_ckks_config(cls, ckks_config: CkksConfig):
        R = 2**ckks_config.buffer_bit_length
        q = list(ckks_config.q)
        R_square = [R**2 % qi for qi in q]
        half = ckks_config.buffer_bit_length // 2
        lower_bits_mask = (1 << half) - 1
        full_bits_mask = (1 << ckks_config.buffer_bit_length) - 1

        q_lower_bits = [qi & lower_bits_mask for qi in q]
        q_higher_bits = [qi >> half for qi in q]
        q_double = [qi << 1 for qi in q]

        R_inv = [pow(R, -1, qi) for qi in q]
        k = [(R * Ri - 1) // qi for Ri, qi in zip(R_inv, q)]
        k_lower_bits = [ki & lower_bits_mask for ki in k]
        k_higher_bits = [ki >> half for ki in k]

        return cls(
            R=R,
            R_square=R_square,
            half_buffer_bit_length=half,
            lower_bits_mask=lower_bits_mask,
            full_bits_mask=full_bits_mask,
            q_lower_bits=q_lower_bits,
            q_higher_bits=q_higher_bits,
            q_double=q_double,
            R_inv=R_inv,
            k=k,
            k_lower_bits=k_lower_bits,
            k_higher_bits=k_higher_bits,
            q=q,
        )
