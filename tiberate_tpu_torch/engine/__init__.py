from tiberate_tpu_torch.engine.ckks_engine import (
    CkksEngine,
    stack_ciphertexts,
    unstack_ciphertext,
)

__all__ = ["CkksEngine", "stack_ciphertexts", "unstack_ciphertext"]
