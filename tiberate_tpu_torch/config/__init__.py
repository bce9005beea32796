from tiberate_tpu_torch.config.ckks_config import CkksConfig, Preset
from tiberate_tpu_torch.config.security_parameters import (
    maximum_qbits,
    minimum_cyclotomic_order,
)

__all__ = ["CkksConfig", "Preset", "maximum_qbits", "minimum_cyclotomic_order"]
