from tiberate_tpu_torch.extension.mpc import CkksEngineMPCExtension
from tiberate_tpu_torch.extension.nn import (
    HEFeedForwardFeatureWise,
    HELayerNorm,
    HELinear,
    HELinearFeatureWise,
    HEModule,
)
from tiberate_tpu_torch.extension.packing import (
    FeatureWiseCTEncoding,
    FeatureWisePacking,
    PackedCT,
    PackingMetadata,
)

__all__ = [
    "CkksEngineMPCExtension",
    "FeatureWiseCTEncoding",
    "FeatureWisePacking",
    "HEFeedForwardFeatureWise",
    "HELayerNorm",
    "HELinear",
    "HELinearFeatureWise",
    "HEModule",
    "PackedCT",
    "PackingMetadata",
]
