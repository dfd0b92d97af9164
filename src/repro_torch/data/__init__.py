from .federated import partition_dirichlet, partition_iid
from .pipeline import LMBatcher, silo_stream
from .synthetic import (synthetic_classification, synthetic_images, synthetic_lm_tokens,
                        synthetic_sequences)

__all__ = [
    "LMBatcher",
    "silo_stream",
    "synthetic_classification",
    "synthetic_images",
    "synthetic_lm_tokens",
    "synthetic_sequences",
    "partition_iid",
    "partition_dirichlet",
]
