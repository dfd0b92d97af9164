from .federated import partition_dirichlet, partition_iid
from .synthetic import (synthetic_classification, synthetic_images, synthetic_lm_tokens,
                        synthetic_sequences)

__all__ = [
    "synthetic_classification",
    "synthetic_images",
    "synthetic_lm_tokens",
    "synthetic_sequences",
    "partition_iid",
    "partition_dirichlet",
]
