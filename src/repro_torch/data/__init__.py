from .federated import partition_dirichlet, partition_iid
from .synthetic import synthetic_classification, synthetic_images

__all__ = [
    "synthetic_classification",
    "synthetic_images",
    "partition_iid",
    "partition_dirichlet",
]
