from .base import Optimizer, apply_updates
from .sgd import sgd

__all__ = ["Optimizer", "apply_updates", "sgd"]
