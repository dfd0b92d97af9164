from .adamw import AdamWState, adamw
from .base import Optimizer, apply_updates
from .sgd import sgd

__all__ = ["AdamWState", "Optimizer", "adamw", "apply_updates", "sgd"]
