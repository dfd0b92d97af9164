"""PyTorch/CUDA port of the FP8 federated-learning system in ``repro``.

The JAX package (``src/repro``) is the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``models/``, ``optim/``, ``data/``) so each
module's counterpart is found at the same relative path. It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Params are plain nested dicts of tensors with the reference's keys and
layouts, so ``convert.from_jax_params`` carries reference weights across and
the wire's flat leaf order (sorted keys, as JAX's pytree flattening) lines up
byte for byte. Entry points take an explicit ``device`` (default ``"cuda"``)
and raise when no card is present unless the caller asks for the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
