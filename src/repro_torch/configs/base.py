"""Model configurations, the dense-family part of ``repro.configs.base``.

A copy (the port imports nothing of the reference package) of the
``ModelConfig`` fields that the dense decoder reads, with the reference's
names and defaults, and of ``reduced()``'s dense branch. The reference's
MLA / MoE / SSM / RG-LRU / encoder-decoder / VLM fields belong to model
families that are not ported yet (ROADMAP §1 item 8); ``reduced`` raises for
those families. Its ``window`` (sliding-window attention) and
``tie_embeddings`` come with those families too; ``remat`` changes memory,
not values, and the port's eager layer loop has no use for it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None

    attention: str = "full"          # full (ported) | swa | local | mla | none
    rope_theta: float = 10000.0

    norm_eps: float = 1e-6
    act: str = "silu"
    # attention kv-chunk for the flash-style loop; ce_chunks: CE token chunks
    attn_chunk: int = 1024
    ce_chunks: int = 8

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's dense branch)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"reduced({cfg.name!r}): family {cfg.family!r} is not ported yet "
            "(ROADMAP §1 item 8, the other LM families)")
    return cfg.replace(
        n_layers=min(cfg.n_layers, 3),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        attn_chunk=32,
        ce_chunks=2,
    )
