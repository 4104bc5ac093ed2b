"""phi3-mini-3.8b  [dense]

32L d_model=3072 32H (kv=32 -> MHA) d_ff=8192 vocab=32064 — RoPE, SwiGLU,
RMSNorm.  [arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        attn_shard="head",
        phantom=PhantomConfig(k=12),
        projections=phantom_projection_map(12, ffn=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_shard="head",
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        loss_chunk=64,
    )
