"""chatglm3-6b  [dense]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 — 2d RoPE (rotary on
half the head dims), GQA.  [arXiv:2406.12793]
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        attn_shard="head",
        rope="partial",
        rope_fraction=0.5,
        phantom=PhantomConfig(k=16),
        projections=phantom_projection_map(16, ffn=True),
        qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attn_shard="head",
        rope="partial",
        rope_fraction=0.5,
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        qkv_bias=True,
    )
