"""qwen2.5-14b  [dense]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA, QKV bias.
[hf:Qwen/Qwen2.5 family]

``attn_shard="ring"``: sequence-sharded attention at every tp, as 40
heads do not divide a model axis of 16 (``models/attention.py:
_attention_ring``).
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        attn_shard="ring",
        qkv_bias=True,
        phantom=PhantomConfig(k=16),
        projections=phantom_projection_map(16, ffn=True),
        optimizer="adamw",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attn_shard="ring",
        qkv_bias=True,
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        loss_chunk=64,
    )
