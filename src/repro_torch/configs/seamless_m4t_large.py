"""seamless-m4t-large-v2  [encdec]

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206: encoder-decoder,
multimodal.  [arXiv:2308.11596]

The backbone only, as in the reference: the audio frontend is a stub,
and a batch carries precomputed frame embeddings (``frames``
``[B, S, d]``).  "24L" reads as 24 encoder and 24 decoder layers.
LayerNorm, a gelu MLP with a bias on ``up``, no rotary positions (the
stub feeds the frames as they are); phantom at the MLP sites only.
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,            # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        frontend="audio",
        attn_shard="head",
        phantom=PhantomConfig(k=8),
        projections=phantom_projection_map(8, ffn=True),
        norm="layernorm",
        mlp="gelu",
        rope="none",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        frontend="audio",
        attn_shard="head",
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        norm="layernorm",
        mlp="gelu",
        rope="none",
        loss_chunk=64,
    )
