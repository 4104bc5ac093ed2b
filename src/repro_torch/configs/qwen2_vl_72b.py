"""qwen2-vl-72b  [vlm]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064: M-RoPE, dynamic
resolution.  [arXiv:2409.12191]

The backbone only, as in the reference: the vision frontend is a stub,
and a batch carries its patch embeddings (``vision_embeds``, spliced
over the first ``n_vision_tokens`` positions) and the three rows of
M-RoPE position ids (``positions`` ``[3, B, S]``).  FSDP over the data
axis on top of the model axis, Adafactor and bf16 parameters, as the
reference sets them; phantom at the MLP sites only (``ffn=True``).
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        attn_shard="head",
        rope="mrope",
        qkv_bias=True,
        frontend="vision",
        phantom=PhantomConfig(k=32),
        projections=phantom_projection_map(32, ffn=True),
        fsdp=True,
        optimizer="adafactor",
        param_dtype="bfloat16",   # 72 B parameters do not fit in fp32
        microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attn_shard="head",
        rope="mrope",
        qkv_bias=True,
        frontend="vision",
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, ffn=True),
        loss_chunk=64,
    )
