"""mamba2-370m  [ssm]

48L d_model=1024 (attention-free) vocab=50280, ssm_state=128: SSD
(state-space duality).  [arXiv:2405.21060]

d_inner = 2 * d_model = 2048, head_dim = 64: 32 SSD heads.  Phantom at
the SSM's in and out projections (``attn=True`` covers the ``ssm_in`` /
``ssm_out`` sites): at tp > 1 the stream stays feature-sharded and each
layer's ``wz``, ``wx`` and ``out`` run the phantom kernels.  The chunked
scan itself has no cross-rank weight block to factorise
(``models/ssm.py``).
"""
from repro_torch.configs.base import (ModelConfig, PhantomConfig, SSMConfig,
                                      phantom_projection_map)


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        attn_period=-1,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
        phantom=PhantomConfig(k=8),
        projections=phantom_projection_map(8, attn=True),
        rope="none",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        vocab_size=256,
        attn_period=-1,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                      chunk=32),
        phantom=PhantomConfig(k=4),
        projections=phantom_projection_map(4, attn=True),
        rope="none",
        loss_chunk=64,
    )
