"""Mamba2-1.3B — pure SSM (state-space duality) [arXiv:2405.21060].
Torch copy of `repro.configs.mamba2_1_3b`: `config()` the published
configuration (bfloat16), `smoke_config()` a reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=16,        # unused (attention-free); keeps config valid
        num_kv_heads=16,
        d_ff=0,              # no FFN: the mamba mixer is the whole block
        vocab_size=50280,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,        # d_inner 4096 -> 64 ssm heads
        ssm_groups=1,
        ssm_chunk=64,
        pos_scheme="none",
        norm="rms",
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_headdim=16,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=4,
        pos_scheme="none",
        norm="rms",
        remat=False,
    )
