"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  Torch copy of `repro.configs.mixtral_8x7b`:
`config()` the published configuration (bfloat16), `smoke_config()` a
reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        top_k_experts=2,
        attention="swa",
        window=4096,
        act="swiglu",
        norm="rms",
        rope_theta=1e6,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        num_layers=3,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        top_k_experts=2,
        attention="swa",
        window=8,
        act="swiglu",
        norm="rms",
        remat=False,
    )
