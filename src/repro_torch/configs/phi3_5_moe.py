"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2
[hf:microsoft/Phi-3.5-MoE-instruct].  Torch copy of
`repro.configs.phi3_5_moe`: `config()` the published configuration
(bfloat16), `smoke_config()` a reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        top_k_experts=2,
        attention="full",
        act="swiglu",
        norm="rms",
        rope_theta=1e4,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        num_layers=3,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=256,
        num_experts=4,
        top_k_experts=2,
        act="swiglu",
        norm="rms",
        remat=False,
    )
