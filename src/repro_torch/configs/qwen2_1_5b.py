"""Qwen2-1.5B — dense GQA with QKV bias, tied embeddings [arXiv:2407.10671].
Torch copy of `repro.configs.qwen2_1_5b`: `config()` the published
configuration (bfloat16), `smoke_config()` a reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        attention="full",
        qkv_bias=True,
        tie_embeddings=True,
        act="swiglu",
        norm="rms",
        rope_theta=1e6,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke",
        family="dense",
        num_layers=3,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        qkv_bias=True,
        tie_embeddings=True,
        act="swiglu",
        norm="rms",
        remat=False,
    )
