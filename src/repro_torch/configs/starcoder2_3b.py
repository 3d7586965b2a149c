"""StarCoder2-3B — GQA, RoPE, GELU + LayerNorm, biases [arXiv:2402.19173].
Torch copy of `repro.configs.starcoder2_3b`: `config()` the published
configuration (bfloat16), `smoke_config()` a reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        attention="full",
        qkv_bias=True,
        mlp_bias=True,
        act="gelu",
        norm="layer",
        rope_theta=1e5,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        num_layers=3,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        qkv_bias=True,
        mlp_bias=True,
        act="gelu",
        norm="layer",
        remat=False,
    )
