"""Qwen2-VL-72B — M-RoPE, dynamic-resolution vision (STUB: the batch feeds
merged patch embeddings, `vision_embeds`, and 3D position ids,
`positions`) [arXiv:2409.12191].  Torch copy of
`repro.configs.qwen2_vl_72b`: `config()` the published configuration
(bfloat16), `smoke_config()` a reduced one (float32)."""

from repro_torch.models.config import ModelConfig


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
        attention="full",
        qkv_bias=True,
        pos_scheme="mrope",
        mrope_sections=(16, 24, 24),
        vision_tokens=256,
        act="swiglu",
        norm="rms",
        rope_theta=1e6,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-smoke",
        family="vlm",
        num_layers=3,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        qkv_bias=True,
        pos_scheme="mrope",
        mrope_sections=(2, 2, 2),
        vision_tokens=4,
        act="swiglu",
        norm="rms",
        remat=False,
    )
