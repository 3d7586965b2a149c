"""Yi-9B — llama-arch dense GQA [arXiv:2403.04652; hf].
Torch copy of `repro.configs.yi_9b`: `config()` the published
configuration (bfloat16), `smoke_config()` a reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        attention="full",
        act="swiglu",
        norm="rms",
        rope_theta=1e4,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        norm="rms",
        remat=False,
    )
