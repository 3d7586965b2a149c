"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].
Torch copy of `repro.configs.h2o_danube3_4b`: `config()` the published
configuration (bfloat16), `smoke_config()` a reduced one (float32).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        attention="swa",
        window=4096,
        act="swiglu",
        norm="rms",
        rope_theta=1e4,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attention="swa",
        window=8,
        act="swiglu",
        norm="rms",
        remat=False,
    )
