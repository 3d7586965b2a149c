"""Zamba2-2.7B — hybrid: Mamba2 blocks + one SHARED attention block invoked
every 6 mamba blocks [arXiv:2411.15242; hf].  Torch copy of
`repro.configs.zamba2_2_7b`: `config()` the published configuration
(bfloat16), `smoke_config()` a reduced one (float32).

Simplifications vs the HF checkpoint, as the reference's: the shared
block's per-invocation LoRA adapters are dropped (pure parameter sharing),
and the shared block input is the residual stream (no concat with the
original embedding)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,     # MHA in the shared block
        d_ff=10240,
        vocab_size=32000,
        hybrid_pattern=6,    # 54 mamba layers -> 9 shared-attn invocations
        shared_attention=True,
        ssm_state=64,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_groups=1,
        act="gelu",
        norm="layer",
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        hybrid_pattern=2,
        shared_attention=True,
        ssm_state=16,
        ssm_headdim=16,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=4,
        act="gelu",
        norm="layer",
        remat=False,
    )
