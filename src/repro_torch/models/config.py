"""Model configuration (the port's own copy of `repro.models.config`).

One frozen dataclass describes every family of the reference, with the
same fields and defaults, so configs carry over letter for letter; the
port builds every family.  `dtype` is "float32", "bfloat16" or
"float16" (`torch_dtype`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.lram import LRAMConfig
from repro_torch.core.pkm import PKMConfig


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default: d_model // num_heads

    # attention
    attention: str = "full"              # full | swa
    window: int = 4096                   # SWA window
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_scheme: str = "rope"             # rope | mrope | learned | none
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # qwen2-vl t/h/w split
    attn_chunk: int = 2048               # kv/q chunking threshold (flash-style)
    attn_impl: str = "auto"              # auto | dense | chunked

    # blocks
    norm: str = "rms"                    # rms | layer
    act: str = "swiglu"                  # swiglu | gelu
    mlp_bias: bool = False
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k_experts: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 64
    ssm_conv: int = 4
    hybrid_pattern: int = 0              # zamba2: shared attn every N mamba blocks
    shared_attention: bool = False

    # enc-dec (whisper): frontend is a STUB — input_specs feeds embeddings
    encoder_layers: int = 0
    encoder_len: int = 1500

    # vlm (qwen2-vl): vision frontend is a STUB — input_specs feeds embeddings
    vision_tokens: int = 0

    # memory layers (the paper's technique, first-class)
    lram_layers: tuple[int, ...] = ()
    lram: Optional[LRAMConfig] = None
    pkm_layers: tuple[int, ...] = ()
    pkm: Optional[PKMConfig] = None

    # objective / numerics
    objective: str = "clm"               # clm | mlm
    max_seq: int = 8192                  # for learned positions only
    dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(1, self.num_kv_heads) == 0
        if self.lram_layers:
            assert self.lram is not None
        if self.pkm_layers:
            assert self.pkm is not None

    # ---- derived -----------------------------------------------------------

    @property
    def torch_dtype(self) -> torch.dtype:
        """The dtype of the weights, activations and KV cache."""
        if self.dtype not in DTYPES:
            raise NotImplementedError(
                f"dtype {self.dtype!r} is refused: the model runs in "
                f"{sorted(DTYPES)} (the reference, x64 off, draws a "
                f"float64 model as float32 and has no integer one)")
        return DTYPES[self.dtype]

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = (
            self.num_heads * hd * d
            + 2 * self.num_kv_heads * hd * d
            + self.num_heads * hd * d
        )
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        n = 0
        for i in range(self.num_layers):
            if self.family == "ssm":
                n += self._mamba_params()
                continue
            if self.family == "hybrid":
                n += self._mamba_params()
                continue
            n += attn
            if i in self.lram_layers and self.lram is not None:
                n += self.lram.num_params + d * d + 4 * d * d
            elif i in self.pkm_layers and self.pkm is not None:
                n += self.pkm.num_params
            elif self.num_experts > 0:
                n += self.num_experts * mlp + d * self.num_experts
            else:
                n += mlp
        if self.family == "hybrid" and self.hybrid_pattern:
            n += attn + mlp  # one shared block
        if self.family == "encdec":
            n += self.encoder_layers * (attn + mlp) + self.num_layers * attn
        n += v * d * (1 if self.tie_embeddings else 2)
        return n

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.d_inner
        n_bc = 2 * self.ssm_groups * self.ssm_state
        return (
            d * (2 * di + n_bc + self.ssm_heads)  # in_proj (z,x,B,C,dt)
            + self.ssm_conv * (di + n_bc)         # conv1d
            + 3 * self.ssm_heads                  # A, D, dt_bias
            + di                                  # gate norm
            + di * d                              # out_proj
        )

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = (3 if self.act == "swiglu" else 2) * d * f
        inactive = (self.num_experts - self.top_k_experts) * mlp
        return self.param_count() - self.num_layers * inactive


def validate_cell(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    """Return a skip-reason if (arch x shape) is not runnable, else None
    (the reference's, word for word)."""
    if shape_name.startswith("long"):
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid") or cfg.attention == "swa"
        )
        if not sub_quadratic:
            return (
                "long_500k needs sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (see DESIGN.md §5)"
            )
    return None
