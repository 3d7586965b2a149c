"""Attention: GQA with split-half RoPE, full-sequence and per-slot decode
(torch counterpart of `repro.models.attention`).

Plain torch matmul + softmax in float32, masked with -1e30 as the
reference does.  The reference's sliding-window, M-RoPE and chunked
(flash-style) paths are not ported yet and raise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.models.config import ModelConfig

_NEG_INF = -1e30


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.attention == "swa":
        raise NotImplementedError("sliding-window attention is not yet "
                                  "ported to torch")
    if cfg.pos_scheme == "mrope":
        raise NotImplementedError("M-RoPE is not yet ported to torch")
    if cfg.attn_impl == "chunked":
        raise NotImplementedError("chunked attention is not yet ported to "
                                  "torch")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )


@functools.lru_cache(maxsize=None)
def _frequencies_on(head_dim: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # cached: usable under autograd too
        return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Split-half rotation."""
    d = x.shape[-1]
    freqs = _frequencies_on(d, theta, x.device)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Core attention math (GQA-aware)
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, S, Kh, G, D), k: (B, T, Kh, D) -> (B, Kh, G, S, T) in f32."""
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _attend(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B, Kh, G, S, T), v: (B, T, Kh, D) -> (B, S, Kh, G, D)."""
    return torch.einsum("bkgst,btkd->bskgd", w, v.to(w.dtype))


def _band_mask(s: int, t: int, *, causal: bool,
               device=None) -> torch.Tensor:
    """(S, T) validity mask; query i sits at absolute position i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    if causal:
        return kj <= qi
    return torch.ones((s, t), dtype=torch.bool, device=device)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,Kh,D) -> (B,S,H,D)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d) * (d**-0.5)
    scores = _scores(qg, k)
    mask = _band_mask(s, k.shape[1], causal=causal, device=q.device)
    scores = torch.where(mask, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return _attend(w, v).reshape(b, s, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token decode. q: (B,1,H,D); caches (B,T,Kh,D); cache_len
    (B,) valid entries per slot."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, kh, h // kh, d) * (d**-0.5)
    scores = _scores(qg, k_cache)  # (B,Kh,G,1,T)
    valid = torch.arange(t, device=q.device)[None, :] \
        < cache_len.reshape(-1, 1)
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return _attend(w, v_cache).reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# The attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_ported(cfg)
        h, khd, d, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, \
            cfg.head_dim
        self.cfg = cfg
        self.wq = tnn.Dense(d, h * hd, use_bias=cfg.qkv_bias,
                            generator=generator)
        self.wk = tnn.Dense(d, khd * hd, use_bias=cfg.qkv_bias,
                            generator=generator)
        self.wv = tnn.Dense(d, khd * hd, use_bias=cfg.qkv_bias,
                            generator=generator)
        self.wo = tnn.Dense(h * hd, d, use_bias=False, generator=generator)


def _project_qkv(attn: Attention, x: torch.Tensor, positions: torch.Tensor):
    cfg = attn.cfg
    b, s, _ = x.shape
    q = attn.wq(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = attn.wk(x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = attn.wv(x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos_scheme == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(attn: Attention, x: torch.Tensor, *,
               positions: torch.Tensor, causal: bool = True):
    """Full-sequence attention (train / prefill). x: (B, S, d).
    Returns (y, (k, v))."""
    cfg = attn.cfg
    b, s, _ = x.shape
    q, k, v = _project_qkv(attn, x, positions)
    if cfg.attn_impl == "auto" and s > cfg.attn_chunk \
            and s % cfg.attn_chunk == 0:
        raise NotImplementedError("chunked attention is not yet ported to "
                                  "torch")
    out = dense_attention(q, k, v, causal=causal)
    y = attn.wo(out.reshape(b, s, cfg.num_heads * cfg.head_dim))
    return y, (k, v)


def attn_decode(attn: Attention, x: torch.Tensor, *, pos,
                k_cache: torch.Tensor, v_cache: torch.Tensor):
    """One decode step. x: (B, 1, d); caches (B, T, Kh, D).

    `pos` is the absolute token position per slot, an int vector (B,), or
    one int for the whole batch.  The new K/V row is written into the
    caches IN PLACE at min(pos, T-1) before attending (the reference
    returns updated copies instead).  Returns y.
    """
    b = x.shape[0]
    t = k_cache.shape[1]
    if not torch.is_tensor(pos):
        pos = torch.full((b,), int(pos), dtype=torch.long, device=x.device)
    pos = pos.to(torch.long)
    q, k, v = _project_qkv(attn, x, pos[:, None])
    slot = torch.clamp(pos, max=t - 1)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, torch.clamp(pos + 1, max=t))
    return attn.wo(out.reshape(b, 1, -1))
