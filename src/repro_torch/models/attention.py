"""Attention: GQA with split-half RoPE or M-RoPE, sliding window,
cross attention, full-sequence, chunked and per-slot decode (torch
counterpart of `repro.models.attention`).

Three paths, as the reference's:

  * dense    — materialises the (S, T) scores; short sequences.
  * chunked  — the streaming softmax over query and KV chunks (running
               max, denominator and accumulator carried across KV
               chunks): peak activation O(chunk^2), not O(S^2).  Taken
               when `attn_impl == "chunked"`, or `auto` with S above
               `attn_chunk`, whenever S is a multiple of the chunk.
  * decode   — one query per slot against the cache; a sliding-window
               model's cache is a ring of `window` slots (position p in
               slot p % window).

Plain torch matmuls and softmax in float32 whatever the activation dtype,
masked with -1e30 as the reference does (no fused attention call: the
reference computes attention outside any Pallas kernel).  The decode's
attend runs in the cache's dtype, as the reference's.

M-RoPE (qwen2-vl): positions (3, B, S) for (t, h, w); the rotation's
frequency bands are split between the three streams by
`cfg.mrope_sections`, angles in float32.  A decode step puts its one
position on all three streams.  Cross attention (the enc-dec decoder):
the keys and values are the encoder output's projections, given whole
(`cross_kv`); the query is this layer's, never chunked under `auto`, and
a cross decode step attends over every encoder row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.models.config import ModelConfig

_NEG_INF = -1e30


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


@functools.lru_cache(maxsize=None)
def _bands_on(sections: tuple[int, ...], device: torch.device
              ) -> torch.Tensor:
    """The position stream (0, 1, 2: t, h, w) of each frequency band."""
    with torch.inference_mode(False):
        return torch.repeat_interleave(
            torch.arange(len(sections)), torch.tensor(sections)).to(device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE: x (B, S, H, D), positions (3, B, S) int; frequency
    band j turns by the position of stream `bands[j]` (the reference's
    one-hot selection, exact in float32)."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"mrope_sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = _frequencies_on(d, theta, x.device)
    sel = positions.float()[_bands_on(tuple(sections), x.device)]
    angles = sel.permute(1, 2, 0) * freqs  # (B, S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
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


def _valid(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
           window: int | None) -> torch.Tensor:
    """Key k_pos is visible to query q_pos (broadcast)."""
    ok = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


@functools.lru_cache(maxsize=None)
def _scale(d: int, dtype: torch.dtype) -> float:
    """1/sqrt(d) rounded to `dtype`: JAX casts a Python scalar to the
    array's dtype before it multiplies (a weak type), so the reference
    scales bfloat16 (float16) queries by the bfloat16 (float16) nearest to
    1/sqrt(d), where torch would multiply by the float32 one and round
    after."""
    return torch.tensor(d**-0.5, dtype=dtype).item()


def _band_mask(s: int, t: int, *, causal: bool, window: int | None = None,
               q_offset: int = 0, device=None) -> torch.Tensor:
    """(S, T) validity mask; query i sits at absolute position
    q_offset + i."""
    qi = torch.arange(s, device=device)[:, None] + q_offset
    kj = torch.arange(t, device=device)[None, :]
    return _valid(qi, kj, causal=causal, window=window)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,D), k/v: (B,T,Kh,D) -> (B,S,H,D)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, d) * _scale(d, q.dtype)
    scores = _scores(qg, k)
    mask = _band_mask(s, k.shape[1], causal=causal, window=window,
                      q_offset=q_offset, device=q.device)
    scores = torch.where(mask, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return _attend(w, v).reshape(b, s, h, d).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int | None = None,
                      q_chunk: int = 2048,
                      kv_chunk: int = 2048) -> torch.Tensor:
    """Flash-style streaming-softmax attention, O(chunk^2) peak memory:
    over query chunks, and inside over KV chunks carrying (running max,
    denominator, weighted accumulator), in the reference's order and
    arithmetic.  q: (B,S,H,D), k/v: (B,T,Kh,D) -> (B,S,H,D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if s % q_chunk or t % kv_chunk:
        raise ValueError(f"chunked attention needs S={s} and T={t} to be "
                         f"multiples of the chunks ({q_chunk}, {kv_chunk})")
    g = h // kh
    qg = q.reshape(b, s, kh, g, d) * _scale(d, q.dtype)
    pos_q = torch.arange(q_chunk, device=q.device)[:, None]
    pos_k = torch.arange(kv_chunk, device=q.device)[None, :]
    outs = []
    for qi in range(s // q_chunk):
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        m = torch.full((b, kh, g, q_chunk), _NEG_INF, device=q.device)
        l_sum = torch.zeros((b, kh, g, q_chunk), device=q.device)
        acc = torch.zeros((b, kh, g, q_chunk, d), device=q.device)
        for kj in range(t // kv_chunk):
            ks = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            scores = torch.einsum("bskgd,btkd->bkgst", q_blk,
                                  k[:, ks].float())  # (B,Kh,G,qc,kc)
            ok = _valid(qi * q_chunk + pos_q, kj * kv_chunk + pos_k,
                        causal=causal, window=window)
            scores = torch.where(ok, scores, _NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l_sum = l_sum * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, v[:, ks].float())
            m = m_new
        outs.append(acc / torch.clamp(l_sum, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)  # (B, nq, Kh, G, qc, D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, h, d)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token decode. q: (B,1,H,D); caches (B,T,Kh,D); cache_len
    (B,) valid entries per slot.  A ring cache (sliding window) has
    every slot valid once full; its positions are unordered, which the
    softmax does not see."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, kh, h // kh, d) * _scale(d, q.dtype)
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
        h, khd, d, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, \
            cfg.head_dim
        self.cfg = cfg
        kw = {"generator": generator, "dtype": cfg.torch_dtype}
        self.wq = tnn.Dense(d, h * hd, use_bias=cfg.qkv_bias, **kw)
        self.wk = tnn.Dense(d, khd * hd, use_bias=cfg.qkv_bias, **kw)
        self.wv = tnn.Dense(d, khd * hd, use_bias=cfg.qkv_bias, **kw)
        self.wo = tnn.Dense(h * hd, d, use_bias=False, **kw)


def _rotate(cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    if cfg.pos_scheme == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos_scheme == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


def _project_q(attn: Attention, x: torch.Tensor, positions: torch.Tensor):
    cfg = attn.cfg
    b, s, _ = x.shape
    q = attn.wq(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    return _rotate(cfg, q, positions)


def _project_qkv(attn: Attention, x: torch.Tensor, positions: torch.Tensor):
    cfg = attn.cfg
    b, s, _ = x.shape
    k = attn.wk(x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = attn.wv(x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return _project_q(attn, x, positions), _rotate(cfg, k, positions), v


def project_kv(attn: Attention, enc: torch.Tensor):
    """The cross attention's keys and values of an encoder output (B, T,
    d): (B, T, Kh, D) each, unrotated (the reference's per-layer `cross`
    projections)."""
    cfg = attn.cfg
    b, t, _ = enc.shape
    return (attn.wk(enc).reshape(b, t, cfg.num_kv_heads, cfg.head_dim),
            attn.wv(enc).reshape(b, t, cfg.num_kv_heads, cfg.head_dim))


def attn_apply(attn: Attention, x: torch.Tensor, *,
               positions: torch.Tensor, causal: bool = True,
               cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Full-sequence attention (train / prefill). x: (B, S, d); with
    `cross_kv` the keys and values are those (B, T, Kh, D) instead of x's
    own.  Returns (y, (k, v))."""
    cfg = attn.cfg
    b, s, _ = x.shape
    if cross_kv is None:
        q, k, v = _project_qkv(attn, x, positions)
    else:
        q, (k, v) = _project_q(attn, x, positions), cross_kv
    window = cfg.window if cfg.attention == "swa" else None
    use_chunked = cfg.attn_impl == "chunked" or (
        cfg.attn_impl == "auto" and s > cfg.attn_chunk and cross_kv is None)
    if use_chunked and s % cfg.attn_chunk == 0:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                q_chunk=cfg.attn_chunk,
                                kv_chunk=cfg.attn_chunk)
    else:
        out = dense_attention(q, k, v, causal=causal, window=window)
    y = attn.wo(out.reshape(b, s, cfg.num_heads * cfg.head_dim))
    return y, (k, v)


def attn_decode(attn: Attention, x: torch.Tensor, *, pos,
                k_cache: torch.Tensor, v_cache: torch.Tensor):
    """One decode step. x: (B, 1, d); caches (B, T, Kh, D).

    `pos` is the absolute token position per slot, an int vector (B,), or
    one int for the whole batch.  The new K/V row is written into the
    caches IN PLACE before attending (the reference returns updated
    copies instead): at min(pos, T-1), or for a sliding window into the
    ring's slot pos % T, after which min(pos + 1, T) slots are valid.
    Every index is computed on the device from `pos`, so the step can be
    captured in a CUDA graph.  Returns y.
    """
    b = x.shape[0]
    t = k_cache.shape[1]
    pos = _slot_positions(pos, b, x.device)
    q, k, v = _project_qkv(attn, x, _decode_positions(attn.cfg, pos))
    if attn.cfg.attention == "swa":
        slot = torch.remainder(pos, t)
    else:
        slot = torch.clamp(pos, max=t - 1)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, torch.clamp(pos + 1, max=t))
    return attn.wo(out.reshape(b, 1, -1))


def _slot_positions(pos, b: int, device) -> torch.Tensor:
    """`pos` as a long vector (B,): one int is every slot's."""
    if not torch.is_tensor(pos):
        return torch.full((b,), int(pos), dtype=torch.long, device=device)
    return pos.to(torch.long)


def _decode_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """A decode step's rotation positions: (B, 1), or (3, B, 1) for
    M-RoPE (the one position on every stream, as the reference's)."""
    if cfg.pos_scheme == "mrope":
        return pos[None, :, None].expand(3, -1, 1)
    return pos[:, None]


def cross_decode(attn: Attention, x: torch.Tensor, *, pos,
                 k_cache: torch.Tensor, v_cache: torch.Tensor):
    """One decode step's cross attention: x (B, 1, d) attends over every
    row of the encoder's keys and values (B, T, Kh, D), which stay as
    they are.  Returns y."""
    b = x.shape[0]
    pos = _slot_positions(pos, b, x.device)
    q = _project_q(attn, x, _decode_positions(attn.cfg, pos))
    t = torch.full((b,), k_cache.shape[1], dtype=torch.long,
                   device=x.device)
    out = decode_attention(q, k_cache, v_cache, t)
    return attn.wo(out.reshape(b, 1, -1))
