"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060; torch counterpart
of `repro.models.mamba2`).

The recurrence, per head, with a (N, P) state:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ,   y_t = C_t h_t + D x_t

`ssd_chunked` computes it over chunks of Q positions: within a chunk as
a masked, decay-weighted Q x Q product, across chunks by carrying one
state per head; `ssd_sequential` steps it position by position (the
oracle, short prompts and the decode).  `mamba_apply` takes the chunked
form only where the length is a multiple of `ssm_chunk` and above 1, as
the reference's does.  The scan runs in float32 whatever the model's
dtype; `A_log`, `D` and `dt_bias` stay float32 leaves in a bfloat16 or
float16 model.  The prefill's causal conv rounds its output to the model's
dtype, the decode's keeps it float32: the reference's asymmetry, kept.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import nn as tnn
from repro_torch.models.config import ModelConfig


def _dims(cfg: ModelConfig):
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    return di, h, p, g, n, di + 2 * g * n


def _repeat(t: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Each entry along `dim` repeated `r` times in place (`jnp.repeat`):
    a group's B / C shared by its heads."""
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1)
    return t.expand(*shape[:dim + 1], r, *shape[dim + 1:]).flatten(
        dim, dim + 1)


class Mamba(nn.Module):
    """The mixer's leaves, named as the reference's `mamba_init` tree:
    `in_proj` (d -> z, x, B, C, dt), `conv` (K, C) depthwise, `A_log`,
    `D`, `dt_bias` (float32 always; `A_log` and `dt_bias` drawn from
    `np.random.default_rng(0)` as the reference's, so equal to its for
    every layer), the gate's `norm` and `out_proj`."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        di, h, p, g, n, conv_ch = _dims(cfg)
        dtype = cfg.torch_dtype
        self.in_proj = tnn.Dense(cfg.d_model, 2 * di + 2 * g * n + h,
                                 use_bias=False, generator=generator,
                                 dtype=dtype)
        self.conv = nn.Parameter(tnn.fan_in_init_(
            torch.empty(cfg.ssm_conv, conv_ch, dtype=dtype), generator))
        # dt bias: softplus^-1 of dt ~ U[1e-3, 1e-1] (log-uniform)
        rng = np.random.default_rng(0)
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(h,))
                    ).astype(np.float32)
        dt_bias = dt + np.log(-np.expm1(-dt))
        a_log = np.log(rng.uniform(1.0, 16.0, size=(h,))).astype(np.float32)
        self.A_log = nn.Parameter(torch.tensor(a_log))
        self.D = nn.Parameter(torch.ones(h, dtype=torch.float32))
        self.dt_bias = nn.Parameter(torch.tensor(dt_bias))
        self.norm = tnn.RMSNorm(di, dtype=dtype)
        self.out_proj = tnn.Dense(di, cfg.d_model, use_bias=False,
                                  generator=generator, dtype=dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (K, C): out_t = sum_j
    x_{t-K+1+j} w_j (zeros before the start), in float32, cast to
    x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    w = w.float()
    out = xp[:, :s] * w[0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * w[j]
    return out.to(x.dtype)


def split_proj(m: Mamba, u: torch.Tensor):
    """in_proj(u) split into (z, xBC, dt_raw)."""
    di, _, _, _, _, conv_ch = _dims(m.cfg)
    zxbcdt = m.in_proj(u)
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_ch],
            zxbcdt[..., di + conv_ch:])


def post_conv(m: Mamba, xbc: torch.Tensor, dt_raw: torch.Tensor):
    """silu, then the split into x (.., h, p), B, C (.., g, n), all
    float32, and dt = softplus(dt_raw + dt_bias) (.., h)."""
    di, h, p, g, n, _ = _dims(m.cfg)
    xbc = F.silu(xbc.float())
    lead = xbc.shape[:-1]
    x = xbc[..., :di].reshape(*lead, h, p)
    B = xbc[..., di:di + g * n].reshape(*lead, g, n)
    C = xbc[..., di + g * n:].reshape(*lead, g, n)
    z = dt_raw.float() + m.dt_bias
    dt = torch.logaddexp(z, torch.zeros_like(z))  # jax.nn.softplus
    return x, B, C, dt


def ssd_chunked(x, B, C, dt, A, *, chunk: int, h0=None):
    """Chunked SSD scan.  x (b, S, h, p); B, C (b, S, g, n); dt (b, S, h);
    A (h,) negative; S a multiple of `chunk`.  Returns y (b, S, h, p) and
    the final state (b, h, n, p), float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    if s % chunk:
        raise ValueError(f"length {s} is not a multiple of chunk {chunk}")
    nc, q = s // chunk, chunk
    xr = x.reshape(b, nc, q, h, p).float()
    Br = B.reshape(b, nc, q, g, n).float()
    Cr = C.reshape(b, nc, q, g, n).float()
    dtr = dt.reshape(b, nc, q, h)

    cl = torch.cumsum(dtr * A, dim=2)  # inclusive log decay, (b,nc,q,h)
    cl_last = cl[:, :, -1:, :]
    dx = xr * dtr[..., None]  # dt-weighted inputs

    # intra-chunk: scores_ij = (C_i . B_j) exp(cl_i - cl_j) [j <= i]; the
    # upper triangle (j > i, exponents >= 0) is masked before the exp:
    # masked after it, as the reference does, a chunk whose decay spans
    # more than ~88 overflows there to inf, and the backward's 0 * inf
    # makes every gradient NaN.  The forward is the reference's bit for
    # bit (exp(-inf) = 0 where the mask zeroes the score anyway)
    cb = _repeat(torch.einsum("bcqgn,bckgn->bcgqk", Cr, Br), hg, 2)
    clh = cl.permute(0, 1, 3, 2)  # (b,nc,h,q)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask, clh[..., :, None]
                                  - clh[..., None, :], -torch.inf))
    scores = torch.where(mask, cb * decay, 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, dx)

    # each chunk's summary state: sum_j exp(cl_last - cl_j) B_j dx_j^T
    Bh = _repeat(Br, hg, 3)  # (b,nc,q,h,n)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp",
                               Bh * torch.exp(cl_last - cl)[..., None], dx)

    # carry the state across chunks; each chunk reads its starting state
    hc = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    chunk_decay = torch.exp(cl_last[:, :, 0, :])  # (b,nc,h)
    starts = []
    for c in range(nc):
        starts.append(hc)
        hc = hc * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_starts = torch.stack(starts, dim=1)  # (b,nc,h,n,p)

    # inter-chunk: y_i += exp(cl_i) C_i . h_start
    Ch = _repeat(Cr, hg, 3)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Ch * torch.exp(cl)[..., None], h_starts)
    return (y_intra + y_inter).reshape(b, s, h, p), hc


def ssd_sequential(x, B, C, dt, A, *, h0=None):
    """The recurrence position by position (the oracle, and the decode's
    one step).  Shapes as `ssd_chunked`'s, any S."""
    b, s, h, p = x.shape
    hg = h // B.shape[2]
    hs = (torch.zeros((b, h, B.shape[3], p), dtype=torch.float32,
                      device=x.device) if h0 is None else h0.float())
    x, B, C = x.float(), B.float(), C.float()
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t] * A)  # (b,h)
        Bh = _repeat(B[:, t], hg, 1)  # (b,h,n)
        Ch = _repeat(C[:, t], hg, 1)
        upd = torch.einsum("bhn,bhp->bhnp", Bh, x[:, t] * dt[:, t, :, None])
        hs = hs * a[:, :, None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch, hs))
    return torch.stack(ys, dim=1), hs


def _gate_out(m: Mamba, y, x, z, u):
    """y + D x, gated by silu(z), normed, projected (in u's dtype)."""
    y = y + m.D[:, None] * x
    y = y.reshape(*u.shape[:-1], m.cfg.d_inner)
    y = y * F.silu(z.float())
    return m.out_proj(m.norm(y).to(u.dtype))


def mamba_full(m: Mamba, u: torch.Tensor, *, chunked: bool = True):
    """The full-sequence mixer, u (B, S, d): (output (B, S, d), final
    state (B, h, n, p), the conv's raw input xBC (B, S, C))."""
    cfg = m.cfg
    z, xbc_raw, dt_raw = split_proj(m, u)
    xbc = causal_conv(xbc_raw, m.conv)
    x, B, C, dt = post_conv(m, xbc, dt_raw)
    A = -torch.exp(m.A_log)
    s = u.shape[1]
    if chunked and s % cfg.ssm_chunk == 0 and s > 1:
        y, hf = ssd_chunked(x, B, C, dt, A, chunk=cfg.ssm_chunk)
    else:
        y, hf = ssd_sequential(x, B, C, dt, A)
    return _gate_out(m, y, x, z, u), hf, xbc_raw


def mamba_apply(m: Mamba, u: torch.Tensor, *,
                chunked: bool = True) -> torch.Tensor:
    """Full-sequence forward, u (B, S, d_model) -> (B, S, d_model)."""
    return mamba_full(m, u, chunked=chunked)[0]


def conv_tail(cfg: ModelConfig, xbc_raw: torch.Tensor) -> torch.Tensor:
    """The decode's conv window after a prefill: the last K-1 raw inputs
    (B, K-1, C) in float32, left-padded with zeros when S < K-1."""
    nconv, s = cfg.ssm_conv - 1, xbc_raw.shape[1]
    if s >= nconv:
        tail = xbc_raw[:, s - nconv:]
    else:
        tail = F.pad(xbc_raw, (0, 0, nconv - s, 0))
    return tail.float()


def mamba_cache_shapes(cfg: ModelConfig, batch: int):
    _, h, p, _, n, conv_ch = _dims(cfg)
    return {"ssm": (batch, h, n, p),
            "conv": (batch, cfg.ssm_conv - 1, conv_ch)}


def mamba_decode(m: Mamba, u: torch.Tensor, cache) -> torch.Tensor:
    """One token, u (B, 1, d); `cache` {"ssm": (B, h, n, p), "conv":
    (B, K-1, C)}, float32, updated IN PLACE.  The conv's output stays
    float32 here (the prefill's is cast to the model's dtype), as the
    reference's decode."""
    z, xbc, dt_raw = split_proj(m, u)
    win = torch.cat([cache["conv"], xbc.float()], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", win, m.conv.float())[:, None]
    x, B, C, dt = post_conv(m, conv_out, dt_raw)
    A = -torch.exp(m.A_log)
    y, h_new = ssd_sequential(x, B, C, dt, A, h0=cache["ssm"])
    cache["conv"].copy_(win[:, 1:])
    cache["ssm"].copy_(h_new)
    return _gate_out(m, y, x, z, u)
