"""Transformer assembly for the dense family (torch counterpart of
`repro.models.transformer`).

The stack follows the reference's segment plan: ("run", n) segments of n
plain layers and ("memory", i, "lram") layers whose FFN is the paper's
memory block.  The reference scans each run over stacked parameters; here
a run is a `ModuleList` walked by a Python loop, and the converter
(`repro_torch.launch.convert`) splits the stacked arrays per layer.

Modes: full sequence (`forward`, in train mode too, and `prefill`, which
also fills the KV cache) and single-token decode (`decode_step`) with one
position per batch slot.  `loss_fn` is the masked cross-entropy of both
objectives (clm next token, mlm masked positions).
The KV cache keeps the reference's layout (a run's cache stacks a leading
layer axis) and is updated IN PLACE by decode and by `write_cache_slot`.
Other families (MoE, SSM, hybrid, enc-dec, VLM) and PKM memory layers are
not ported yet and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.core import lram as lram_mod
from repro_torch.data import IGNORE
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> list[tuple]:
    """[("run", count) | ("memory", layer_idx, kind)] covering all layers."""
    special = {i: "lram" for i in cfg.lram_layers}
    special.update({i: "pkm" for i in cfg.pkm_layers})
    plan: list[tuple] = []
    run = 0
    for i in range(cfg.num_layers):
        if i in special:
            if run:
                plan.append(("run", run))
                run = 0
            plan.append(("memory", i, special[i]))
        else:
            run += 1
    if run:
        plan.append(("run", run))
    return plan


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.num_experts > 0:
        raise NotImplementedError(
            f"the {cfg.family} family is not yet ported to torch")
    if cfg.pkm_layers:
        raise NotImplementedError("PKM memory layers are not yet ported")
    if cfg.pos_scheme not in ("rope", "learned", "none"):
        raise NotImplementedError(
            f"pos_scheme {cfg.pos_scheme!r} is not yet ported to torch")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig) -> nn.Module:
    return tnn.LayerNorm(cfg.d_model) if cfg.norm == "layer" \
        else tnn.RMSNorm(cfg.d_model)


class _Block(nn.Module):
    """Pre-norm attention + FFN; subclasses provide `ffn`."""

    def __init__(self, cfg: ModelConfig, generator):
        super().__init__()
        self.attn_norm = _norm(cfg)
        self.attn = attention.Attention(cfg, generator=generator)
        self.ffn_norm = _norm(cfg)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def full(self, x, positions, *, causal: bool, train: bool = False):
        """Full-sequence layer. Returns (x, (k, v))."""
        h, kv = attention.attn_apply(self.attn, self.attn_norm(x),
                                     positions=positions, causal=causal)
        x = x + h
        return x + self.ffn(x, train), kv

    def decode(self, x, pos, k_cache, v_cache):
        """Single-token step; writes this token's K/V row in place."""
        x = x + attention.attn_decode(self.attn, self.attn_norm(x), pos=pos,
                                      k_cache=k_cache, v_cache=v_cache)
        return x + self.ffn(x, False)


class Layer(_Block):
    """Attention + MLP."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator)
        self.mlp = MLP(cfg, generator=generator)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.mlp(self.ffn_norm(x))


class MemoryLayer(_Block):
    """Attention + the paper's memory FFN (dense -> LRAM -> dense)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator)
        self.memffn = lram_mod.memffn_init(cfg.d_model, cfg.lram,
                                           generator=generator)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return lram_mod.memffn_apply(self.memffn, self.ffn_norm(x),
                                     train=train)


class Transformer(nn.Module):
    """Parameters are named as the reference's pytree, so `state_dict`
    keys are its paths with run segments split per layer."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_ported(cfg)
        if cfg.dtype != "float32":
            raise NotImplementedError("the port runs float32 models only")
        self.cfg = cfg
        self.embed = tnn.Embedding(cfg.vocab_size, cfg.d_model,
                                   generator=generator)
        self.pos_embed = None if cfg.pos_scheme != "learned" else \
            nn.Parameter(tnn.truncated_normal_(
                torch.empty(cfg.max_seq, cfg.d_model), 0.02, generator))
        self.final_norm = _norm(cfg)
        self.lm_head = None if cfg.tie_embeddings else tnn.Dense(
            cfg.d_model, cfg.vocab_size, use_bias=False, generator=generator
        )
        segs = {}
        for si, seg in enumerate(layer_plan(cfg)):
            if seg[0] == "run":
                segs[f"seg{si}"] = nn.ModuleList(
                    Layer(cfg, generator=generator) for _ in range(seg[1])
                )
            else:
                segs[f"seg{si}"] = MemoryLayer(cfg, generator=generator)
        self.segments = nn.ModuleDict(segs)

    def embed_tokens(self, tokens: torch.Tensor, positions) -> torch.Tensor:
        """Token embeddings, plus the learned position rows where
        configured: `positions` (an int tensor broadcastable to tokens, or
        one int) clamped to the table, as the reference's decode does."""
        x = self.embed(tokens)
        if self.pos_embed is None:
            return x
        pos = torch.as_tensor(positions, device=tokens.device).long()
        pos = torch.clamp(pos, max=self.pos_embed.shape[0] - 1)
        return x + self.pos_embed[pos].to(x.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.lm_head is None:
            return x @ self.embed.embedding.to(x.dtype).T
        return self.lm_head(x)


def init(cfg: ModelConfig, *, seed: int = 0) -> Transformer:
    """A model with weights drawn on the CPU from `seed`, so the same seed
    gives the same weights whatever device the model is moved to."""
    return Transformer(cfg, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def forward(model: Transformer, batch: dict, *,
            train: bool = False) -> torch.Tensor:
    """Full-sequence forward: batch["tokens"] (B, S) -> logits (B, S, V).
    In train mode the memory layers' batchnorm stats update in place."""
    tokens = batch["tokens"]
    causal = model.cfg.objective == "clm"
    positions = _positions(tokens)
    x = model.embed_tokens(tokens, positions)
    for seg in model.segments.values():
        for layer in (seg if isinstance(seg, nn.ModuleList) else (seg,)):
            x, _ = layer.full(x, positions, causal=causal, train=train)
    return model.logits(x)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(model: Transformer, batch: dict, *, train: bool = True):
    """(loss, metrics): the mean cross-entropy over the positions whose
    label is not `IGNORE` (denominator at least 1), plus the router aux
    term (zero for the dense family).  In train mode the forward runs the
    batchnorm on batch statistics and updates its running stats."""
    logits = forward(model, batch, train=train)
    labels = batch["labels"]
    valid = labels != IGNORE
    safe_labels = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_ll = torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    xent = -(tok_ll * valid).sum() / denom
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    loss = xent + model.cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux, "ntokens": denom}


# ---------------------------------------------------------------------------
# KV-cache serving: cache construction, prefill, decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Nested dict of (shape, dtype), the reference's layout: a run's
    leaves stack a leading layer axis."""
    dtype = getattr(torch, cfg.dtype)
    kvd = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    shapes = {}
    for si, seg in enumerate(layer_plan(cfg)):
        lead = (seg[1],) if seg[0] == "run" else ()
        shapes[f"seg{si}"] = {"k": (lead + kvd, dtype),
                              "v": (lead + kvd, dtype)}
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return {name: {k: torch.zeros(shape, dtype=dtype, device=device)
                   for k, (shape, dtype) in leaves.items()}
            for name, leaves in cache_shapes(cfg, batch, max_len).items()}


def cache_batch_axes(cfg: ModelConfig, max_len: int):
    """The cache's structure with each leaf's batch-axis index, found by
    diffing `cache_shapes` at two batch sizes."""
    one = cache_shapes(cfg, 1, max_len)
    two = cache_shapes(cfg, 2, max_len)

    def axis(a, b):
        for i, (da, db) in enumerate(zip(a[0], b[0])):
            if da != db:
                return i
        raise ValueError(f"cache leaf {a[0]} has no batch axis")

    return {name: {k: axis(one[name][k], two[name][k]) for k in leaves}
            for name, leaves in one.items()}


def write_cache_slot(cache, sub_cache, slot: int, axes) -> None:
    """Copy a batch=1 `sub_cache` (from a single-request prefill) into
    batch slot `slot` of the slotted cache, IN PLACE."""
    for name, leaves in cache.items():
        for k, leaf in leaves.items():
            leaf.narrow(axes[name][k], slot, 1).copy_(sub_cache[name][k])


def _layers_with_cache(model: Transformer, cache):
    """(layer, k cache view, v cache view) for every layer, in order."""
    for name, seg in model.segments.items():
        c = cache[name]
        if isinstance(seg, nn.ModuleList):
            for i, layer in enumerate(seg):
                yield layer, c["k"][i], c["v"][i]
        else:
            yield seg, c["k"], c["v"]


def prefill(model: Transformer, tokens: torch.Tensor, max_len: int):
    """Run the prompt (B, S), building the decode cache. Returns
    (logits (B, S, V), cache) with positions >= S left zero."""
    cfg = model.cfg
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len={max_len}")
    cache = init_cache(cfg, b, max_len, tokens.device)
    positions = _positions(tokens)
    x = model.embed_tokens(tokens, positions)
    for layer, kc, vc in _layers_with_cache(model, cache):
        x, (k, v) = layer.full(x, positions, causal=True)
        kc[:, :s] = k
        vc[:, :s] = v
    return model.logits(x), cache


def decode_step(model: Transformer, tokens: torch.Tensor, pos,
                cache) -> torch.Tensor:
    """One serving step: tokens (B, 1) at absolute positions `pos` (an int
    vector (B,), one per slot, or one int).  Updates `cache` in place and
    returns logits (B, 1, V)."""
    x = model.embed_tokens(tokens, pos[:, None] if torch.is_tensor(pos)
                           else pos)
    for layer, kc, vc in _layers_with_cache(model, cache):
        x = layer.decode(x, pos, kc, vc)
    return model.logits(x)
