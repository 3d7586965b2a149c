"""Transformer assembly for the dense, MoE and SSM families (torch
counterpart of `repro.models.transformer`).

The stack follows the reference's segment plan: ("run", n) segments of n
plain layers and ("memory", i, "lram") layers whose FFN is the paper's
memory block.  The reference scans each run over stacked parameters; here
a run is a `ModuleList` walked by a Python loop, and the converter
(`repro_torch.launch.convert`) splits the stacked arrays per layer.

A plain layer is attention + MLP (dense), attention + the top-k MoE
(`models.moe`, when `num_experts` > 0), or norm + the Mamba-2 mixer
(`models.mamba2`, family "ssm").  A memory layer is attention + the
memory FFN; on an SSM host it has no attention: the memory FFN sits on
the residual stream (the reference's `_memory_layer_full`), though the
layer still owns the unused `attn_norm` / `attn` leaves the reference's
`_memory_layer_init` builds.  The MoE layers' router losses are summed
into `loss_fn`'s aux term, run by run.

Modes: full sequence (`forward`, in train mode too, and `prefill`, which
also fills the decode cache) and single-token decode (`decode_step`) with
one position per batch slot.  `loss_fn` is the masked cross-entropy of
both objectives (clm next token, mlm masked positions) plus
`router_aux_weight` times the aux loss.  The decode cache keeps the
reference's layout (a run's leaves stack a leading layer axis): K/V for
attention, the float32 SSM state and conv window for a Mamba run, nothing
for a memory layer on an SSM host.  It is updated IN PLACE by decode and
by `write_cache_slot`.  A ("memory", i, "pkm") layer's FFN is the
product-key memory baseline (`repro_torch.core.pkm`), applied to the
normed residual with no dense around it.  Weights, activations and the
KV cache take `cfg.dtype` (float32 or bfloat16; a memory table stays
float32).  A sliding-window model's cache holds `min(window, max_len)`
positions per layer as a ring (position p in slot p % window): a prefill
longer than the window keeps its last `window` positions, permuted into
their ring slots.  The hybrid, enc-dec and VLM families are not ported
yet and raise, naming ROADMAP A14.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch import nn as tnn
from repro_torch.core import lram as lram_mod
from repro_torch.core import pkm as pkm_mod
from repro_torch.data import IGNORE
from repro_torch.distributed import collectives, context
from repro_torch.models import attention, mamba2, moe
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
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"the {cfg.family} family is not yet ported to torch: "
            f"ROADMAP A14")
    if cfg.pos_scheme not in ("rope", "learned", "none"):
        raise NotImplementedError(
            f"pos_scheme {cfg.pos_scheme!r} is not yet ported to torch: "
            f"ROADMAP A14")
    if cfg.pkm_layers and cfg.dtype != "float32":
        raise NotImplementedError("the PKM layer runs float32 models only")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig) -> nn.Module:
    norm = tnn.LayerNorm if cfg.norm == "layer" else tnn.RMSNorm
    return norm(cfg.d_model, dtype=cfg.torch_dtype)


class _Block(nn.Module):
    """Pre-norm attention + FFN; subclasses provide `ffn` (and `ffn_full`
    where the FFN reports more than its output)."""

    def __init__(self, cfg: ModelConfig, generator):
        super().__init__()
        self.attn_norm = _norm(cfg)
        self.attn = attention.Attention(cfg, generator=generator)
        self.ffn_norm = _norm(cfg)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        raise NotImplementedError

    def ffn_full(self, x: torch.Tensor, train: bool, collect_access: bool):
        """(ffn(x), the memory read's (idx, w) or None, the router's aux
        loss or None)."""
        return self.ffn(x, train), None, None

    def full(self, x, positions, *, causal: bool, train: bool = False,
             collect_access: bool = False):
        """Full-sequence layer: (x, (k, v) or None, the memory read's (idx,
        w) with `collect_access` or None, the MoE router's aux loss or
        None)."""
        h, kv = attention.attn_apply(self.attn, self.attn_norm(x),
                                     positions=positions, causal=causal)
        x = x + h
        h, access, aux = self.ffn_full(x, train, collect_access)
        return x + h, kv, access, aux

    def decode(self, x, pos, cache):
        """Single-token step; writes this token's K/V row in place."""
        x = x + attention.attn_decode(self.attn, self.attn_norm(x), pos=pos,
                                      k_cache=cache["k"],
                                      v_cache=cache["v"])
        return x + self.ffn(x, False)


class Layer(_Block):
    """Attention + MLP."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator)
        self.mlp = MLP(cfg, generator=generator)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.mlp(self.ffn_norm(x))


class MoELayer(_Block):
    """Attention + the top-k mixture of experts (`moe`)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator)
        self.moe = moe.MoE(cfg, generator=generator)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return moe.moe_apply(self.moe, self.ffn_norm(x))[0]

    def ffn_full(self, x: torch.Tensor, train: bool, collect_access: bool):
        y, aux = moe.moe_apply(self.moe, self.ffn_norm(x))
        return y, None, aux


class SSMLayer(nn.Module):
    """Norm + the Mamba-2 mixer (`mamba`); its decode cache is the SSM
    state and the conv window, float32."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm = _norm(cfg)
        self.mamba = mamba2.Mamba(cfg, generator=generator)

    def full(self, x, positions, *, causal: bool, train: bool = False,
             collect_access: bool = False):
        """Full-sequence layer, `_Block.full`'s shape (no K/V, access or
        aux)."""
        return x + mamba2.mamba_apply(self.mamba, self.norm(x)), None, \
            None, None

    def prefill(self, x, cache) -> torch.Tensor:
        """The full-sequence layer that also writes the decode cache: the
        final state and the conv window (the prompt's last K-1 raw conv
        inputs, left-padded; the reference's `_mamba_prefill_body`)."""
        y, hf, xbc_raw = mamba2.mamba_full(self.mamba, self.norm(x))
        cache["ssm"].copy_(hf)
        cache["conv"].copy_(mamba2.conv_tail(self.mamba.cfg, xbc_raw))
        return x + y

    def decode(self, x, pos, cache):
        """Single-token step; updates the SSM state and conv window in
        place."""
        return x + mamba2.mamba_decode(self.mamba, self.norm(x), cache)


class MemoryLayer(_Block):
    """Attention + a memory FFN: the paper's block (dense -> LRAM ->
    dense, `memffn`) for kind "lram", the product-key memory (`pkm`) for
    kind "pkm".  On an SSM host the attention is skipped (its leaves are
    kept, as the reference's) and the layer has no decode cache."""

    def __init__(self, cfg: ModelConfig, kind: str, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator)
        self.kind = kind
        self.attention_free = cfg.family == "ssm"
        if kind == "lram":
            self.memffn = lram_mod.memffn_init(cfg.d_model, cfg.lram,
                                               generator=generator,
                                               dtype=cfg.torch_dtype)
        else:
            self.pkm = pkm_mod.pkm_init(cfg.d_model, cfg.pkm,
                                        generator=generator)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.kind == "lram":
            return lram_mod.memffn_apply(self.memffn, self.ffn_norm(x),
                                         train=train)
        return pkm_mod.pkm_apply(self.pkm, self.ffn_norm(x), train=train)

    def ffn_full(self, x: torch.Tensor, train: bool, collect_access: bool):
        if self.kind == "lram" and collect_access:
            h, access = lram_mod.memffn_apply(
                self.memffn, self.ffn_norm(x), train=train,
                return_access=True)
            return h, access, None
        return self.ffn(x, train), None, None

    def full(self, x, positions, *, causal: bool, train: bool = False,
             collect_access: bool = False):
        if not self.attention_free:
            return super().full(x, positions, causal=causal, train=train,
                                collect_access=collect_access)
        h, access, _ = self.ffn_full(x, train, collect_access)
        return x + h, None, access, None

    def decode(self, x, pos, cache):
        if self.attention_free:
            return x + self.ffn(x, False)
        return super().decode(x, pos, cache)


def _layer_class(cfg: ModelConfig):
    """A run's layer: by family, and MoE where experts are configured."""
    if cfg.family == "ssm":
        return SSMLayer
    return MoELayer if cfg.num_experts > 0 else Layer


class Transformer(nn.Module):
    """Parameters are named as the reference's pytree, so `state_dict`
    keys are its paths with run segments split per layer."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dtype = cfg.torch_dtype
        self.embed = tnn.Embedding(cfg.vocab_size, cfg.d_model,
                                   generator=generator, dtype=dtype)
        self.pos_embed = None if cfg.pos_scheme != "learned" else \
            nn.Parameter(tnn.truncated_normal_(
                torch.empty(cfg.max_seq, cfg.d_model, dtype=dtype), 0.02,
                generator))
        self.final_norm = _norm(cfg)
        self.lm_head = None if cfg.tie_embeddings else tnn.Dense(
            cfg.d_model, cfg.vocab_size, use_bias=False, generator=generator,
            dtype=dtype)
        segs = {}
        for si, seg in enumerate(layer_plan(cfg)):
            if seg[0] == "run":
                segs[f"seg{si}"] = nn.ModuleList(
                    _layer_class(cfg)(cfg, generator=generator)
                    for _ in range(seg[1]))
            else:
                segs[f"seg{si}"] = MemoryLayer(cfg, seg[2],
                                                generator=generator)
        self.segments = nn.ModuleDict(segs)
        # on a mesh, this rank's blocks of the dense leaves and their
        # gather (`distributed.sharding.shard_params`); None: whole
        self.placement = None

    def embed_tokens(self, tokens: torch.Tensor, positions) -> torch.Tensor:
        """Token embeddings, plus the learned position rows where
        configured: `positions` (an int tensor broadcastable to tokens, or
        one int) clamped to the table, as the reference's decode does.
        Every forward starts here: it raises while the dense leaves are
        this rank's blocks (`sharding.gathered` makes them whole)."""
        if self.placement is not None:
            self.placement.check()
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


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Transformer:
    """A model with weights drawn from `seed`, leaf by leaf.

    Without `device` (or on "cpu") the weights are drawn on the CPU, so
    the same seed gives the same weights whatever device the model is
    moved to.  With a CUDA `device` every leaf is drawn there, from a
    generator on that device: a full-width model never passes through
    host memory, and only its largest leaf is ever held in float32 at
    once.  A seed drawn on "cuda" gives other weights than the same seed
    on the CPU."""
    device = torch.device("cpu" if device is None else device)
    generator = torch.Generator(device=device).manual_seed(seed)
    place = (contextlib.nullcontext() if device.type == "cpu"
             else torch.device(device))
    with place:
        return Transformer(cfg, generator=generator)


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def _forward(model: Transformer, batch: dict, *, train: bool,
             collect_access: bool):
    """(logits, {segment: (idx, w)} (empty without `collect_access`), the
    router losses summed: each run's layers', then over runs, as the
    reference's scan sums them; float32 zero without an MoE layer)."""
    tokens = batch["tokens"]
    causal = model.cfg.objective == "clm"
    positions = _positions(tokens)
    x = model.embed_tokens(tokens, positions)
    accesses = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for name, seg in model.segments.items():
        auxs = []
        for layer in (seg if isinstance(seg, nn.ModuleList) else (seg,)):
            x, _, access, aux = layer.full(x, positions, causal=causal,
                                           train=train,
                                           collect_access=collect_access)
            if access is not None:
                accesses[name] = access
            if aux is not None:
                auxs.append(aux)
        if auxs:
            aux_total = aux_total + torch.stack(auxs).sum()
    return model.logits(x), accesses, aux_total


def forward(model: Transformer, batch: dict, *, train: bool = False,
            collect_access: bool = False):
    """Full-sequence forward: batch["tokens"] (B, S) -> logits (B, S, V).
    In train mode the memory layers' batchnorm stats update in place.
    With `collect_access` returns (logits, {segment: (idx, w)}), one
    entry an LRAM memory segment, named as the reference's (the telemetry
    train step counts `idx`)."""
    logits, accesses, _ = _forward(model, batch, train=train,
                                   collect_access=collect_access)
    return (logits, accesses) if collect_access else logits


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(model: Transformer, batch: dict, *, train: bool = True,
            collect_access: bool = False):
    """(loss, metrics): the mean cross-entropy over the positions whose
    label is not `IGNORE` (denominator at least 1), plus
    `router_aux_weight` times the MoE layers' router loss (`metrics
    ["aux"]`, zero without one).  In train mode the forward runs the
    batchnorm on batch statistics and updates its running stats.  With
    `collect_access` the forward's memory accesses {segment: (idx, w)}
    come third.

    Under an ambient mesh with a ``data`` axis, a train-mode batch is this
    data rank's slice of the global batch: the denominator is the global
    count of valid labels (summed over the batch axes, ``data`` or
    ("pod", "data")), so the loss is this rank's part of the global loss
    and the parts' gradients sum to the global loss's.  The router loss
    is this rank's (the train CLI refuses an MoE arch on such a mesh)."""
    logits, accesses, aux = _forward(model, batch, train=train,
                                     collect_access=collect_access)
    labels = batch["labels"]
    valid = labels != IGNORE
    safe_labels = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_ll = torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    count = valid.sum()
    if train:
        collectives.all_reduce_(count, context.batch_group())
    denom = torch.clamp(count, min=1)
    xent = -(tok_ll * valid).sum() / denom
    loss = xent + model.cfg.router_aux_weight * aux
    metrics = {"xent": xent, "aux": aux, "ntokens": denom}
    return (loss, metrics, accesses) if collect_access else (loss, metrics)


# ---------------------------------------------------------------------------
# KV-cache serving: cache construction, prefill, decode
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Positions a layer's cache holds: the ring of a sliding window."""
    if cfg.attention == "swa":
        return min(cfg.window, max_len)
    return max_len


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Nested dict of (shape, dtype), the reference's layout: a run's
    leaves stack a leading layer axis.  Attention layers hold K/V in the
    model's dtype; a Mamba run its state (n, B, h, N, P) and conv window
    (n, B, K-1, C), float32; a memory layer on an SSM host nothing."""
    dtype = cfg.torch_dtype
    kvd = (batch, _attn_cache_len(cfg, max_len), cfg.num_kv_heads,
           cfg.head_dim)
    shapes = {}
    for si, seg in enumerate(layer_plan(cfg)):
        lead = (seg[1],) if seg[0] == "run" else ()
        if cfg.family != "ssm":
            shapes[f"seg{si}"] = {"k": (lead + kvd, dtype),
                                  "v": (lead + kvd, dtype)}
        elif seg[0] == "run":
            shapes[f"seg{si}"] = {
                k: (lead + shape, torch.float32)
                for k, shape in mamba2.mamba_cache_shapes(cfg,
                                                          batch).items()}
        else:
            shapes[f"seg{si}"] = {}
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
    """(layer, {leaf: its cache view}) for every layer, in order."""
    for name, seg in model.segments.items():
        c = cache[name]
        if isinstance(seg, nn.ModuleList):
            for i, layer in enumerate(seg):
                yield layer, {k: v[i] for k, v in c.items()}
        else:
            yield seg, c


def ring_fill_order(s: int, t_cache: int, device=None) -> torch.Tensor:
    """The prompt positions a ring of `t_cache` slots keeps after a
    prefill of `s` > `t_cache` positions, in slot order: the last
    `t_cache` positions hit each slot p % t_cache exactly once (the
    reference's `_fill_kv_cache` permutation)."""
    keep = torch.arange(s - t_cache, s, device=device)
    return keep[torch.argsort(keep % t_cache)]


def prefill(model: Transformer, tokens: torch.Tensor, max_len: int):
    """Run the prompt (B, S), building the decode cache. Returns
    (logits (B, S, V), cache).  A full-attention cache holds position p
    at p (positions >= S left zero); a sliding window's ring holds the
    last min(S, window) positions, each in slot p % window; a Mamba layer
    its final state and conv window."""
    cfg = model.cfg
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len={max_len}")
    cache = init_cache(cfg, b, max_len, tokens.device)
    t_cache = _attn_cache_len(cfg, max_len)
    keep = (ring_fill_order(s, t_cache, tokens.device)
            if cfg.attention == "swa" and s > t_cache else None)
    positions = _positions(tokens)
    x = model.embed_tokens(tokens, positions)
    for layer, lc in _layers_with_cache(model, cache):
        if isinstance(layer, SSMLayer):
            x = layer.prefill(x, lc)
            continue
        x, kv, _, _ = layer.full(x, positions, causal=True)
        if kv is None:  # a memory layer on an SSM host
            continue
        k, v = kv
        if keep is None:
            lc["k"][:, :s] = k
            lc["v"][:, :s] = v
        else:
            lc["k"].copy_(k[:, keep])
            lc["v"].copy_(v[:, keep])
    return model.logits(x), cache


def decode_step(model: Transformer, tokens: torch.Tensor, pos,
                cache) -> torch.Tensor:
    """One serving step: tokens (B, 1) at absolute positions `pos` (an int
    vector (B,), one per slot, or one int).  Updates `cache` in place and
    returns logits (B, 1, V)."""
    x = model.embed_tokens(tokens, pos[:, None] if torch.is_tensor(pos)
                           else pos)
    for layer, lc in _layers_with_cache(model, cache):
        x = layer.decode(x, pos, lc)
    return model.logits(x)
