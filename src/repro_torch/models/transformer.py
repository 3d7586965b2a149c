"""Transformer assembly for every family of the reference: dense, MoE,
SSM, hybrid, enc-dec and VLM (torch counterpart of
`repro.models.transformer`).

The stack follows the reference's segment plan: ("run", n) segments of n
plain layers, ("memory", i, "lram") layers whose FFN is the paper's
memory block, and for the hybrid family one ("hybrid", units) segment.
The reference scans each run over stacked parameters; here a run is a
`ModuleList` walked by a Python loop, and the converter
(`repro_torch.launch.convert`) splits the stacked arrays per layer.

A plain layer is attention + MLP (dense, and the VLM), attention + the
top-k MoE (`models.moe`, when `num_experts` > 0), norm + the Mamba-2
mixer (`models.mamba2`, family "ssm"), or for the enc-dec decoder
attention + cross attention over the encoder's output + MLP
(`CrossLayer`).  A memory layer is attention + the memory FFN, with no
cross attention in an enc-dec decoder (the reference's
`_memory_layer_*`); on an SSM host it has no attention: the memory FFN
sits on the residual stream (the reference's `_memory_layer_full`),
though the layer still owns the unused `attn_norm` / `attn` leaves the
reference's `_memory_layer_init` builds.  The MoE layers' router losses
are summed into `loss_fn`'s aux term, run by run.

The hybrid family (zamba2): `units` units of `hybrid_pattern` Mamba
layers, each unit followed by the one `shared_attn` block (attention +
MLP, built as the dense family), the same module and parameters at every
call, so its gradient sums over the calls.  The reference allows no
memory layer in a hybrid (`layer_plan` raises).  The enc-dec family
(whisper): a stack of `encoder_layers` non-causal layers (dense
attention) over `encoder_embeds` plus `enc_pos_embed`, then `enc_norm`;
each decoder run layer projects that output through its own `cross`
keys and values.  The VLM (qwen2-vl): `vision_embeds` replace the first
`vision_tokens` embeddings, and the rotation is M-RoPE on positions (3,
B, S) (`batch["positions"]`; default the sequence index on all three
streams).

Modes: full sequence (`forward`, in train mode too, and `prefill`, which
also fills the decode cache) and single-token decode (`decode_step`) with
one position per batch slot.  `loss_fn` is the masked cross-entropy of
both objectives (clm next token, mlm masked positions) plus
`router_aux_weight` times the aux loss.  The decode cache keeps the
reference's layout (a run's leaves stack a leading layer axis, a hybrid
segment's Mamba leaves two: unit and layer): K/V for attention, the
encoder's projected ck / cv for an enc-dec run, the float32 SSM state
and conv window for a Mamba layer, nothing for a memory layer on an SSM
host.  It is updated IN PLACE by decode and by `write_cache_slot`.  A
("memory", i, "pkm") layer's FFN is the product-key memory baseline
(`repro_torch.core.pkm`), applied to the normed residual with no dense
around it.  Weights, activations and the KV cache take `cfg.dtype`
(float32, bfloat16 or float16; a PKM's leaves too; an LRAM table takes
its `LRAMConfig.table_dtype`).  A sliding-window
model's cache holds `min(window, max_len)` positions per layer as a ring
(position p in slot p % window): a prefill longer than the window keeps
its last `window` positions, permuted into their ring slots.
"""

from __future__ import annotations

import contextlib
import dataclasses

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
    """[("run", count) | ("memory", layer_idx, kind)] covering all
    layers, or [("hybrid", units)] for the hybrid family."""
    special = {i: "lram" for i in cfg.lram_layers}
    special.update({i: "pkm" for i in cfg.pkm_layers})
    if cfg.family == "hybrid":
        if special:
            raise ValueError(
                f"{cfg.name}: memory layers inside hybrid units are not "
                f"supported (the reference's layer_plan rule)")
        if cfg.num_layers % cfg.hybrid_pattern:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"units of {cfg.hybrid_pattern}")
        return [("hybrid", cfg.num_layers // cfg.hybrid_pattern)]
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


class CrossLayer(Layer):
    """Attention + cross attention over the encoder's output (`cross`,
    its own keys and values of it) + MLP: an enc-dec decoder's run
    layer."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator=generator)
        self.cross_norm = _norm(cfg)
        self.cross = attention.Attention(cfg, generator=generator)

    def full(self, x, positions, *, causal: bool, train: bool = False,
             collect_access: bool = False, enc=None):
        """`_Block.full` with the encoder's output `enc` (B, T, d); the
        K/V it returns are (k, v, ck, cv), the last two the cross
        attention's projections of `enc`."""
        h, kv = attention.attn_apply(self.attn, self.attn_norm(x),
                                     positions=positions, causal=causal)
        x = x + h
        ckv = attention.project_kv(self.cross, enc)
        h, _ = attention.attn_apply(self.cross, self.cross_norm(x),
                                    positions=positions, causal=False,
                                    cross_kv=ckv)
        x = x + h
        return x + self.ffn(x, train), kv + ckv, None, None

    def decode(self, x, pos, cache):
        """Single-token step over the self-attention K/V (written in
        place) and the encoder's ck / cv (read whole)."""
        x = x + attention.attn_decode(self.attn, self.attn_norm(x), pos=pos,
                                      k_cache=cache["k"],
                                      v_cache=cache["v"])
        x = x + attention.cross_decode(self.cross, self.cross_norm(x),
                                       pos=pos, k_cache=cache["ck"],
                                       v_cache=cache["cv"])
        return x + self.ffn(x, False)


class MoELayer(_Block):
    """Attention + the top-k mixture of experts (`moe`)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, generator)
        self.moe = moe.MoE(cfg, generator=generator)

    def ffn(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return moe.moe_apply(self.moe, self.ffn_norm(x))[0]

    def ffn_full(self, x: torch.Tensor, train: bool, collect_access: bool):
        y, aux = moe.moe_apply(self.moe, self.ffn_norm(x), train=train)
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
                                        generator=generator,
                                        dtype=cfg.torch_dtype)

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
    if cfg.family == "encdec":
        return CrossLayer
    return MoELayer if cfg.num_experts > 0 else Layer


class Transformer(nn.Module):
    """Parameters are named as the reference's pytree, so `state_dict`
    keys are its paths with stacked layers split: a run's per layer
    (`segments.seg0.<i>`), a hybrid segment's per unit and layer
    (`segments.seg0.<u>.<j>`), the encoder's per layer (`encoder.<i>`)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: torch.Generator | None = None):
        super().__init__()
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
        self.enc_pos_embed = self.encoder = self.enc_norm = None
        if cfg.family == "encdec":
            self.enc_pos_embed = nn.Parameter(tnn.truncated_normal_(
                torch.empty(cfg.encoder_len, cfg.d_model, dtype=dtype), 0.02,
                generator))
            enc_cfg = dataclasses.replace(cfg, num_experts=0,
                                          attn_impl="dense")
            self.encoder = nn.ModuleList(
                Layer(enc_cfg, generator=generator)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = _norm(cfg)
        self.shared_attn = None
        segs = {}
        for si, seg in enumerate(layer_plan(cfg)):
            if seg[0] == "hybrid":
                ssm_cfg = dataclasses.replace(cfg, family="ssm")
                segs[f"seg{si}"] = nn.ModuleList(
                    nn.ModuleList(SSMLayer(ssm_cfg, generator=generator)
                                  for _ in range(cfg.hybrid_pattern))
                    for _ in range(seg[1]))
                self.shared_attn = Layer(
                    dataclasses.replace(cfg, family="dense"),
                    generator=generator)
            elif seg[0] == "run":
                segs[f"seg{si}"] = nn.ModuleList(
                    _layer_class(cfg)(cfg, generator=generator)
                    for _ in range(seg[1]))
            else:
                segs[f"seg{si}"] = MemoryLayer(cfg, seg[2],
                                                generator=generator)
        self.segments = nn.ModuleDict(segs)
        # on a mesh, this rank's blocks of the dense leaves and their
        # gather a unit at a time (`distributed.sharding.shard_params`);
        # None: whole
        self.placement = None

    def run_unit(self, modules, fn, *args, **kw):
        """fn(*args, **kw), the units of `modules` whole: on a mesh the
        placement gathers them for the call and releases them after it
        (and again around the call's backward); else a plain call."""
        if self.placement is None:
            return fn(*args, **kw)
        return self.placement.run(modules, fn, *args, **kw)

    def embed_tokens(self, tokens: torch.Tensor, positions,
                     vision: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings, the first `vision_tokens` of them replaced by
        `vision` (B, vision_tokens, d) where given, plus the learned
        position rows where configured: `positions` (an int tensor
        broadcastable to tokens, or one int) clamped to the table, as the
        reference's decode does.  On a mesh it runs the embedding unit,
        which raises outside `sharding.gathered` (the dense leaves are
        this rank's blocks)."""
        x = self.run_unit((self.embed,), self.embed, tokens)
        if vision is not None and self.cfg.vision_tokens:
            x = torch.cat([vision.to(x.dtype),
                           x[:, self.cfg.vision_tokens:]], dim=1)
        if self.pos_embed is None:
            return x
        pos = torch.as_tensor(positions, device=tokens.device).long()
        # one int as a 1-vector: a 0-d index would be read on the host
        pos = torch.clamp(pos.reshape(pos.shape or (1,)),
                          max=self.pos_embed.shape[0] - 1)
        return x + self.pos_embed[pos].to(x.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the head (a tied embedding's transpose): on
        a mesh the head's unit, or the shared embedding unit."""
        head = self.embed if self.lm_head is None else self.lm_head
        return self.run_unit((self.final_norm, head), self._head, x)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.lm_head is None:
            return x @ self.embed.embedding.to(x.dtype).T
        return self.lm_head(x)


def dense_units(model: Transformer) -> dict[str, bool]:
    """{module name: shared} of the units whose dense leaves a mesh
    gathers whole one at a time (`distributed.sharding.DenseBlocks`):
    the embedding (shared when tied: the head reads it), each encoder
    layer, each decoder layer in order (a hybrid unit's Mamba layers and
    the shared block, shared: called after every unit) and the head."""
    names = {m: n for n, m in model.named_modules()}
    units = {"embed": model.lm_head is None}
    for layer in model.encoder or ():
        units[names[layer]] = False
    for _, layer, _ in _walk(model):
        units.setdefault(names[layer], layer is model.shared_attn)
    if model.lm_head is not None:
        units["lm_head"] = False
    return units


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Transformer:
    """A model with weights drawn from `seed`, leaf by leaf.

    Without `device` (or on "cpu") the weights are drawn on the CPU, so
    the same seed gives the same weights whatever device the model is
    moved to.  With a CUDA `device` every leaf is drawn there, from a
    generator on that device: a full-width model never passes through
    host memory, and only its largest leaf is ever held in float32 at
    once.  A seed drawn on "cuda" gives other weights than the same seed
    on the CPU.  On "meta" (the dry-run's) the leaves have shapes and
    dtypes and no values: nothing is drawn."""
    device = torch.device("cpu" if device is None else device)
    generator = torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(seed)
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


def _embed_inputs(model: Transformer, batch: dict):
    """(x, positions) of a batch, as the reference's `_embed_inputs`:
    `vision_embeds` where the model takes them, and M-RoPE's positions
    (3, B, S) from `batch["positions"]` (default the sequence index on
    every stream)."""
    tokens = batch["tokens"]
    if model.cfg.pos_scheme == "mrope":
        positions = batch.get("positions")
        if positions is None:
            positions = _positions(tokens).expand(3, *tokens.shape)
    else:
        positions = _positions(tokens)
    x = model.embed_tokens(tokens, positions, batch.get("vision_embeds"))
    return x, positions


def _run_encoder(model: Transformer, batch: dict):
    """The enc-dec encoder over `batch["encoder_embeds"]` (B, T, d), cast
    to the model's dtype, plus the encoder's position rows, non-causal;
    None for the other families."""
    if model.encoder is None:
        return None
    embeds = batch.get("encoder_embeds")
    if embeds is None:
        raise ValueError(f"{model.cfg.name} is an enc-dec model: its "
                         f"batch needs encoder_embeds")
    x = embeds.to(model.cfg.torch_dtype)
    b, s = x.shape[:2]
    x = x + model.enc_pos_embed[:s][None].to(x.dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for layer in model.encoder:
        x = model.run_unit((layer,), layer.full, x, positions,
                           causal=False)[0]
    return model.enc_norm(x)


def _walk(model: Transformer, cache=None):
    """(segment name, layer, {leaf: its cache view}) for every decoder
    layer in order; a hybrid unit's Mamba layers, then the shared block.
    Views are {} without a cache."""
    for name, seg in model.segments.items():
        c = {} if cache is None else cache[name]
        if not isinstance(seg, nn.ModuleList):
            yield name, seg, c
            continue
        for i, layer in enumerate(seg):
            if not isinstance(layer, nn.ModuleList):
                yield name, layer, {k: v[i] for k, v in c.items()}
                continue
            for j, mamba_layer in enumerate(layer):  # a hybrid unit
                yield name, mamba_layer, {k: c[k][i, j] for k in c
                                          if k in ("ssm", "conv")}
            yield name, model.shared_attn, {k: c[k][i] for k in c
                                            if k in ("k", "v")}


def _full(model, layer, x, positions, enc, **kw):
    """`layer.full` as its unit, the encoder's output passed to a cross
    layer."""
    if isinstance(layer, CrossLayer):
        kw["enc"] = enc
    return model.run_unit((layer,), layer.full, x, positions, **kw)


def _forward(model: Transformer, batch: dict, *, train: bool,
             collect_access: bool):
    """(logits, {segment: (idx, w)} (empty without `collect_access`), the
    router losses summed: each run's layers', then over runs, as the
    reference's scan sums them; float32 zero without an MoE layer)."""
    tokens = batch["tokens"]
    causal = model.cfg.objective == "clm"
    x, positions = _embed_inputs(model, batch)
    enc = _run_encoder(model, batch)
    accesses = {}
    auxs = {name: [] for name in model.segments}
    for name, layer, _ in _walk(model):
        x, _, access, aux = _full(model, layer, x, positions, enc,
                                  causal=causal, train=train,
                                  collect_access=collect_access)
        if access is not None:
            accesses[name] = access
        if aux is not None:
            auxs[name].append(aux)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for run in auxs.values():
        if run:
            aux_total = aux_total + torch.stack(run).sum()
    return model.logits(x), accesses, aux_total


def forward(model: Transformer, batch: dict, *, train: bool = False,
            collect_access: bool = False):
    """Full-sequence forward: batch["tokens"] (B, S) -> logits (B, S, V);
    the batch also carries "encoder_embeds" (B, T, d) for an enc-dec
    model and, for a VLM, "vision_embeds" (B, vision_tokens, d) and
    "positions" (3, B, S), each optional there.  In train mode the
    memory layers' batchnorm stats update in place.  With
    `collect_access` returns (logits, {segment: (idx, w)}), one
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
    and the parts' gradients sum to the global loss's.  So is the router
    loss (`moe.router_loss`: its means taken over the global batch)."""
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
    model's dtype, an enc-dec run also the encoder's projections ck / cv
    (encoder_len rows); a Mamba run its state (n, B, h, N, P) and conv
    window (n, B, K-1, C), float32; a hybrid segment both, the Mamba
    leaves (units, pattern, ...) and the shared block's K/V (units, ...);
    a memory layer on an SSM host nothing."""
    dtype = cfg.torch_dtype
    kvd = (batch, _attn_cache_len(cfg, max_len), cfg.num_kv_heads,
           cfg.head_dim)
    ssm = mamba2.mamba_cache_shapes(cfg, batch) if cfg.ssm_state else {}
    shapes = {}
    for si, seg in enumerate(layer_plan(cfg)):
        name = f"seg{si}"
        if seg[0] == "hybrid":
            lead = (seg[1], cfg.hybrid_pattern)
            shapes[name] = {k: (lead + shape, torch.float32)
                            for k, shape in ssm.items()}
            shapes[name].update({k: ((seg[1],) + kvd, dtype)
                                 for k in ("k", "v")})
            continue
        lead = (seg[1],) if seg[0] == "run" else ()
        if cfg.family != "ssm":
            shapes[name] = {"k": (lead + kvd, dtype),
                            "v": (lead + kvd, dtype)}
            if cfg.family == "encdec" and seg[0] == "run":
                ckv = lead + (batch, cfg.encoder_len, cfg.num_kv_heads,
                              cfg.head_dim)
                shapes[name].update(ck=(ckv, dtype), cv=(ckv, dtype))
        elif seg[0] == "run":
            shapes[name] = {k: (lead + shape, torch.float32)
                            for k, shape in ssm.items()}
        else:
            shapes[name] = {}
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


def ring_fill_order(s: int, t_cache: int, device=None) -> torch.Tensor:
    """The prompt positions a ring of `t_cache` slots keeps after a
    prefill of `s` > `t_cache` positions, in slot order: the last
    `t_cache` positions hit each slot p % t_cache exactly once (the
    reference's `_fill_kv_cache` permutation)."""
    keep = torch.arange(s - t_cache, s, device=device)
    return keep[torch.argsort(keep % t_cache)]


def prefill(model: Transformer, tokens: torch.Tensor, max_len: int, *,
            encoder_embeds: torch.Tensor | None = None,
            vision_embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None):
    """Run the prompt (B, S), building the decode cache. Returns
    (logits (B, S, V), cache).  The reference's batch extras: an enc-dec
    model's `encoder_embeds` (B, encoder_len, d), whose projections fill
    ck / cv; a VLM's `vision_embeds` and M-RoPE `positions` (3, B, S).
    A full-attention cache holds position p at p (positions >= S left
    zero); a sliding window's ring holds the last min(S, window)
    positions, each in slot p % window; a Mamba layer its final state and
    conv window."""
    cfg = model.cfg
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len={max_len}")
    cache = init_cache(cfg, b, max_len, tokens.device)
    t_cache = _attn_cache_len(cfg, max_len)
    keep = (ring_fill_order(s, t_cache, tokens.device)
            if cfg.attention == "swa" and s > t_cache else None)
    batch = {"tokens": tokens, "encoder_embeds": encoder_embeds,
             "vision_embeds": vision_embeds, "positions": positions}
    x, positions = _embed_inputs(model, batch)
    enc = _run_encoder(model, batch)
    for _, layer, lc in _walk(model, cache):
        if isinstance(layer, SSMLayer):
            x = model.run_unit((layer,), layer.prefill, x, lc)
            continue
        x, kv, _, _ = _full(model, layer, x, positions, enc, causal=True)
        if kv is None:  # a memory layer on an SSM host
            continue
        k, v = kv[:2]
        if keep is None:
            lc["k"][:, :s] = k
            lc["v"][:, :s] = v
        else:
            lc["k"].copy_(k[:, keep])
            lc["v"].copy_(v[:, keep])
        if len(kv) == 4:  # a cross layer: the encoder's projections
            lc["ck"].copy_(kv[2])
            lc["cv"].copy_(kv[3])
    return model.logits(x), cache


def decode_step(model: Transformer, tokens: torch.Tensor, pos,
                cache) -> torch.Tensor:
    """One serving step: tokens (B, 1) at absolute positions `pos` (an int
    vector (B,), one per slot, or one int; a VLM's M-RoPE turns every
    stream by it).  Updates `cache` in place and returns logits (B, 1,
    V)."""
    x = model.embed_tokens(tokens, pos[:, None] if torch.is_tensor(pos)
                           else pos)
    for _, layer, lc in _walk(model, cache):
        x = model.run_unit((layer,), layer.decode, x, pos, lc)
    return model.logits(x)
