"""Stateless, host-sharded synthetic data pipeline (the port's own copy of
`repro.data.synthetic`, numpy only, so the port imports nothing of the JAX
package; the CPU tests hold the two byte for byte).

The paper trains on 60 GB of web text, which is not available offline
(DESIGN.md §7).  This pipeline generates a deterministic synthetic corpus
whose statistics exercise the same mechanism the paper tests:

  * `zipf`  — Zipf-distributed token stream (natural-language-like marginals),
  * `facts` — the memory-recall task: a fixed table of (key-trigram ->
    value-trigram) "facts" is planted into the stream.  Recalling a fact
    requires associative memory: this is where LRAM/PKM capacity shows up in
    the loss, reproducing the *shape* of the paper's Table 2 at CPU scale.
  * MLM masking (BERT recipe: 15% positions; 80/10/10 mask/random/keep) or
    CLM next-token labels.

Stateless: batch `i` for host shard `(s, n)` is a pure function of
(seed, i, s) — resuming == restoring a step counter, and elastic rescaling
re-partitions the stream with no data-state in the checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IGNORE = -100
_FACT_LEN = 3


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "facts"         # zipf | facts
    objective: str = "mlm"      # mlm | clm
    num_facts: int = 4096
    fact_density: float = 0.5   # fraction of sequences carrying facts
    mask_prob: float = 0.15
    zipf_a: float = 1.2
    seed: int = 1234

    @property
    def mask_token(self) -> int:
        return self.vocab_size - 1


def make_fact_table(cfg: DataConfig) -> np.ndarray:
    """(num_facts, 2, 3): key trigram -> value trigram, fixed by seed."""
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(
        0, cfg.vocab_size - 1, size=(cfg.num_facts, 2, _FACT_LEN)
    ).astype(np.int32)


def _zipf_tokens(rng, cfg: DataConfig, shape):
    # bounded zipf via inverse-cdf over the vocab
    ranks = np.arange(1, cfg.vocab_size)
    weights = 1.0 / ranks**cfg.zipf_a
    cdf = np.cumsum(weights) / weights.sum()
    u = rng.random(shape)
    return np.searchsorted(cdf, u).astype(np.int32)


def _plant_facts(rng, tokens, cfg: DataConfig, table):
    b, s = tokens.shape
    carry = rng.random(b) < cfg.fact_density
    fact_ids = rng.integers(0, cfg.num_facts, size=b)
    starts = rng.integers(0, s - 2 * _FACT_LEN, size=b)
    for i in range(b):
        if carry[i]:
            k, v = table[fact_ids[i]]
            st = starts[i]
            tokens[i, st : st + _FACT_LEN] = k
            tokens[i, st + _FACT_LEN : st + 2 * _FACT_LEN] = v
    return tokens


def _mlm_mask(rng, tokens, cfg: DataConfig):
    b, s = tokens.shape
    labels = np.full_like(tokens, IGNORE)
    mask = rng.random((b, s)) < cfg.mask_prob
    labels[mask] = tokens[mask]
    action = rng.random((b, s))
    tokens = tokens.copy()
    tokens[mask & (action < 0.8)] = cfg.mask_token
    rand_sel = mask & (action >= 0.8) & (action < 0.9)
    tokens[rand_sel] = rng.integers(
        0, cfg.vocab_size - 1, size=int(rand_sel.sum())
    )
    return tokens, labels


def get_batch(cfg: DataConfig, step: int, *, shard: tuple[int, int] = (0, 1),
              table: np.ndarray | None = None):
    """Batch shard `shard=(index, count)` for global step `step`.

    Returns numpy {"tokens": (b_local, S), "labels": (b_local, S)}."""
    sh_i, sh_n = shard
    assert cfg.global_batch % sh_n == 0
    b_local = cfg.global_batch // sh_n
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, sh_i])
    )
    tokens = _zipf_tokens(rng, cfg, (b_local, cfg.seq_len))
    if cfg.kind == "facts":
        table = table if table is not None else make_fact_table(cfg)
        tokens = _plant_facts(rng, tokens, cfg, table)
    if cfg.objective == "mlm":
        tokens, labels = _mlm_mask(rng, tokens, cfg)
    else:
        labels = np.concatenate(
            [tokens[:, 1:], np.full((b_local, 1), IGNORE, tokens.dtype)],
            axis=1,
        )
    return {"tokens": tokens, "labels": labels}


def fact_eval_batch(cfg: DataConfig, n: int = 256,
                    table: np.ndarray | None = None):
    """Probe batch: every sequence carries a fact and ONLY the value trigram
    is masked — measures pure associative recall (memory-utilisation story).
    """
    table = table if table is not None else make_fact_table(cfg)
    rng = np.random.default_rng(cfg.seed + 999)
    tokens = _zipf_tokens(rng, cfg, (n, cfg.seq_len))
    labels = np.full_like(tokens, IGNORE)
    fact_ids = rng.integers(0, cfg.num_facts, size=n)
    starts = rng.integers(0, cfg.seq_len - 2 * _FACT_LEN, size=n)
    for i in range(n):
        k, v = table[fact_ids[i]]
        st = starts[i]
        tokens[i, st : st + _FACT_LEN] = k
        labels[i, st + _FACT_LEN : st + 2 * _FACT_LEN] = v
        tokens[i, st + _FACT_LEN : st + 2 * _FACT_LEN] = cfg.mask_token
    return {"tokens": tokens, "labels": labels}
