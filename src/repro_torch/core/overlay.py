"""Per-tenant overlay hook of the LRAM lookup (torch counterpart of
`repro.core.overlay`).

The serve engine gives every decode slot a fixed-shape overlay pack, the
tenant's copy-on-write rows resolved against the shared base table
(`repro_torch.serving.overlay.OverlayManager`):

  * ``ids``    (L, B, C) int32: overlay row ids per memory layer and slot,
    ``-1`` empty (a lookup index is never negative, so it never matches);
  * ``deltas`` (L, B, C, m) fp32: ``dequant(overlay row) - base row`` per
    packed id, what the lookup misses when it reads the base row instead
    of the tenant's.

`lram_apply` consults :func:`current` between its gather and its scale:
inside an `activate` block it adds ``Σ_k w_k · delta[idx_k]`` (the
overlay read before the base, composed linearly) and, with ``collect``,
records the post-scale per-head output for the engine's write-back.  An
all-empty pack adds exactly 0.0, so an engine with overlays on and no
tenant attached gives the overlay-free engine's logits bit for bit.
Outside a block nothing extra runs.

The engine activates a context around each forward; the layer counter
restarts there, and layers take their pack slices in the order the
forward calls them (`transformer.layer_plan` order).  Under the engine's
CUDA graph the context runs once, at capture, over device buffers the
engine refreshes by `copy_` before every replay; the recorded tensors are
the graph's outputs, read back after it.
"""

from __future__ import annotations

import contextlib

import torch

_ACTIVE: "OverlayContext | None" = None


def current() -> "OverlayContext | None":
    """The active overlay context (None outside an `activate` block)."""
    return _ACTIVE


def delta_correction(idx: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """``Σ_k w_k · delta[idx_k]`` with the delta rows taken from a
    fixed-shape pack by an exact integer match of each lookup index
    against the pack's ids (no match: an all-zero row), in fp32.

    idx / w: (B, *lead, H, K); ids: (B, C); deltas: (B, C, m).
    Returns (B, *lead, H, m)."""
    bcast = (ids.shape[0],) + (1,) * (idx.dim() - 1) + (ids.shape[-1],)
    hit = idx.unsqueeze(-1) == ids.reshape(bcast)        # (B, ..., K, C)
    rows = torch.einsum("b...c,bcm->b...m", hit.to(deltas.dtype),
                        deltas)                          # (B, ..., K, m)
    return torch.einsum("...k,...km->...m", w.to(rows.dtype), rows)


class OverlayContext:
    """One forward's overlay state: the packs and the layer counter."""

    def __init__(self, ids: torch.Tensor, deltas: torch.Tensor, *,
                 collect: bool = False):
        if ids.dim() != 3 or deltas.dim() != 4 \
                or tuple(ids.shape) != tuple(deltas.shape[:3]):
            raise ValueError(
                f"overlay packs must be ids (L, B, C) and deltas "
                f"(L, B, C, m); got {tuple(ids.shape)} / "
                f"{tuple(deltas.shape)}")
        self.ids = ids
        self.deltas = deltas
        self.collect = collect
        self._layer = 0
        self._accesses: list[tuple] = []

    @property
    def num_layers(self) -> int:
        return int(self.ids.shape[0])

    def apply(self, idx, w, out):
        """One memory layer's gathered output (before the scale) with the
        next pack slice's correction added."""
        layer = self._layer
        if layer >= self.num_layers:
            raise RuntimeError(
                f"overlay packs cover {self.num_layers} memory layer(s) but "
                f"the model made lookup #{layer + 1}: the engine's layer "
                f"count is stale")
        self._layer += 1
        return out + delta_correction(idx, w, self.ids[layer],
                                      self.deltas[layer])

    def record(self, idx, w, y) -> None:
        """Keep one layer's (indices, weights, post-scale per-head
        output) for the decode tick's write-back."""
        if self.collect:
            self._accesses.append((idx, w, y))

    def stacked(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The recorded accesses with a leading layer axis: (idx (L, ...),
        w (L, ...), y (L, ...))."""
        if len(self._accesses) != self.num_layers:
            raise RuntimeError(
                f"collected {len(self._accesses)} memory accesses for "
                f"{self.num_layers} overlay layer(s)")
        return tuple(torch.stack([a[i] for a in self._accesses])
                     for i in range(3))


@contextlib.contextmanager
def activate(ids: torch.Tensor, deltas: torch.Tensor, *,
             collect: bool = False):
    """Activate an overlay context for one forward (contexts do not
    nest)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("overlay contexts do not nest")
    ctx = OverlayContext(ids, deltas, collect=collect)
    _ACTIVE = ctx
    try:
        yield ctx
    finally:
        _ACTIVE = None
