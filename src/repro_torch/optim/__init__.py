"""Optimizers (torch counterpart of `repro.optim`).

Public surface: `OptimConfig` / `adam_init` / `adam_update` (Adam with the
paper's 10x memory-value LR group), `schedule_lr`, `global_norm`.  The
all-reduce gradient codecs (`repro.optim.compression`) are not ported yet
(ROADMAP A3).
"""

from repro_torch.optim.adam import (  # noqa: F401
    OptimConfig,
    adam_init,
    adam_update,
    global_norm,
    schedule_lr,
)
