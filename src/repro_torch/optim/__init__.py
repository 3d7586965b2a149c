"""Optimizers (torch counterpart of `repro.optim`).

Public surface: `OptimConfig` / `adam_init` / `adam_update` (Adam with the
paper's 10x memory-value LR group), `schedule_lr`, `global_norm`, and the
gradient codecs with error feedback, `compression_init` /
`compress_gradients` (int8, top-k).
"""

from repro_torch.optim.adam import (  # noqa: F401
    OptimConfig,
    adam_init,
    adam_update,
    global_norm,
    schedule_lr,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_gradients,
    compression_init,
)
