"""Fault-tolerant checkpointing (torch counterpart of `repro.checkpoint`).

Public surface: `CheckpointManager` — atomic (tmp-dir + rename),
checksummed (per-leaf / per-shard crc32), async for trees without a
store, shard-streaming for tiered value stores (1-byte payload + scales
when the store is quantized), newest-valid-first restore, and
grow-on-restore for memory tables; size mismatches it cannot reconcile
raise `CheckpointError`.  Its files are the reference's, so checkpoints
cross between the two packages.
"""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
)
