"""Static performance analysis of the port's step (no card needed; torch
counterpart of `repro.analysis`).

  * `repro_torch.analysis.collectives` — the collectives a step issues,
    recorded where the port issues them (`distributed.collectives`), with
    the reference's ring wire-cost factors (`CollectiveStats`);
  * `repro_torch.analysis.roofline` — the roofline over the dry-run's
    artifacts (`launch.dryrun`) at the H100's data-sheet peaks, and the
    reckoning of a train step's products and memory from its leaves
    (`train_flops`, `train_bytes`).
"""
