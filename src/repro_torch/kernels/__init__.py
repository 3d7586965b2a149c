"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel module holds the kernel's wrapper, its plain PyTorch version
(taken only for CPU tensors) and a launch counter on the wrapper.  The
CUDA sources live in `csrc/` and are built by `_build` at first use.
"""


def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches (`fn.launches`), by
    name.  The serve engine's CUDA graph adds a replay's launches to them
    (`serving.engine`)."""
    from repro_torch.kernels import (e8_lookup, gather_interp, ops,
                                     sharded_gather, tiered_gather)

    fns = (e8_lookup.lram_query, gather_interp.gather_interp,
           gather_interp.gather_interp_bf16, gather_interp.gather_interp_f16,
           gather_interp.gather_interp_quant, tiered_gather.tiered_gather,
           tiered_gather.tiered_gather_quant, ops.lookup_bwd,
           ops.lookup_bwd_bf16, ops.lookup_bwd_f16, ops.lookup_bwd_rows,
           ops.lookup_bwd_quant, ops.lookup_bwd_range,
           ops.lookup_bwd_range_bf16, ops.lookup_bwd_range_f16,
           sharded_gather.sharded_gather, sharded_gather.sharded_gather_bf16,
           sharded_gather.sharded_gather_f16,
           sharded_gather.sharded_gather_quant)
    return {fn.__name__: fn for fn in fns}
