"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel module holds the kernel's wrapper, its plain PyTorch version
(taken only for CPU tensors) and a launch counter on the wrapper.  The
CUDA sources live in `csrc/` and are built by `_build` at first use.
"""
