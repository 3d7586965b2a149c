"""PyTorch / CUDA port of the lattice-memory (LRAM) system.

A second package beside the JAX reference (`repro`): it keeps the
reference's module names so each counterpart is easy to find, imports
`torch` and numpy only, and never imports `jax` or `repro`.  Kernels that
the reference wrote in Pallas for the TPU are hand-written CUDA C++ here
(`repro_torch.kernels`), built with `nvcc` at first use.

Entry points run on `cuda` unless the caller asks for `device="cpu"`;
with no card and no such request they raise.  On CPU tensors every kernel
wrapper takes its plain PyTorch version, which is what the CPU tests
hold against the JAX package.
"""
