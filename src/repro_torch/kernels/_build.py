"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (pointers, ints and the
stream as `void*`; the return value is `cudaGetLastError()`).  It is
compiled for `sm_90a` into `build/kernels/lib<name>-<hash>.so` at the root
of the checkout, keyed by the content hash of the source and of the shared
headers (`csrc/*.cuh`), the first time a kernel is called, and loaded with
`ctypes`.  Nothing is compiled when a
module is imported: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gather_interp", "e8_lookup", "gather_interp_quant",
           "tiered_gather", "lookup_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: nvcc's output (ptxas register and shared-memory report) per source
build_log: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (needed to build the CUDA kernels)")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """(target, temporary output, nvcc process) — no process if built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path | None,
            proc: subprocess.Popen | None) -> None:
    if proc is None:
        build_log.setdefault(name, "(cached build)")
        return
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not yet built, one nvcc per source, all
    started together.  Returns the build logs."""
    with _lock:
        started = {n: _start(n) for n in names}
        try:
            for n, started_n in started.items():
                _finish(n, *started_n)
        finally:  # a failed build leaves no other nvcc running
            for _, _, proc in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {n: build_log[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C function `symbol` of `csrc/<name>.cu`, with its argument types
    declared and an int (the CUDA error code) as its result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a forward kernel's
    output: the kernels return tensors with no `grad_fn`.  Callers that
    need one go through `ops.lram_lookup` or
    `gather_interp.gather_interp_vjp`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel's output carries no gradient; use "
            f"repro_torch.kernels.ops.lram_lookup or "
            f"gather_interp.gather_interp_vjp (or run under torch.no_grad)")
