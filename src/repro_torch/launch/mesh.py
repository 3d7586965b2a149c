"""Mesh construction over `torch.distributed` ranks (torch counterpart of
`repro.launch.mesh`).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... --use-mesh
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... \
        --use-mesh --mesh-shape 2x1x2          # pod 2 x data 1 x model 2

`init_mesh` joins the process group of a launch (RANK, WORLD_SIZE and
LOCAL_RANK from the environment, as torchrun sets them), places the rank
on its card and makes the host mesh ambient (`make_host_mesh`: data x
model, or pod x data x model); `make_production_mesh` is the
reference's 16 x 16 (x 2 pods) layout.  The backend is stated, not
probed: NCCL when every rank of the host has a card of its own, gloo
otherwise (more ranks than cards, or the CPU).  Gloo reduces CUDA tensors
through host memory: the kernels still run on the card, only the sums
across ranks go through the host.
"""

from __future__ import annotations

import json
import math
import os

import torch
import torch.distributed as dist

from repro_torch.distributed import context
from repro_torch.launch import resolve_device


def world_size() -> int:
    """The launch's number of ranks (1 outside torchrun)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_host_mesh(shape=None, axes=("data", "model")) -> context.Mesh:
    """A mesh over every rank of the process group: `shape` over `axes`
    (("data", "model"), or ("pod", "data", "model") for a multi-pod
    mesh), or without a shape the reference's rule, model = 4 if it
    divides the world and leaves at least 2 data ranks, else 2 on the
    same terms, else 1; the rest is data."""
    n = dist.get_world_size()
    if shape is None:
        model = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand * 2:
                model = cand
                break
        shape = (n // model, model)
    return context.Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> context.Mesh:
    """The reference's production mesh: 16 x 16 = 256 ranks (data x
    model) a pod; 2 pods (pod x data x model) = 512.  Raises, naming the
    world size it needs, in a launch of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if dist.get_world_size() != need:
        raise ValueError(f"the production mesh {shape} {axes} needs a "
                         f"world of {need} ranks; this launch has "
                         f"{dist.get_world_size()}")
    return context.Mesh(shape, axes)


def parse_shape(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """A mesh shape "DxM" (data x model) or "PxDxM" (pod x data x model)
    and its axes."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"a mesh shape is DxM or PxDxM, got {text!r}")
    axes = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    return shape, axes


def init_mesh(device="cuda", *, init_method: str = "env://", shape=None):
    """Join the launch's process group and make the host mesh ambient
    (`shape`: "DxM" or "PxDxM", `parse_shape`; default the reference's
    rule); returns (mesh, this rank's device).  Rank r runs on
    cuda:{LOCAL_RANK % device_count} for a CUDA `device`.  Called again in
    a process whose mesh is set, it returns that mesh."""
    device = resolve_device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda",
                              int(os.environ.get("LOCAL_RANK", "0")) % cards)
        torch.cuda.set_device(device)
    mesh = context.get_mesh()
    if dist.is_initialized() and mesh is not None:
        return mesh, device
    world, rank = world_size(), int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        backend, why = "nccl", "every rank has a card of its own"
    elif device.type == "cuda":
        backend, why = "gloo", (f"{local} ranks share "
                                f"{torch.cuda.device_count()} card(s): "
                                f"sums across ranks go through host memory")
    else:
        backend, why = "gloo", "CPU tensors"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    mesh = make_host_mesh(*parse_shape(shape)) if shape else make_host_mesh()
    context.set_mesh(mesh)
    if rank == 0:
        print(json.dumps({"backend": backend, "why": why, "mesh": mesh.shape,
                          "world_size": world}), flush=True)
    return mesh, device
