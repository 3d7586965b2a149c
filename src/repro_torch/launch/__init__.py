"""Command-line entry points of the port."""

from __future__ import annotations

import torch

from repro_torch import obs


def resolve_device(name="cuda") -> torch.device:
    """The requested device; a CUDA request with no card is an error, never
    a silent fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run the plain versions on the "
                           "CPU")
    return device


def arm_obs(args, *, arm: bool = True) -> None:
    """Both CLIs' `--metrics-dir` / `--profile-dir`: exit on a profile
    directory without a metrics directory (the profiled span is one of
    obs's spans; the reference ignores the flag then), else arm obs when
    `arm` and a metrics directory is given."""
    if args.profile_dir and not args.metrics_dir:
        raise SystemExit("--profile-dir needs --metrics-dir")
    if arm and args.metrics_dir:
        obs.configure(metrics_dir=args.metrics_dir,
                      profile_dir=args.profile_dir or None)
