"""Torus-parameterising activation (paper §2.3), torch counterpart of
`repro.core.torus`.

The query point is read off the arguments of n complex numbers; the
lookup output is scaled by (sum_i 1/|z_i|)^{-1}, which keeps the layer
Lipschitz and positively 1-homogeneous.
"""

from __future__ import annotations

import functools
import math

import torch

_TWO_PI = 2.0 * math.pi
_SAFE_EPS = 1e-20


def torus_map(x: torch.Tensor, K) -> tuple[torch.Tensor, torch.Tensor]:
    """Map real inputs (..., 2n) to torus coords (..., n) in [0, K) and the
    scale (..., 1).  The first n features are real parts, the last n
    imaginary parts.  Where |z_i| ~ 0 the angle is undefined; the double
    `where` keeps gradients finite and the scale sends the output to zero.
    """
    n = x.shape[-1] // 2
    re, im = x[..., :n], x[..., n:]
    # denormal arguments are flushed before atan2 (the reference does the
    # same for XLA CPU); exact at float32 angle resolution
    re = torch.where(re.abs() < 1e-30, 0.0, re)
    im = torch.where(im.abs() < 1e-30, 0.0, im)
    mag_sq = re * re + im * im
    safe = mag_sq > _SAFE_EPS
    re_s = torch.where(safe, re, 1.0)
    im_s = torch.where(safe, im, 0.0)
    theta = torch.atan2(im_s, re_s)  # (-pi, pi]
    q = torch.remainder(theta / _TWO_PI, 1.0) \
        * _wrap_lengths(tuple(K), x.dtype, x.device)  # [0, K)
    mag = torch.sqrt(torch.where(safe, mag_sq, 1.0))
    inv = torch.where(safe, 1.0 / mag, 1.0 / math.sqrt(_SAFE_EPS))
    scale = 1.0 / inv.sum(-1, keepdim=True)
    return q, scale


@functools.lru_cache(maxsize=None)
def _wrap_lengths(K: tuple, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """K as a tensor on `device`, made once: a host-to-device copy has no
    place in a captured CUDA graph (`serving.engine`)."""
    with torch.inference_mode(False):  # cached: usable under autograd too
        return torch.tensor(K, dtype=dtype, device=device)
