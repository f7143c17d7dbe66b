"""Kernel R: native mode's spatial variance and its short-history
fallback (csrc/spatial_variance.cu), with its plain PyTorch version
(denoise/variance.py).

Replaces XLA code of the JAX package, outside any Pallas kernel:
ptdn_tpu/denoise/variance.py:spatial_variance and
variance_with_spatial_fallback (as C's band mode and Q replace XLA code).
One thread a pixel runs the 7x7 bilateral moment estimate where the
pixel's history is shorter than 4 frames (every pixel without a
history) and keeps the temporal variance elsewhere, in one pass, with
the select made per pixel on the card instead of the JAX package's
lax.cond on any pixel needing it: the same values, no host read.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ptdn_tpu_torch.denoise.variance import (spatial_variance,
                                             variance_with_spatial_fallback)
from ptdn_tpu_torch.ops.cuda import _lib


class SpatialVarianceArgs(ctypes.Structure):
    """Mirror of csrc/spatial_variance.cu:SpatialVarianceArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("color", "pos", "nrm",
                                                 "hist", "var", "out")]
                + [(k, ctypes.c_int) for k in ("w", "h")]
                + [(k, ctypes.c_float) for k in ("sigma_n", "sigma_x")])


def spatial_variance_plain(color, gbuffer, sigma_n, sigma_x,
                           history: Optional[torch.Tensor] = None,
                           variance: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel R (see spatial_variance_fallback)."""
    if history is None:
        return spatial_variance(color, gbuffer, sigma_n, sigma_x)
    return variance_with_spatial_fallback(variance, history, color, gbuffer,
                                          sigma_n, sigma_x)


def spatial_variance_fallback(color: torch.Tensor,
                              gbuffer: Dict[str, torch.Tensor], sigma_n,
                              sigma_x,
                              history: Optional[torch.Tensor] = None,
                              variance: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The variance of native mode's SVGF frame, (H, W) float32: with
    `history` (H, W) int32 and `variance` (H, W), the temporal variance
    where the history is at least 4 frames and the spatial estimate of
    `color` (H, W, 3) elsewhere; without them the spatial estimate on
    every pixel. The G-buffer's position and normal are (H, W, 3). CPU
    tensors take the plain version; CUDA tensors launch kernel R."""
    _lib.require(color.device, "spatial_variance_fallback")
    if color.device.type == "cpu":
        return spatial_variance_plain(color, gbuffer, sigma_n, sigma_x,
                                      history, variance)
    return _spatial_variance_kernel(color, gbuffer, sigma_n, sigma_x,
                                    history, variance)


def _spatial_variance_kernel(color, gbuffer, sigma_n, sigma_x, history=None,
                             variance=None):
    h, w = color.shape[0], color.shape[1]
    color = color.contiguous()
    pos = gbuffer["position"].contiguous()
    nrm = gbuffer["normal"].contiguous()
    for name, t in (("color", color), ("position", pos), ("normal", nrm)):
        _lib.check_tensor(t, torch.float32, (h, w, 3), name)
    if history is not None:
        _lib.check_tensor(history, torch.int32, (h, w), "history")
        _lib.check_tensor(variance, torch.float32, (h, w), "variance")
    out = torch.empty((h, w), dtype=torch.float32, device=color.device)
    p = _lib.ptr
    args = SpatialVarianceArgs(
        color=p(color), pos=p(pos), nrm=p(nrm), hist=p(history),
        var=p(variance), out=p(out), w=w, h=h, sigma_n=float(sigma_n),
        sigma_x=float(sigma_x))
    _lib.launch("ptdn_spatial_variance", args)
    spatial_variance_fallback.launches += 1
    return out


spatial_variance_fallback.launches = 0
