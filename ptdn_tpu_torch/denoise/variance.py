"""Spatial variance estimation for native mode (compat=False), plain
PyTorch: the JAX package's denoise/variance.py, line for line.

The reference's EstimateVariance kernel writes a constant 10.0
(denoise.cu:320-329); compat mode replicates that stub, native mode
replaces it with the SVGF paper's remedy (its section 4.2): the
luminance moments estimated over a 7x7 window with bilateral weights,
the à-trous normal and position edge-stopping factors, and
max(mu2 - mu1^2, 0) as the variance. With temporal accumulation on, a
pixel whose history is shorter than HIST_THRESHOLD frames takes that
estimate in place of its temporal one. The luminance weight is left out
on purpose: luminance statistics are what is estimated.

The edge weights are those of the à-trous oracle (denoise/atrous.py):
the same `shift`, `_norm3` and `luminance`, a true division by
sigma + 1e-6 and the min(1, exp(-x)) clamp. These functions are also the
plain version of kernel R (ops/cuda/spatial_variance.py), which computes
the same bits tap for tap.
"""

from __future__ import annotations

import numpy as np
import torch

from ptdn_tpu_torch.denoise.atrous import shift, shift_mask
from ptdn_tpu_torch.denoise.reproject import _norm3, luminance

HIST_THRESHOLD = 4     # SVGF paper section 4.2: spatial below 4 frames
RADIUS = 3             # the 7x7 window


def _sigma(sigma, device) -> torch.Tensor:
    """sigma + 1e-6 in float32 as a 0-dim tensor on `device`: a true
    division by it on every device (a CUDA division by a host scalar is
    a multiply by its reciprocal)."""
    return torch.tensor(np.float32(np.float32(sigma) + np.float32(1e-6)),
                        device=device)


def spatial_variance(color, gbuffer, sigma_n, sigma_x,
                     radius: int = RADIUS) -> torch.Tensor:
    """Bilateral spatial estimate of the per-pixel luminance variance of
    `color` (H, W, 3) over a (2 radius + 1)^2 window, weighted by the
    G-buffer's normal and position edge-stopping factors. Returns the
    (H, W) float32 variance (>= 0)."""
    lp = luminance(color)
    pp = gbuffer["position"]
    np_ = gbuffer["normal"]
    den_n = _sigma(sigma_n, color.device)
    den_x = _sigma(sigma_x, color.device)
    m1 = torch.zeros_like(lp)
    m2 = torch.zeros_like(lp)
    wsum = torch.zeros_like(lp)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            inb = shift_mask(lp.shape, dy, dx, lp.device)
            lq = shift(lp, dy, dx)
            wn = torch.clamp_max(torch.exp(
                -_norm3(np_ - shift(np_, dy, dx)) / den_n), 1.0)
            wx = torch.clamp_max(torch.exp(
                -_norm3(pp - shift(pp, dy, dx)) / den_x), 1.0)
            w = inb * wn * wx
            m1 = m1 + w * lq
            m2 = m2 + w * lq * lq
            wsum = wsum + w
    inv = 1.0 / torch.clamp_min(wsum, 1e-20)
    mu1 = m1 * inv
    mu2 = m2 * inv
    return torch.clamp_min(mu2 - mu1 * mu1, 0.0)


def variance_with_spatial_fallback(variance, history_length, color,
                                   gbuffer, sigma_n, sigma_x) -> torch.Tensor:
    """Native mode's variance after the back-projection: the pixels whose
    history is shorter than HIST_THRESHOLD frames take spatial_variance,
    the others keep `variance`, bit for bit. Like the JAX package (a
    lax.cond on any(need)) it skips the 49-tap filter when no pixel needs
    it; kernel R selects per pixel instead, which gives the same result
    without reading `need` back to the host."""
    need = history_length < HIST_THRESHOLD
    if not bool(need.any()):
        return variance
    return torch.where(need, spatial_variance(color, gbuffer, sigma_n,
                                              sigma_x), variance)
