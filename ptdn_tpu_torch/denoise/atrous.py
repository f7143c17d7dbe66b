"""Edge-stopping à-trous wavelet filter (ATrousFilter rebuild).

Replicates the reference kernel (reference src/denoise.cu:77-170): a 5x5
B3-spline kernel dilated by step = 1 << level, luminance/normal/position
edge-stopping weights, variance propagated with squared weights, an
optional 3x3 Gaussian pre-blur of variance (border-renormalized), and
albedo remodulation on the final level. Every tap is a shift of the whole
image with zeros outside it. One deviation, as in the JAX package: the
reference updates its variance buffer IN PLACE while other threads still
read it (a data race, denoise.cu:153-161); this reads the level's input
variance and writes a fresh output.

`atrous_level` here is the oracle with the reference's three separate
clamped exps (the JAX package's denoise/atrous.py); the frame runs kernel
D (ops/cuda/atrous.py), whose single fused exp differs by ~1 ulp.
"""

from __future__ import annotations

import torch

from ptdn_tpu_torch.denoise.reproject import _norm3, luminance
from ptdn_tpu_torch.ops.fp import sqrt

# 5x5 B3-spline weights (denoise.cu:82-86)
H5 = [1/256, 1/64, 3/128, 1/64, 1/256,
      1/64, 1/16, 3/32, 1/16, 1/64,
      3/128, 3/32, 9/64, 3/32, 3/128,
      1/64, 1/16, 3/32, 1/16, 1/64,
      1/256, 1/64, 3/128, 1/64, 1/256]

# 3x3 Gaussian (denoise.cu:89-91)
G3 = [1/16, 1/8, 1/16,
      1/8, 1/4, 1/8,
      1/16, 1/8, 1/16]


def shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx]; zeros outside. img: (H, W, ...)."""
    h, w = img.shape[0], img.shape[1]
    if abs(dy) >= h or abs(dx) >= w:
        return torch.zeros_like(img)
    out = torch.zeros_like(img)
    ys, yd = (slice(dy, h), slice(0, h - dy)) if dy >= 0 else \
        (slice(0, h + dy), slice(-dy, h))
    xs, xd = (slice(dx, w), slice(0, w - dx)) if dx >= 0 else \
        (slice(0, w + dx), slice(-dx, w))
    out[yd, xd] = img[ys, xs]
    return out


def shift_mask(shape, dy: int, dx: int, device) -> torch.Tensor:
    return shift(torch.ones(shape[:2], device=device), dy, dx)


def gaussian3x3(variance: torch.Tensor, in_image=None) -> torch.Tensor:
    """Border-renormalized 3x3 blur of variance (denoise.cu:101-115).
    `in_image` (H, W) float32, 1 inside the image and 0 outside, marks
    the image's border where the rows extend past it (a shard's halo);
    by default the tensor is the image."""
    if in_image is None:
        in_image = torch.ones(variance.shape, device=variance.device)
    s = torch.zeros_like(variance)
    sw = torch.zeros_like(variance)
    k = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            g = G3[k]
            k += 1
            s = s + g * shift(variance, dy, dx)
            sw = sw + g * shift(in_image, dy, dx)
    return torch.clamp_min(s / sw, 0.0)


def atrous_level(color_in, variance_in, gbuffer, level: int, is_last: bool,
                 sigma_l, sigma_n, sigma_x, blur_variance: bool,
                 add_color: bool):
    """One à-trous level, oracle form. Returns (color_out, variance_out)."""
    step = 1 << level
    var_p = (gaussian3x3(variance_in) if blur_variance
             else torch.clamp_min(variance_in, 0.0))
    lp = luminance(color_in)
    pp = gbuffer["position"]
    np_ = gbuffer["normal"]
    denom_l = sqrt(var_p) * sigma_l + 1e-6
    color_sum = torch.zeros_like(color_in)
    var_sum = torch.zeros_like(variance_in)
    w_sum = torch.zeros_like(variance_in)
    w2_sum = torch.zeros_like(variance_in)
    k = 0
    for j in (-2, -1, 0, 1, 2):
        for i in (-2, -1, 0, 1, 2):
            hk = H5[k]
            k += 1
            dy, dx = j * step, i * step
            inb = shift_mask(color_in.shape, dy, dx, color_in.device)
            cq = shift(color_in, dy, dx)
            wl = torch.exp(-torch.abs(lp - luminance(cq)) / denom_l)
            wn = torch.clamp_max(torch.exp(
                -_norm3(np_ - shift(np_, dy, dx)) / (sigma_n + 1e-6)), 1.0)
            wx = torch.clamp_max(torch.exp(
                -_norm3(pp - shift(pp, dy, dx)) / (sigma_x + 1e-6)), 1.0)
            wgt = hk * wl * wn * wx * inb
            w_sum = w_sum + wgt
            w2_sum = w2_sum + wgt * wgt
            color_sum = color_sum + cq * wgt[..., None]
            var_sum = var_sum + shift(variance_in, dy, dx) * wgt * wgt
    ok = w_sum > 1e-5                    # 10e-6 (denoise.cu:159)
    color_out = torch.where(ok[..., None],
                            color_sum / torch.clamp_min(w_sum, 1e-20)[..., None],
                            color_in)
    variance_out = torch.where(ok, var_sum / torch.clamp_min(w2_sum, 1e-30),
                               variance_in)
    if is_last and add_color:
        color_out = color_out * gbuffer["albedo"] * gbuffer["ialbedo"]
    return color_out, variance_out
