"""Kernel D: one edge-stopping à-trous level (csrc/atrous.cu), with its
plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/atrous.py:
atrous_level_pallas, whose arithmetic both versions follow: the three
edge-stopping weights fold into one exp of the summed distances (the
reference's min(1, exp(-x)) clamps are no-ops for x >= 0), divisions by
the sigma terms become reciprocal multiplies, and taps outside the image
weigh zero.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ptdn_tpu_torch.denoise.atrous import H5, gaussian3x3, shift, shift_mask
from ptdn_tpu_torch.denoise.reproject import _norm3, luminance
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.fp import fma, sqrt


class AtrousArgs(ctypes.Structure):
    """Mirror of csrc/atrous.cu:AtrousArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "color", "var", "pos", "nrm", "albedo", "color_out", "var_out")]
        + [(k, ctypes.c_int) for k in ("w", "h", "level", "blur_variance")]
        + [(k, ctypes.c_float) for k in ("sigma_l", "sigma_n", "sigma_x")])


def atrous_level_plain(color, variance, position, normal, albedo, level: int,
                       sigma_l, sigma_n, sigma_x, blur_variance: bool):
    """Plain PyTorch version of kernel D (see atrous_level)."""
    step = 1 << level
    var_p = (gaussian3x3(variance) if blur_variance
             else torch.clamp_min(variance, 0.0))
    denom_l = 1.0 / fma(sqrt(var_p), sigma_l, 1e-6)
    one, eps = np.float32(1.0), np.float32(1e-6)     # float32 arithmetic
    inv_sn = float(one / (np.float32(sigma_n) + eps))
    inv_sx = float(one / (np.float32(sigma_x) + eps))
    lp = luminance(color)
    csum = torch.zeros_like(color)
    vsum, wsum, w2sum = (torch.zeros_like(variance) for _ in range(3))
    k = 0
    for j in (-2, -1, 0, 1, 2):
        for i in (-2, -1, 0, 1, 2):
            hk = H5[k]
            k += 1
            dy, dx = j * step, i * step
            inb = shift_mask(color.shape, dy, dx, color.device)
            cq = shift(color, dy, dx)
            if dy == 0 and dx == 0:
                wgt = hk * inb
            else:
                dist_x = _norm3(position - shift(position, dy, dx))
                dist_n = _norm3(normal - shift(normal, dy, dx))
                arg = fma(dist_x, inv_sx,
                          fma(torch.abs(lp - luminance(cq)), denom_l,
                              dist_n * inv_sn))
                wgt = hk * torch.exp(-arg) * inb
            wsum = wsum + wgt
            w2sum = fma(wgt, wgt, w2sum)
            csum = fma(cq, wgt[..., None], csum)
            vsum = fma(shift(variance, dy, dx) * wgt, wgt, vsum)
    ok = wsum > 1e-5                              # 10e-6 (denoise.cu:159)
    inv_w = 1.0 / torch.where(ok, wsum, 1.0)
    out = torch.where(ok[..., None], csum * inv_w[..., None], color)
    new_var = torch.where(ok, vsum / torch.where(w2sum > 0, w2sum, 1.0),
                          variance)
    if albedo is not None:
        out = out * albedo
    return out, new_var


def atrous_level(color, variance, position, normal, albedo, level: int,
                 sigma_l, sigma_n, sigma_x, blur_variance: bool):
    """One à-trous level: color (H, W, 3), variance (H, W), G-buffer
    position and normal (H, W, 3); `albedo` (H, W, 3) remodulates the
    output (the last level with add_color) or is None. Returns
    (color_out, variance_out) in new tensors. CPU tensors take the plain
    version; CUDA tensors launch kernel D."""
    _lib.require(color.device, "atrous_level")
    if color.device.type == "cpu":
        return atrous_level_plain(color, variance, position, normal, albedo,
                                  level, sigma_l, sigma_n, sigma_x,
                                  blur_variance)
    return _atrous_level_kernel(color, variance, position, normal, albedo,
                                level, sigma_l, sigma_n, sigma_x,
                                blur_variance)


def _atrous_level_kernel(color, variance, position, normal, albedo, level,
                         sigma_l, sigma_n, sigma_x, blur_variance):
    h, w = variance.shape
    for name, t, shape in (("color", color, (h, w, 3)),
                           ("variance", variance, (h, w)),
                           ("position", position, (h, w, 3)),
                           ("normal", normal, (h, w, 3))) + (
            (("albedo", albedo, (h, w, 3)),) if albedo is not None else ()):
        _lib.check_tensor(t, torch.float32, shape, name)
    out = torch.empty_like(color)
    out_v = torch.empty_like(variance)
    p = _lib.ptr
    args = AtrousArgs(p(color), p(variance), p(position), p(normal),
                      p(albedo), p(out), p(out_v), w, h, level,
                      int(blur_variance), float(sigma_l), float(sigma_n),
                      float(sigma_x))
    _lib.launch("ptdn_atrous_level", args)
    atrous_level.launches += 1
    return out, out_v


atrous_level.launches = 0
