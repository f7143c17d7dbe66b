"""Kernel L: SVGF back-projection fused with the à-trous level 1
(csrc/reproject_atrous.cu), with its plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/reproject_atrous.py:
back_projection_atrous1_pallas. It computes what kernel C's stencil mode
followed by kernel D at level 1 (not the last level, no albedo) compute,
so its caller gates it as it gates C (motion of at most one pixel) and
on the à-trous level 1 feeding the color history (denoise/svgf.py). The
plain version is exactly that composition. Like D, L reads the G-buffer's
position and normal for the filter from the frame's packed planes
(atrous.pack_static_planes), which the caller passes as `static`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.atrous import atrous_level_plain
from ptdn_tpu_torch.ops.cuda.reproject import (ReprojArgs,
                                               back_projection_stencil_plain,
                                               reproj_args)


# csrc/reproject_atrous.cu: a block of TILE_W x TILE_H threads filters a
# TILE_W x TILE_H tile of the image, a pixel a thread, and first stages
# the tile and a ring of HALO pixels (the level-1 taps' reach) in shared
# memory, SIDE pixels a row, row-major
TILE_W, TILE_H, HALO = 32, 16, 4
SIDE = TILE_W + 2 * HALO
STAGED = SIDE * (TILE_H + 2 * HALO)


def l_blocks(h: int, w: int):
    """Kernel L's grid: (blocks down, blocks across)."""
    return -(-h // TILE_H), -(-w // TILE_W)


def l_block_pixels(h: int, w: int, by: int, bx: int):
    """What block (by, bx) of kernel L does, as its code maps it
    (csrc/reproject_atrous.cu:back_projection_atrous1_kernel): the image
    pixel (y0, x0) of its staged slot 0, the (y, x) of every pixel its
    threads filter, and the slots it stages with their (y, x) (slot s
    holds pixel (y0 + s // SIDE, x0 + s % SIDE)), each within the image,
    as int64 arrays."""
    ty, tx = by * TILE_H, bx * TILE_W
    y0, x0 = ty - HALO, tx - HALO
    thr_y, thr_x = np.meshgrid(np.arange(TILE_H), np.arange(TILE_W),
                               indexing="ij")
    y, x = (ty + thr_y).reshape(-1), (tx + thr_x).reshape(-1)
    keep = (y < h) & (x < w)
    slot = np.arange(STAGED)
    sy, sx = y0 + slot // SIDE, x0 + slot % SIDE
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    return ((y0, x0), (y[keep], x[keep]),
            (slot[inside], sy[inside], sx[inside]))


class ReprojAtrousArgs(ctypes.Structure):
    """Mirror of csrc/reproject_atrous.cu:ReprojAtrousArgs."""
    _fields_ = ([("r", ReprojArgs)]
                + [(k, ctypes.c_void_p) for k in ("color_out", "var_out")]
                + [("blur_variance", ctypes.c_int)]
                + [(k, ctypes.c_float) for k in ("sigma_l", "sigma_n",
                                                 "sigma_x")]
                + [("stat", ctypes.c_void_p)])


def back_projection_atrous1_plain(res, current_color, curr_gb, prev_gb,
                                  prev_viewmat, color_history,
                                  moment_history, history_length,
                                  color_alpha_min, moment_alpha_min,
                                  sigma_l, sigma_n, sigma_x,
                                  blur_variance: bool, static):
    """Plain PyTorch version of kernel L: kernel C's plain version, then
    kernel D's at level 1 without albedo."""
    var, acc, mom, hist = back_projection_stencil_plain(
        res, current_color, curr_gb, prev_gb, prev_viewmat, color_history,
        moment_history, history_length, color_alpha_min, moment_alpha_min)
    color1, var1 = atrous_level_plain(acc, var, static, None, 1, sigma_l,
                                      sigma_n, sigma_x, blur_variance)
    return color1, var1, mom, hist


def back_projection_atrous1(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min, sigma_l, sigma_n, sigma_x,
                            blur_variance: bool, static):
    """Back-projection for |reprojected base - pixel| <= 1 (the caller
    gates on it) and the à-trous level 1 of its result. Tensors as
    back_projection_stencil's; `static` the frame's packed G-buffer
    (atrous.pack_static_planes of curr_gb's position and normal).
    Returns (color_l1 (H, W, 3), var_l1 (H, W), moment_acc (H, W, 2),
    history_update (H, W) int32): color_l1 is both the level-2 input and
    the new color history. CPU tensors take the plain version; CUDA
    tensors launch kernel L."""
    _lib.require(current_color.device, "back_projection_atrous1")
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min, sigma_l, sigma_n, sigma_x, blur_variance,
            static)
    if current_color.device.type == "cpu":
        return back_projection_atrous1_plain(*args)
    return _back_projection_atrous1_kernel(*args)


def _back_projection_atrous1_kernel(res, current_color, curr_gb, prev_gb,
                                    prev_viewmat, color_history,
                                    moment_history, history_length,
                                    color_alpha_min, moment_alpha_min,
                                    sigma_l, sigma_n, sigma_x,
                                    blur_variance, static):
    w, h = res
    _lib.check_tensor(static, torch.float32, (h, w, 8),
                      "back_projection_atrous1 static")
    r, (_, _, mom, hist) = reproj_args(
        res, current_color, curr_gb, prev_gb, prev_viewmat, color_history,
        moment_history, history_length, color_alpha_min, moment_alpha_min,
        name="back_projection_atrous1", outs=False)
    color1 = torch.empty((h, w, 3), dtype=torch.float32,
                         device=current_color.device)
    var1 = torch.empty((h, w), dtype=torch.float32,
                       device=current_color.device)
    args = ReprojAtrousArgs(r, color1.data_ptr(), var1.data_ptr(),
                            int(blur_variance), float(sigma_l),
                            float(sigma_n), float(sigma_x),
                            static.data_ptr())
    _lib.launch("ptdn_back_projection_atrous1", args)
    back_projection_atrous1.launches += 1
    return color1, var1, mom, hist


back_projection_atrous1.launches = 0
