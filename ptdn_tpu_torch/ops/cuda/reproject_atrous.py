"""Kernel L: SVGF back-projection fused with the à-trous level 1
(csrc/reproject_atrous.cu), with its plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/reproject_atrous.py:
back_projection_atrous1_pallas. It computes what kernel C's stencil mode
followed by kernel D at level 1 (not the last level, no albedo) compute,
so its caller gates it as it gates C (motion of at most one pixel) and
on the à-trous level 1 feeding the color history (denoise/svgf.py). The
plain version is exactly that composition.
"""

from __future__ import annotations

import ctypes

import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.atrous import (atrous_level_plain,
                                            pack_static_planes)
from ptdn_tpu_torch.ops.cuda.reproject import (ReprojArgs,
                                               back_projection_stencil_plain,
                                               reproj_args)


class ReprojAtrousArgs(ctypes.Structure):
    """Mirror of csrc/reproject_atrous.cu:ReprojAtrousArgs."""
    _fields_ = ([("r", ReprojArgs)]
                + [(k, ctypes.c_void_p) for k in ("color_out", "var_out")]
                + [("blur_variance", ctypes.c_int)]
                + [(k, ctypes.c_float) for k in ("sigma_l", "sigma_n",
                                                 "sigma_x")])


def back_projection_atrous1_plain(res, current_color, curr_gb, prev_gb,
                                  prev_viewmat, color_history,
                                  moment_history, history_length,
                                  color_alpha_min, moment_alpha_min,
                                  sigma_l, sigma_n, sigma_x,
                                  blur_variance: bool):
    """Plain PyTorch version of kernel L: kernel C's plain version, then
    kernel D's at level 1 without albedo."""
    var, acc, mom, hist = back_projection_stencil_plain(
        res, current_color, curr_gb, prev_gb, prev_viewmat, color_history,
        moment_history, history_length, color_alpha_min, moment_alpha_min)
    color1, var1 = atrous_level_plain(
        acc, var, pack_static_planes(curr_gb["position"], curr_gb["normal"]),
        None, 1, sigma_l, sigma_n, sigma_x, blur_variance)
    return color1, var1, mom, hist


def back_projection_atrous1(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min, sigma_l, sigma_n, sigma_x,
                            blur_variance: bool):
    """Back-projection for |reprojected base - pixel| <= 1 (the caller
    gates on it) and the à-trous level 1 of its result. Tensors as
    back_projection_stencil's. Returns (color_l1 (H, W, 3), var_l1
    (H, W), moment_acc (H, W, 2), history_update (H, W) int32): color_l1
    is both the level-2 input and the new color history. CPU tensors take
    the plain version; CUDA tensors launch kernel L."""
    _lib.require(current_color.device, "back_projection_atrous1")
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min, sigma_l, sigma_n, sigma_x, blur_variance)
    if current_color.device.type == "cpu":
        return back_projection_atrous1_plain(*args)
    return _back_projection_atrous1_kernel(*args)


def _back_projection_atrous1_kernel(res, current_color, curr_gb, prev_gb,
                                    prev_viewmat, color_history,
                                    moment_history, history_length,
                                    color_alpha_min, moment_alpha_min,
                                    sigma_l, sigma_n, sigma_x,
                                    blur_variance):
    w, h = res
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
                            float(sigma_n), float(sigma_x))
    _lib.launch("ptdn_back_projection_atrous1", args)
    back_projection_atrous1.launches += 1
    return color1, var1, mom, hist


back_projection_atrous1.launches = 0
