"""Kernel C: SVGF back-projection for motion of at most one pixel
(csrc/reproject.cu), with its plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/reproject.py:
back_projection_stencil_pallas. Its caller gates it on
denoise.reproject.motion_bounds; inside that domain every 3x3 tap lies
within two pixels of the pixel itself, so each tap is read at the pixel
plus the clipped base offset plus the tap offset, from previous-frame
planes padded with zeros and geom id -1 (a tap outside the image can
never validate). The math after the taps is _accumulate_from_taps.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ptdn_tpu_torch.denoise.reproject import (_accumulate_from_taps,
                                              _reproj_base, luminance,
                                              prev_pack, tap_valid)
from ptdn_tpu_torch.ops.cuda import _lib


class ReprojArgs(ctypes.Structure):
    """Mirror of csrc/reproject.cu:ReprojArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "color", "pos", "nrm", "geom", "ch", "mh", "hl", "pn", "pg",
        "view")]
        + [(k, ctypes.c_float) for k in ("color_alpha", "moment_alpha")]
        + [(k, ctypes.c_int) for k in ("w", "h")]
        + [(k, ctypes.c_void_p) for k in ("var", "acc", "mom", "hist")])


def back_projection_stencil_plain(res, current_color, curr_gb, prev_gb,
                                  prev_viewmat, color_history,
                                  moment_history, history_length,
                                  color_alpha_min, moment_alpha_min):
    """Plain PyTorch version of kernel C (see back_projection_stencil)."""
    w, h = res
    fx, fy, fracx, fracy, base_valid = _reproj_base(
        res, curr_gb["position"], prev_viewmat)
    dev = fx.device
    iy = torch.arange(h, device=dev)[:, None]
    ix = torch.arange(w, device=dev)[None, :]
    by = iy + (fy - iy).clamp(-1, 1) + 2      # row in the padded planes
    bx = ix + (fx - ix).clamp(-1, 1) + 2
    pack = prev_pack(color_history, moment_history, history_length,
                     prev_gb["normal"], prev_gb["geom_id"])
    padded = F.pad(pack.permute(2, 0, 1), (2, 2, 2, 2)).permute(1, 2, 0)
    padded[:2, :, 9] = -1.0
    padded[-2:, :, 9] = -1.0
    padded[:, :2, 9] = -1.0
    padded[:, -2:, 9] = -1.0
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx, qy = fx + dx, fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            vals = padded[by + dy, bx + dx]
            taps[(dy, dx)] = (vals[..., 0:6],
                              tap_valid(vals, inb, curr_gb["geom_id"],
                                        curr_gb["normal"]))
    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_gb["geom_id"],
                                 history_length, luminance(current_color),
                                 color_alpha_min, moment_alpha_min)


def back_projection_stencil(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min):
    """Back-projection for |reprojected base - pixel| <= 1 (the caller
    gates on it). Tensors are (H, W, C) float32, geom ids and history
    length (H, W) int32, prev_viewmat (4, 4). Returns (variance (H, W),
    color_acc (H, W, 3), moment_acc (H, W, 2), history_update (H, W)
    int32). CPU tensors take the plain version; CUDA tensors launch
    kernel C."""
    _lib.require(current_color.device, "back_projection_stencil")
    if current_color.device.type == "cpu":
        return back_projection_stencil_plain(
            res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length,
            color_alpha_min, moment_alpha_min)
    return _back_projection_stencil_kernel(
        res, current_color, curr_gb, prev_gb, prev_viewmat, color_history,
        moment_history, history_length, color_alpha_min, moment_alpha_min)


def _back_projection_stencil_kernel(res, current_color, curr_gb, prev_gb,
                                    prev_viewmat, color_history,
                                    moment_history, history_length,
                                    color_alpha_min, moment_alpha_min):
    w, h = res
    f32, i32 = torch.float32, torch.int32
    ins = [(current_color, f32, (h, w, 3)), (curr_gb["position"], f32, (h, w, 3)),
           (curr_gb["normal"], f32, (h, w, 3)), (curr_gb["geom_id"], i32, (h, w)),
           (color_history, f32, (h, w, 3)), (moment_history, f32, (h, w, 2)),
           (history_length, i32, (h, w)), (prev_gb["normal"], f32, (h, w, 3)),
           (prev_gb["geom_id"], i32, (h, w)), (prev_viewmat, f32, (4, 4))]
    for k, (t, dt, shape) in enumerate(ins):
        _lib.check_tensor(t, dt, shape, f"back_projection_stencil arg {k}")
    dev = current_color.device
    var = torch.empty((h, w), dtype=f32, device=dev)
    acc = torch.empty((h, w, 3), dtype=f32, device=dev)
    mom = torch.empty((h, w, 2), dtype=f32, device=dev)
    hist = torch.empty((h, w), dtype=i32, device=dev)
    p = _lib.ptr
    args = ReprojArgs(*[p(t) for t, _, _ in ins], float(color_alpha_min),
                      float(moment_alpha_min), w, h, p(var), p(acc), p(mom),
                      p(hist))
    _lib.launch("ptdn_back_projection_stencil", args)
    back_projection_stencil.launches += 1
    return var, acc, mom, hist


back_projection_stencil.launches = 0
