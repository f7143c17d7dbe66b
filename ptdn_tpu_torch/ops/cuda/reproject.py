"""Kernel C: SVGF back-projection (csrc/reproject.cu) in its two modes,
each with its plain PyTorch version.

Stencil mode replaces the TPU kernel ptdn_tpu/ops/pallas/reproject.py:
back_projection_stencil_pallas. Its caller gates it on
denoise.reproject.motion_bounds; inside that domain every 3x3 tap lies
within two pixels of the pixel itself, so each tap is read at the pixel
plus the clipped base offset plus the tap offset, from previous-frame
planes padded with zeros and geom id -1 (a tap outside the image can
never validate). Band mode is the far branch for any motion: the taps
are read at the true base, and the band rule of the JAX package's
back_projection_banded rejects a pixel whose base row leaves its band's
slab. The math after the taps is _accumulate_from_taps in both.

Row offset: a shard of a taller image (parallel/sharded.py) passes
`rows` = (row0, full_h, prev_row0), denoise.reproject.Rows: its pixels
are image rows row0.. of a full_h-row image, and the previous frame's
planes it passes hold image rows from prev_row0, the stencil's reach (2
rows past the shard, zeros past the image) or the whole image for the
band mode. The projection, the image edges, the band and the slab take
global rows, so each pixel equals the unsharded pass's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ptdn_tpu_torch.denoise.reproject import (Rows, _accumulate_from_taps,
                                              _reproj_base,
                                              gather_back_projection,
                                              in_slab, luminance, prev_pack,
                                              slab_rows, tap_valid)
from ptdn_tpu_torch.ops.cuda import _lib


class ReprojArgs(ctypes.Structure):
    """Mirror of csrc/reproject.cu:ReprojArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "color", "pos", "nrm", "geom", "ch", "mh", "hl", "pn", "pg",
        "view")]
        + [(k, ctypes.c_float) for k in ("color_alpha", "moment_alpha")]
        + [(k, ctypes.c_int) for k in ("w", "h")]
        + [(k, ctypes.c_void_p) for k in ("var", "acc", "mom", "hist",
                                          "starts")]
        + [(k, ctypes.c_int) for k in ("band_rows", "slab_h")])


class ReprojRows(ctypes.Structure):
    """Mirror of csrc/reproject.cuh:ReprojRows."""
    _fields_ = [(k, ctypes.c_int) for k in ("row0", "full_h", "prev_row0")]


def back_projection_stencil_plain(res, current_color, curr_gb, prev_gb,
                                  prev_viewmat, color_history,
                                  moment_history, history_length,
                                  color_alpha_min, moment_alpha_min,
                                  rows=None):
    """Plain PyTorch version of kernel C (see back_projection_stencil)."""
    w, h = res
    row0, full_h, prev_row0 = Rows.of(rows, h)
    fx, fy, fracx, fracy, base_valid = _reproj_base(
        res, curr_gb["position"], prev_viewmat, full_h)
    dev = fx.device
    iy = torch.arange(h, device=dev)[:, None] + row0
    ix = torch.arange(w, device=dev)[None, :]
    # row and column in the padded planes
    by = iy + (fy - iy).clamp(-1, 1) + 2 - prev_row0
    bx = ix + (fx - ix).clamp(-1, 1) + 2
    pack = prev_pack(color_history, moment_history, history_length,
                     prev_gb["normal"], prev_gb["geom_id"])
    padded = F.pad(pack.permute(2, 0, 1), (2, 2, 2, 2)).permute(1, 2, 0)
    # geom -1 (a tap that never validates) on the pad and past the image
    gy = torch.arange(padded.shape[0], device=dev) + (prev_row0 - 2)
    padded[(gy < 0) | (gy >= full_h), :, 9] = -1.0
    padded[:, :2, 9] = -1.0
    padded[:, -2:, 9] = -1.0
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx, qy = fx + dx, fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < full_h)
            vals = padded[by + dy, bx + dx]
            taps[(dy, dx)] = (vals[..., 0:6],
                              tap_valid(vals, inb, curr_gb["geom_id"],
                                        curr_gb["normal"]))
    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_gb["geom_id"],
                                 Rows.own(history_length, rows, h),
                                 luminance(current_color),
                                 color_alpha_min, moment_alpha_min)


def back_projection_stencil(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min, rows=None):
    """Back-projection for |reprojected base - pixel| <= 1 (the caller
    gates on it). Tensors are (H, W, C) float32, geom ids and history
    length (H, W) int32, prev_viewmat (4, 4). Returns (variance (H, W),
    color_acc (H, W, 3), moment_acc (H, W, 2), history_update (H, W)
    int32). `rows` places a shard (the module's docstring): the previous
    frame's tensors then hold their window's rows. CPU tensors take the
    plain version; CUDA tensors launch kernel C."""
    _lib.require(current_color.device, "back_projection_stencil")
    Rows.check(rows, res[1], history_length.shape[0], banded=False)
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    if current_color.device.type == "cpu":
        return back_projection_stencil_plain(*args, rows=rows)
    return _back_projection_stencil_kernel(*args, rows=rows)


def back_projection_banded_plain(res, current_color, curr_gb, prev_gb,
                                 prev_viewmat, color_history, moment_history,
                                 history_length, color_alpha_min,
                                 moment_alpha_min, starts, band_rows: int,
                                 margin: int, rows=None):
    """Plain PyTorch version of kernel C's band mode (see
    back_projection_banded)."""
    row0, full_h, _ = Rows.of(rows, res[1])
    base = _reproj_base(res, curr_gb["position"], prev_viewmat, full_h)
    slab = in_slab(res, base[1], starts, band_rows, margin, row0, full_h)
    return gather_back_projection(res, current_color, curr_gb, prev_gb,
                                  base, color_history, moment_history,
                                  history_length, color_alpha_min,
                                  moment_alpha_min, in_slab=slab, rows=rows)


def back_projection_banded(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min, starts, band_rows: int,
                           margin: int, rows=None):
    """Back-projection for any motion under the band rule: `starts` is
    the int32 (n_bands,) slab start of each band of `band_rows` rows of
    the image (denoise.reproject.band_starts), `margin` the rows a slab
    reaches beyond its band. Tensors, `rows` and returns as
    back_projection_stencil; a shard's previous frame is the whole
    image. CPU tensors take the plain version; CUDA tensors launch
    kernel C's band mode."""
    _lib.require(current_color.device, "back_projection_banded")
    Rows.check(rows, res[1], history_length.shape[0], banded=True)
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    if current_color.device.type == "cpu":
        return back_projection_banded_plain(*args, starts, band_rows, margin,
                                            rows=rows)
    return _back_projection_banded_kernel(*args, starts, band_rows, margin,
                                          rows=rows)


def reproj_args(res, current_color, curr_gb, prev_gb, prev_viewmat,
                color_history, moment_history, history_length,
                color_alpha_min, moment_alpha_min, name: str, outs=True,
                band=None, rows=None):
    """Kernel C's argument struct over checked CUDA tensors, with new
    outputs (variance, color_acc, moment_acc, history_update), or with
    only the moments and history when `outs` is False (kernel L). `band`
    = (starts, band_rows, margin) selects the band mode's fields. With
    `rows` (Rows), returns ((args, ReprojRows), outputs)."""
    w, h = res
    row0, full_h, prev_row0 = Rows.of(rows, h)
    hp = history_length.shape[0]
    f32, i32 = torch.float32, torch.int32
    ins = [(current_color, f32, (h, w, 3)), (curr_gb["position"], f32, (h, w, 3)),
           (curr_gb["normal"], f32, (h, w, 3)), (curr_gb["geom_id"], i32, (h, w)),
           (color_history, f32, (hp, w, 3)), (moment_history, f32, (hp, w, 2)),
           (history_length, i32, (hp, w)), (prev_gb["normal"], f32, (hp, w, 3)),
           (prev_gb["geom_id"], i32, (hp, w)), (prev_viewmat, f32, (4, 4))]
    starts, band_rows, margin = band or (None, 1, 0)
    if band is not None:
        ins.append((starts, i32, (-(-full_h // band_rows),)))
    for k, (t, dt, shape) in enumerate(ins):
        _lib.check_tensor(t, dt, shape, f"{name} arg {k}")
    dev = current_color.device
    var = torch.empty((h, w), dtype=f32, device=dev) if outs else None
    acc = torch.empty((h, w, 3), dtype=f32, device=dev) if outs else None
    mom = torch.empty((h, w, 2), dtype=f32, device=dev)
    hist = torch.empty((h, w), dtype=i32, device=dev)
    p = _lib.ptr
    args = ReprojArgs(*[p(t) for t, _, _ in ins[:10]], float(color_alpha_min),
                      float(moment_alpha_min), w, h, p(var), p(acc), p(mom),
                      p(hist), p(starts), band_rows,
                      slab_rows(full_h, band_rows, margin))
    if rows is None:
        return args, (var, acc, mom, hist)
    return (args, ReprojRows(row0, full_h, prev_row0)), (var, acc, mom,
                                                         hist)


def _back_projection_stencil_kernel(*args, rows=None):
    c_args, out = reproj_args(*args, name="back_projection_stencil",
                              rows=Rows.of(rows, args[0][1]))
    _lib.launch("ptdn_back_projection_stencil", *c_args)
    back_projection_stencil.launches += 1
    if rows is not None:
        back_projection_stencil.row_launches += 1
    return out


def _back_projection_banded_kernel(*args, rows=None):
    c_args, out = reproj_args(*args[:10], name="back_projection_banded",
                              band=args[10:], rows=Rows.of(rows, args[0][1]))
    _lib.launch("ptdn_back_projection_banded", *c_args)
    back_projection_banded.launches += 1
    if rows is not None:
        back_projection_banded.row_launches += 1
    return out


back_projection_stencil.launches = 0
back_projection_banded.launches = 0
# of them, a shard's (with a row offset)
back_projection_stencil.row_launches = 0
back_projection_banded.row_launches = 0
