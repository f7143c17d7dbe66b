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

Shard mode: a shard of a taller image (parallel/sharded.py) passes
`rows` = (row0, full_h) and `halo` = (top, bottom). Its pixels are
image rows row0.. of a full_h-row image, its previous-frame tensors are
its own rows as its state holds them, and top and bottom are the k image
rows above and below them as the exchange returns them, packed (k, W,
10) in denoise.reproject.prev_pack's layout (zeros past the image). k
must reach every row the taps may read (denoise.reproject.Rows.reach): 2
in stencil mode, in band mode the rows the shard's bands' slabs reach,
whose starts the shard form takes on the host. The kernel reads every
input where it lies (csrc/reproject.cu: stencil mode stages a tile in
shared memory, band mode picks each tap row's buffer). The plain
versions build the window (top, own rows, bottom) and run the window
form (`*_window_plain`, `rows` = (row0, full_h, prev_row0): the previous
frame's tensors hold image rows from prev_row0). Both take global rows
for the projection, the image edges, the band and the slab, so each
pixel equals the unsharded pass's bit for bit. The whole image's
stencil mode launches the shard kernel too, with rows (0, h) and no halo
rows; its band mode has a kernel of its own.

Kernel T (motion_bounds, motion_parts; csrc/motion.cu) gives the choice
between the two modes: the reach of the reprojected bases and the band
starts, from C's own reprojection code (reproject.cuh:prev_coords,
base_index), reduced over integers in one launch; the whole image's
bounds, or a shard's parts for its group's Reduce exchanges. Its plain
versions are denoise.reproject.motion_bounds_plain and
motion_parts_plain.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ptdn_tpu_torch.denoise.reproject import (BAND_MARGIN, BAND_ROWS, Rows,
                                              _accumulate_from_taps,
                                              _reproj_base,
                                              gather_back_projection,
                                              in_slab, luminance,
                                              motion_bounds_plain,
                                              motion_parts_plain, prev_pack,
                                              slab_rows, tap_valid)
from ptdn_tpu_torch.ops.cuda import _lib

# csrc/reproject.cu: a shard's launch takes a TILE_W x TILE_H tile of
# pixels a block; stencil mode stages it with the REACH rows and columns
# its taps reach on every side; band mode takes the slab starts of at
# most MAX_SHARD_BANDS bands by value (kMaxShardBands)
TILE_W, TILE_H, REACH = 32, 8, 2
MAX_SHARD_BANDS = 64
# floats a pixel of a packed halo row (prev_pack)
PACKED = 10


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


class ReprojShardArgs(ctypes.Structure):
    """Mirror of csrc/reproject.cu:ReprojShardArgs."""
    _fields_ = ([("a", ReprojArgs), ("top", ctypes.c_void_p),
                 ("bottom", ctypes.c_void_p)]
                + [(k, ctypes.c_int) for k in ("row0", "full_h", "halo",
                                               "band0", "bands")]
                + [("starts", ctypes.c_int * MAX_SHARD_BANDS)])


class MotionArgs(ctypes.Structure):
    """Mirror of csrc/motion.cu:MotionArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("pos", "geom", "view", "rows",
                                                "done", "parts", "bounds")]
                + [(k, ctypes.c_int) for k in ("w", "h", "row0", "full_h",
                                               "band_rows", "margin",
                                               "slab_h", "n_bands")])


def shard_window(args, rows, halo):
    """The window form of a shard-form call: `args` (res, ...,
    moment_alpha_min) with the previous frame's tensors replaced by the
    window of its halo rows above, its own rows and its halo rows below,
    and the window form's rows (row0, full_h, row0 - k). The whole
    image's call (rows and halo None) is its own window."""
    if halo is None:
        return args, rows
    (res, color, gb, prev_gb, view, ch, mh, hl, ca, ma) = args
    top, bottom = halo
    win = torch.cat([top, prev_pack(ch, mh, hl, prev_gb["normal"],
                                    prev_gb["geom_id"]), bottom])
    row0, full_h = rows
    return ((res, color, gb, {"normal": win[..., 6:9],
                              "geom_id": win[..., 9].to(torch.int32)},
             view, win[..., 0:3], win[..., 3:5], win[..., 5].to(torch.int32),
             ca, ma), (row0, full_h, row0 - top.shape[0]))


def back_projection_stencil_window_plain(res, current_color, curr_gb,
                                         prev_gb, prev_viewmat,
                                         color_history, moment_history,
                                         history_length, color_alpha_min,
                                         moment_alpha_min, rows=None):
    """Kernel C's stencil mode in PyTorch on a window of the previous
    frame: `rows` = (row0, full_h, prev_row0) (Rows), the previous
    frame's tensors holding image rows from prev_row0 and every row
    within two of the pixels' (zeros past the image), or None: the whole
    image."""
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


def back_projection_stencil_plain(res, current_color, curr_gb, prev_gb,
                                  prev_viewmat, color_history,
                                  moment_history, history_length,
                                  color_alpha_min, moment_alpha_min,
                                  rows=None, halo=None):
    """Plain PyTorch version of kernel C (see back_projection_stencil):
    a shard's window built from its rows and halo rows
    (shard_window)."""
    args, rows = shard_window((res, current_color, curr_gb, prev_gb,
                               prev_viewmat, color_history, moment_history,
                               history_length, color_alpha_min,
                               moment_alpha_min), rows, halo)
    return back_projection_stencil_window_plain(*args, rows=rows)


def back_projection_stencil(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min, rows=None, halo=None):
    """Back-projection for |reprojected base - pixel| <= 1 (the caller
    gates on it). Tensors are (H, W, C) float32, geom ids and history
    length (H, W) int32, prev_viewmat (4, 4). Returns (variance (H, W),
    color_acc (H, W, 3), moment_acc (H, W, 2), history_update (H, W)
    int32). `rows` and `halo` place a shard (the module's docstring; k
    >= 2 halo rows where the image has them). CPU tensors take the plain
    version; CUDA tensors launch kernel C."""
    _lib.require(current_color.device, "back_projection_stencil")
    Rows.check(rows, res[1], halo)
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    if current_color.device.type == "cpu":
        return back_projection_stencil_plain(*args, rows=rows, halo=halo)
    return _back_projection_stencil_kernel(*args, rows=rows, halo=halo)


def back_projection_banded_window_plain(res, current_color, curr_gb,
                                        prev_gb, prev_viewmat, color_history,
                                        moment_history, history_length,
                                        color_alpha_min, moment_alpha_min,
                                        starts, band_rows: int, margin: int,
                                        rows=None):
    """Kernel C's band mode in PyTorch on a window of the previous frame:
    `rows` = (row0, full_h, prev_row0) (Rows), the previous frame's
    tensors holding image rows from prev_row0 and every row the pixels'
    bands' slabs reach, or None: the whole image."""
    row0, full_h, _ = Rows.of(rows, res[1])
    starts = torch.as_tensor(starts, device=current_color.device)
    base = _reproj_base(res, curr_gb["position"], prev_viewmat, full_h)
    slab = in_slab(res, base[1], starts, band_rows, margin, row0, full_h)
    return gather_back_projection(res, current_color, curr_gb, prev_gb,
                                  base, color_history, moment_history,
                                  history_length, color_alpha_min,
                                  moment_alpha_min, in_slab=slab, rows=rows)


def back_projection_banded_plain(res, current_color, curr_gb, prev_gb,
                                 prev_viewmat, color_history, moment_history,
                                 history_length, color_alpha_min,
                                 moment_alpha_min, starts, band_rows: int,
                                 margin: int, rows=None, halo=None):
    """Plain PyTorch version of kernel C's band mode (see
    back_projection_banded): a shard's window built from its rows and
    halo rows (shard_window)."""
    args, rows = shard_window((res, current_color, curr_gb, prev_gb,
                               prev_viewmat, color_history, moment_history,
                               history_length, color_alpha_min,
                               moment_alpha_min), rows, halo)
    return back_projection_banded_window_plain(*args, starts, band_rows,
                                               margin, rows=rows)


def back_projection_banded(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min, starts, band_rows: int,
                           margin: int, rows=None, halo=None):
    """Back-projection for any motion under the band rule: `starts` is
    the (n_bands,) slab start of each band of `band_rows` rows of the
    image (denoise.reproject.band_starts), `margin` the rows a slab
    reaches beyond its band. Tensors, `rows`, `halo` and returns as
    back_projection_stencil. The whole image's starts are an int32
    tensor on the inputs' device; a shard's are on the host (a sequence
    or CPU tensor), where its halo's check reads them and its kernel
    takes its bands' by value; its halo must reach the rows its bands'
    slabs reach (Rows.reach). CPU tensors take the plain version; CUDA
    tensors launch kernel C's band mode."""
    _lib.require(current_color.device, "back_projection_banded")
    Rows.check(rows, res[1], halo, starts, band_rows, margin)
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    if current_color.device.type == "cpu":
        return back_projection_banded_plain(*args, starts, band_rows, margin,
                                            rows=rows, halo=halo)
    return _back_projection_banded_kernel(*args, starts, band_rows, margin,
                                          rows=rows, halo=halo)


def tap_rows(res, curr_gb, prev_viewmat, history_length, rows=None,
             band=None) -> torch.Tensor:
    """(full_h,) bool: the image rows of the previous frame that kernel
    C's taps read for these pixels (a shard's: `rows` = (row0, full_h);
    `band` = (starts, band_rows, margin) for band mode, else the
    stencil), as reproject.cuh:reproject_pixel reads them: a pixel with
    geometry and history (its own history length > 0) reads tap (dy, dx)
    of its base where the tap lies in the image, in band mode only where
    its base row lies in its band's slab. What a back-projection must
    read of the previous frame: these rows, and its own rows' history
    lengths."""
    w, h = res
    row0, full_h = (0, h) if rows is None else rows
    fx, fy, _, _, _ = _reproj_base(res, curr_gb["position"], prev_viewmat,
                                   full_h)
    dev = fx.device
    iy = torch.arange(h, device=dev)[:, None] + row0
    ix = torch.arange(w, device=dev)[None, :]
    live = (curr_gb["geom_id"] != -1) & (history_length > 0)
    if band is None:
        by = iy + (fy - iy).clamp(-1, 1)
        bx = ix + (fx - ix).clamp(-1, 1)
    else:
        starts, band_rows, margin = band
        starts = torch.as_tensor(starts, device=dev)
        live = live & in_slab(res, fy, starts, band_rows, margin, row0,
                              full_h)
        by, bx = fy, fx
    read = torch.zeros(full_h, dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m = (live & (fx + dx >= 0) & (fx + dx < w) & (fy + dy >= 0)
                 & (fy + dy < full_h) & (bx + dx >= 0) & (bx + dx < w)
                 & (by + dy >= 0) & (by + dy < full_h))
            read[(by + dy)[m]] = True
    return read


def reproj_args(res, current_color, curr_gb, prev_gb, prev_viewmat,
                color_history, moment_history, history_length,
                color_alpha_min, moment_alpha_min, name: str, outs=True,
                band=None, full_h=None):
    """Kernel C's argument struct over checked CUDA tensors, with new
    outputs (variance, color_acc, moment_acc, history_update), or with
    only the moments and history when `outs` is False (kernel L). The
    previous frame's tensors may hold other rows than the current
    frame's (a window). `band` = (starts, band_rows, margin) selects the
    band mode's fields: starts an int32 device tensor, or None (a
    shard's, which its arguments take by value); `full_h` is the
    image's rows where the launch's lie in a taller image. Returns
    (args, outputs)."""
    w, h = res
    full_h = h if full_h is None else full_h
    hp = history_length.shape[0]
    f32, i32 = torch.float32, torch.int32
    ins = [(current_color, f32, (h, w, 3)), (curr_gb["position"], f32, (h, w, 3)),
           (curr_gb["normal"], f32, (h, w, 3)), (curr_gb["geom_id"], i32, (h, w)),
           (color_history, f32, (hp, w, 3)), (moment_history, f32, (hp, w, 2)),
           (history_length, i32, (hp, w)), (prev_gb["normal"], f32, (hp, w, 3)),
           (prev_gb["geom_id"], i32, (hp, w)), (prev_viewmat, f32, (4, 4))]
    starts, band_rows, margin = band or (None, 1, 0)
    if starts is not None:
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
    return args, (var, acc, mom, hist)


def shard_args(args, rows, halo, band=None):
    """A shard's ReprojShardArgs over checked CUDA tensors (its previous
    frame's tensors its own h rows, its halo rows packed (k, W, 10)) and
    its new outputs. `band` = (starts on the host, band_rows, margin) for
    band mode."""
    (w, h), prev = args[0], args[7]
    row0, full_h = rows
    top, bottom = halo
    k = top.shape[0]
    if prev.shape[0] != h:
        raise ValueError(f"a shard's previous frame is its own {h} rows, "
                         f"got {prev.shape[0]}")
    for name, t in (("halo top", top), ("halo bottom", bottom)):
        _lib.check_tensor(t, torch.float32, (k, w, PACKED), name)
    starts = []
    b0, band_rows, margin = 0, 1, 0
    if band is not None:
        starts, band_rows, margin = band
        b0 = row0 // band_rows
        starts = [int(s) for s in starts][b0:(row0 + h - 1) // band_rows + 1]
        if len(starts) > MAX_SHARD_BANDS:
            raise ValueError(f"a shard's rows span {len(starts)} bands, "
                             f"more than {MAX_SHARD_BANDS}")
    a, out = reproj_args(*args, name="back_projection_shard",
                         band=None if band is None else (None, band_rows,
                                                         margin),
                         full_h=full_h)
    return ReprojShardArgs(a, _lib.ptr(top), _lib.ptr(bottom), row0, full_h,
                           k, b0, len(starts),
                           (ctypes.c_int * MAX_SHARD_BANDS)(*starts)), out


def _back_projection_stencil_kernel(*args, rows=None, halo=None):
    if halo is None:
        # the whole image: the shard kernel with rows (0, h), no halo rows
        none = args[1].new_empty((0, args[0][0], PACKED))
        c_args, out = shard_args(args, (0, args[0][1]), (none, none))
    else:
        c_args, out = shard_args(args, rows, halo)
        back_projection_stencil.row_launches += 1
    _lib.launch("ptdn_back_projection_shard", c_args, ctypes.c_int(0))
    back_projection_stencil.launches += 1
    return out


def _back_projection_banded_kernel(*args, rows=None, halo=None):
    if halo is None:
        c_args, out = reproj_args(*args[:10], name="back_projection_banded",
                                  band=args[10:])
        _lib.launch("ptdn_back_projection_banded", c_args)
    else:
        c_args, out = shard_args(args[:10], rows, halo, band=args[10:])
        _lib.launch("ptdn_back_projection_shard", c_args, ctypes.c_int(1))
        back_projection_banded.row_launches += 1
    back_projection_banded.launches += 1
    return out


back_projection_stencil.launches = 0
back_projection_banded.launches = 0
# of them, a shard's (shard mode)
back_projection_stencil.row_launches = 0
back_projection_banded.row_launches = 0


def motion_bounds(res, curr_gb, prev_viewmat, band_rows: int = BAND_ROWS,
                  margin: int = BAND_MARGIN) -> torch.Tensor:
    """denoise.reproject.motion_bounds: the near flag and the band
    starts, int32 (1 + n_bands,), of the whole image's G-buffer
    (`position` (H, W, 3), `geom_id` (H, W)) against the previous view
    matrix. CPU tensors take the plain version; CUDA tensors launch
    kernel T (csrc/motion.cu), which finishes the bounds in its last
    block."""
    pos = curr_gb["position"]
    _lib.require(pos.device, "motion_bounds")
    if pos.device.type == "cpu":
        return motion_bounds_plain(res, curr_gb, prev_viewmat, band_rows,
                                   margin)
    return _motion_kernel(res, curr_gb, prev_viewmat, band_rows, margin)


def motion_parts(res, curr_gb, prev_viewmat, band_rows: int = BAND_ROWS,
                 row0: int = 0, full_h=None):
    """denoise.reproject.motion_parts: a shard's (reach, sums, counts),
    int64 (), (n_bands,) and (n_bands,), for the group's Reduce
    exchanges. CPU tensors take the plain version; CUDA tensors launch
    kernel T, which writes the parts in its last block."""
    pos = curr_gb["position"]
    _lib.require(pos.device, "motion_parts")
    if pos.device.type == "cpu":
        return motion_parts_plain(res, curr_gb, prev_viewmat, band_rows,
                                  row0, full_h)
    return _motion_kernel(res, curr_gb, prev_viewmat, band_rows,
                          rows=(row0, res[1] if full_h is None else full_h))


def _motion_kernel(res, curr_gb, prev_viewmat, band_rows, margin=0,
                   rows=None):
    """Kernel T over the launch's rows: the whole image's bounds, or
    with `rows` = (row0, full_h) a shard's parts."""
    w, h = res
    row0, full_h = (0, h) if rows is None else rows
    pos, geom = curr_gb["position"], curr_gb["geom_id"]
    _lib.check_tensor(pos, torch.float32, (h, w, 3), "position")
    _lib.check_tensor(geom, torch.int32, (h, w), "geom_id")
    _lib.check_tensor(prev_viewmat, torch.float32, (4, 4), "prev_viewmat")
    n_bands = -(-full_h // band_rows)
    dev = pos.device
    # the rows' partials and, last, the blocks' ticket
    scratch = torch.empty(3 * h + 1, dtype=torch.int64, device=dev)
    parts = bounds = None
    if rows is None:
        bounds = torch.empty(1 + n_bands, dtype=torch.int32, device=dev)
    else:
        parts = torch.empty(1 + 2 * n_bands, dtype=torch.int64, device=dev)
    p = _lib.ptr
    args = MotionArgs(p(pos), p(geom), p(prev_viewmat), p(scratch),
                      p(scratch) + 8 * 3 * h, p(parts), p(bounds), w, h,
                      int(row0), int(full_h), int(band_rows), int(margin),
                      slab_rows(full_h, band_rows, margin), n_bands)
    _lib.launch("ptdn_motion_bounds", args)
    motion_bounds.launches += 1
    if rows is None:
        return bounds
    motion_bounds.row_launches += 1
    return parts[0], parts[1:1 + n_bands], parts[1 + n_bands:]


motion_bounds.launches = 0
# of them, a shard's parts (motion_parts)
motion_bounds.row_launches = 0
