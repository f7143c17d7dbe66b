"""SVGF in plain PyTorch: the back-projection (the stencil of a still
camera, the band rule of any other motion) and the à-trous levels.

A frozen copy of the port's plain versions (ptdn_tpu_torch/denoise/
reproject.py, denoise/atrous.py, ops/cuda/reproject.py and
ops/cuda/atrous.py), which the benchmark holds the program's frames to.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.fp import fma, sqrt


LUM = (0.2126, 0.7152, 0.0722)


def luminance(c: torch.Tensor) -> torch.Tensor:
    """0.2126 r + 0.7152 g + 0.0722 b, contracted as the reference."""
    return fma(LUM[2], c[..., 2], fma(LUM[0], c[..., 0], LUM[1] * c[..., 1]))


def _norm3(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return sqrt(fma(z, z, fma(x, x, y * y)))


def _reproj_base(res, pos, prev_viewmat, full_h=None):
    """Reproject world position through the previous view matrix to
    prev-frame pixel coords (denoise.cu:195-217, incl. the reference's
    omitted tan(fov/2) quirk). Returns (fx, fy, fracx, fracy,
    base_valid), fx/fy as int64. A shard's rows (pos holds some rows of
    the image) project onto the `full_h`-row image."""
    w, h = res
    h = h if full_h is None else full_h
    v = prev_viewmat
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    vs = [fma(v[r, 2], pz, fma(v[r, 0], px, v[r, 1] * py)) + v[r, 3]
          for r in range(3)]
    prevx = fma(-(vs[0] / vs[2]) * 0.5 + 0.5, float(w), -0.5)
    prevy = fma(-(vs[1] / vs[2]) * 0.5 + 0.5, float(h), -0.5)
    floorx = torch.floor(prevx)
    floory = torch.floor(prevy)
    fracx = prevx - floorx
    fracy = prevy - floory
    big = float(1 << 30)     # keep NaN/inf (miss pixels) finite as ints
    fx = torch.nan_to_num(floorx, nan=0.0).clamp(-big, big).to(torch.int64)
    fy = torch.nan_to_num(floory, nan=0.0).clamp(-big, big).to(torch.int64)
    base_valid = (floorx >= 0) & (floory >= 0) & (floorx < w) & (floory < h)
    return fx, fy, fracx, fracy, base_valid


def _accumulate_from_taps(taps, base_valid, fracx, fracy, current_color,
                          curr_geom, history_length, lum, color_alpha_min,
                          moment_alpha_min):
    """Shared tail: 2x2 bilinear + 3x3 fallback + EWMA + rejection
    (denoise.cu:219-315) given per-tap (values (H, W, 6): color, moments,
    history; valid) for the 3x3 window keyed by (dy, dx)."""
    n_hist = history_length.to(torch.float32)
    quad = [((0, 0), (1 - fracx) * (1 - fracy)),
            ((1, 0), fracx * (1 - fracy)),       # offset (dx=1, dy=0)
            ((0, 1), (1 - fracx) * fracy),       # offset (dx=0, dy=1)
            ((1, 1), fracx * fracy)]
    all_valid = base_valid
    for (dx, dy), _ in quad:
        all_valid = all_valid & taps[(dy, dx)][1]
    zero = torch.zeros_like(n_hist)
    pc = torch.zeros_like(current_color)
    pm = torch.zeros(curr_geom.shape + (2,), device=zero.device)
    ph, sumw = zero, zero
    for (dx, dy), wgt in quad:
        a, v = taps[(dy, dx)]
        mw = torch.where(all_valid & v, wgt, 0.0)
        pc = fma(mw[..., None], a[..., 0:3], pc)
        pm = fma(mw[..., None], a[..., 3:5], pm)
        ph = fma(mw, a[..., 5], ph)
        sumw = sumw + mw
    bilinear_ok = all_valid & (sumw >= 0.01)
    safe = torch.clamp_min(sumw, 1e-20)
    pc_b, pm_b, ph_b = pc / safe[..., None], pm / safe[..., None], ph / safe

    fc = torch.zeros_like(current_color)
    fm = torch.zeros_like(pm)
    fh, cnt = zero, zero
    for (dy, dx), (a, v) in taps.items():
        mv = torch.where(v, 1.0, 0.0)
        fc = fc + mv[..., None] * a[..., 0:3]
        fm = fm + mv[..., None] * a[..., 3:5]
        fh = fh + mv * a[..., 5]
        cnt = cnt + mv
    return _accumulate(bilinear_ok, (pc_b, pm_b, ph_b), (fc, fm, fh, cnt),
                       current_color, curr_geom, history_length, lum,
                       color_alpha_min, moment_alpha_min)


def _accumulate(bilinear_ok, bilinear, fallback, current_color, curr_geom,
                history_length, lum, color_alpha_min, moment_alpha_min):
    """The tail of every back-projection: the bilinear taps' (color,
    moments, history) where bilinear_ok, else the 3x3 fallback's mean
    (sums of color, moments, history and the count of valid taps), then
    EWMA and rejection (denoise.cu:262-315)."""
    pc_b, pm_b, ph_b = bilinear
    fc, fm, fh, cnt = fallback
    n_hist = history_length.to(torch.float32)
    fallback_ok = ~bilinear_ok & (cnt > 0)
    safe_cnt = torch.clamp_min(cnt, 1e-20)
    pc = torch.where(bilinear_ok[..., None], pc_b, fc / safe_cnt[..., None])
    pm = torch.where(bilinear_ok[..., None], pm_b, fm / safe_cnt[..., None])
    ph = torch.where(bilinear_ok, ph_b, fh / safe_cnt)

    valid = ((bilinear_ok | fallback_ok) & (history_length > 0)
             & (curr_geom != -1))

    color_alpha = torch.clamp_min(1.0 / (n_hist + 1.0), color_alpha_min)
    moment_alpha = torch.clamp_min(1.0 / (n_hist + 1.0), moment_alpha_min)
    acc_color = fma(current_color, color_alpha[..., None],
                    pc * (1.0 - color_alpha)[..., None])
    m1 = fma(moment_alpha, pm[..., 0], (1.0 - moment_alpha) * lum)
    m2 = fma(moment_alpha, pm[..., 1], (1.0 - moment_alpha) * lum * lum)
    var = torch.clamp_min(fma(-m1, m1, m2), 0.0)

    color_acc = torch.where(valid[..., None], acc_color, current_color)
    moment_acc = torch.where(valid[..., None], torch.stack([m1, m2], dim=-1),
                             torch.stack([lum, lum * lum], dim=-1))
    variance = torch.where(valid, var, 100.0)
    history_update = torch.where(valid, ph.to(torch.int32) + 1, 1).to(
        torch.int32)
    return variance, color_acc, moment_acc, history_update


def prev_pack(color_history, moment_history, history_length, prev_normal,
              prev_geom):
    """Previous-frame planes (H, W, 10): color, moments, history length,
    normal, geom id — the layout every back-projection reads taps from."""
    return torch.cat([color_history, moment_history,
                      history_length.to(torch.float32)[..., None],
                      prev_normal, prev_geom.to(torch.float32)[..., None]],
                     dim=-1)


def tap_valid(vals, inb, curr_geom, curr_normal):
    """isReprjValid (denoise.cu:172-182) on gathered tap values."""
    pg = vals[..., 9]
    same = (pg != -1) & (pg == curr_geom.to(torch.float32))
    nd = _norm3(vals[..., 6:9] - curr_normal)
    return inb & same & (nd <= 0.1)


def gather_back_projection(res, current_color, curr_gb, prev_gb, base,
                           color_history, moment_history, history_length,
                           color_alpha_min, moment_alpha_min, in_slab=None,
                           rows=None):
    """The 3x3 taps of `base` (_reproj_base's output) gathered with
    clamped indices, then _accumulate_from_taps. `in_slab` (H, W) bool,
    where given, rejects the base and every tap of the pixels where it is
    False (the banded path's rule). `rows` (row0, full_h, prev_row0)
    places a shard: the previous frame's planes hold image rows from
    prev_row0 (Rows)."""
    w, h = res
    row0, full_h, prev_row0 = Rows.of(rows, h)
    fx, fy, fracx, fracy, base_valid = base
    pack = prev_pack(color_history, moment_history, history_length,
                     prev_gb["normal"], prev_gb["geom_id"])
    hp = pack.shape[0]
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx, qy = fx + dx, fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < full_h)
            if in_slab is not None:
                inb = inb & in_slab
            vals = pack[(qy - prev_row0).clamp(0, hp - 1),
                        qx.clamp(0, w - 1)]
            taps[(dy, dx)] = (vals[..., 0:6],
                              tap_valid(vals, inb, curr_gb["geom_id"],
                                        curr_gb["normal"]))
    if in_slab is not None:
        base_valid = base_valid & in_slab
    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_gb["geom_id"],
                                 Rows.own(history_length, rows, h),
                                 luminance(current_color),
                                 color_alpha_min, moment_alpha_min)


# rows per band of the banded reprojection, and the rows its slab reaches
# beyond the band's mean vertical shift (ptdn_tpu/denoise/reproject.py:577)
BAND_ROWS = 64


BAND_MARGIN = 16


class Rows:
    """A shard's place in the image for the back-projection (csrc/
    reproject.cu:ReprojShardArgs). Its shard form, which the wrappers of
    ops/cuda/reproject.py take: `rows` = (row0, full_h), the shard's
    pixels image rows row0 .. row0 + h - 1 of a full_h-row image, its
    previous-frame planes its own rows, and `halo` = (top, bottom), the
    k image rows above and below them packed (prev_pack). Its window form,
    which their plain versions run: (row0, full_h, prev_row0), the
    previous frame's planes holding image rows from prev_row0. None is
    the whole image in both."""

    @staticmethod
    def of(rows, h: int):
        """The window form of `rows` (None: the whole image's h rows)."""
        return (0, h, 0) if rows is None else tuple(int(r) for r in rows)

    @staticmethod
    def own(prev, rows, h: int):
        """The shard's own rows of a previous-frame window `prev`."""
        row0, _, prev_row0 = Rows.of(rows, h)
        return prev[row0 - prev_row0:row0 - prev_row0 + h]


def slab_rows(h: int, band_rows: int, margin: int) -> int:
    """Rows of a band's slab in the padded grid of h + 2 rows."""
    return min(band_rows + 2 * margin + 1, h + 2)


def band_sums(res, fy, geom_id, band_rows: int = BAND_ROWS, row0: int = 0,
              full_h=None):
    """Each band's sum of vertical displacements fy - y over the pixels
    with geometry, and their count, int64 (n_bands,) each, over the
    bands of the `full_h`-row image: a shard's rows (from image row
    row0) add into the bands they lie in, and the shards' sums add up to
    the image's exactly."""
    w, h = res
    full_h = h if full_h is None else full_h
    n_bands = -(-full_h // band_rows)
    dev = fy.device
    iy = torch.arange(h, device=dev)[:, None] + row0
    valid = geom_id >= 0
    dyv = torch.where(valid, fy - iy, 0)
    band = iy[:, 0] // band_rows
    total = torch.zeros(n_bands, dtype=torch.int64, device=dev).index_add_(
        0, band, dyv.sum(dim=1))
    cnt = torch.zeros(n_bands, dtype=torch.int64, device=dev).index_add_(
        0, band, valid.to(torch.int64).sum(dim=1))
    return total, cnt


def starts_from_sums(total, cnt, full_h: int, band_rows: int = BAND_ROWS,
                     margin: int = BAND_MARGIN) -> torch.Tensor:
    """band_starts from band_sums' sums and counts of the whole image."""
    n_bands = total.shape[0]
    s_b = torch.floor(total.to(torch.float32)
                      / cnt.clamp_min(1).to(torch.float32)
                      + 0.5).to(torch.int64)
    r0 = torch.arange(n_bands, device=total.device) * band_rows
    return (r0 + s_b - margin).clamp(0, full_h + 2 - slab_rows(
        full_h, band_rows, margin))


def in_slab(res, fy, starts, band_rows: int = BAND_ROWS,
            margin: int = BAND_MARGIN, row0: int = 0,
            full_h=None) -> torch.Tensor:
    """(H, W) bool: the pixel's clipped padded base row gi = clip(fy + 1,
    0, h + 1) lies in its band's slab [start, start + slab_h)
    (ptdn_tpu/denoise/reproject.py:486-491). A shard's pixels are image
    rows row0.. of a `full_h`-row image."""
    w, h = res
    full_h = h if full_h is None else full_h
    gi = (fy + 1).clamp(0, full_h + 1)
    band = (torch.arange(h, device=fy.device) + row0) // band_rows
    li = gi - starts.to(torch.int64)[band][:, None]
    return (li >= 0) & (li < slab_rows(full_h, band_rows, margin))


def motion_bounds(res, curr_gb, prev_viewmat, band_rows: int = BAND_ROWS,
                  margin: int = BAND_MARGIN) -> torch.Tensor:
    """int32 (1 + n_bands,): [0] is 1 where every reprojected base of a
    pixel with geometry lies within +-1 px of the pixel itself (the
    kernel-C domain), else 0; [1:] are the band starts of the banded
    reprojection (band_starts), from the same reprojection. One host read
    of it decides the branch, and the starts stay on the device."""
    w, h = res
    reach, total, cnt = motion_parts(res, curr_gb, prev_viewmat, band_rows)
    return bounds_from_parts(reach, total, cnt, h, band_rows, margin)


def motion_parts(res, curr_gb, prev_viewmat, band_rows: int = BAND_ROWS,
                 row0: int = 0, full_h=None):
    """What motion_bounds reduces over the image, for some of its rows
    (a shard's, from image row row0 of a `full_h`-row image): the
    largest |fy - y| or |fx - x| of a pixel with geometry (int64 0-dim)
    and band_sums' sums and counts. The image's are the maximum of the
    shards' reaches and the sums of their sums."""
    w, h = res
    fx, fy, _, _, _ = _reproj_base(res, curr_gb["position"], prev_viewmat,
                                   full_h)
    dev = fx.device
    iy = torch.arange(h, device=dev)[:, None] + row0
    ix = torch.arange(w, device=dev)[None, :]
    valid = curr_gb["geom_id"] >= 0
    dyv = torch.where(valid, (fy - iy).abs(), 0)
    dxv = torch.where(valid, (fx - ix).abs(), 0)
    reach = torch.maximum(dyv.max(), dxv.max())
    return (reach,) + band_sums(res, fy, curr_gb["geom_id"], band_rows,
                                row0, full_h)


def bounds_from_parts(reach, total, cnt, full_h: int,
                      band_rows: int = BAND_ROWS,
                      margin: int = BAND_MARGIN) -> torch.Tensor:
    """motion_bounds' int32 (1 + n_bands,) from motion_parts' parts of
    the whole image."""
    starts = starts_from_sums(total, cnt, full_h, band_rows, margin)
    return torch.cat([(reach <= 1).to(torch.int64)[None], starts]).to(
        torch.int32)


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


def pack_static_planes(position: torch.Tensor,
                       normal: torch.Tensor) -> torch.Tensor:
    """The frame's G-buffer position and normal (H, W, 3) packed into one
    (H, W, 8) float32 buffer, x y z 0 x y z 0, which every level reads
    (ptdn_tpu/ops/pallas/atrous.py:pack_static_planes packs the same
    planes once per frame for the TPU kernel). Position lies at
    [..., 0:3], normal at [..., 4:7]."""
    pad = position.new_zeros(1).expand(position.shape[:2] + (1,))
    return torch.cat((position, pad, normal, pad), dim=-1)


def _views(cv: torch.Tensor):
    return cv[..., :3], cv[..., 3]


def atrous_level_plain(color, variance, static, albedo, level: int,
                       sigma_l, sigma_n, sigma_x, blur_variance: bool,
                       pack_out: bool = False, row0: int = 0,
                       full_h=None, halo=None, static_halo: int = 0):
    """Plain PyTorch version of kernel D (see atrous_level), on the same
    tensors: position and normal are views of `static`. Shard mode
    extends the shard's rows by its halo rows (atrous_extended_plain)."""
    k = 0
    if halo is not None:
        top, bottom = halo
        k = top.shape[0]
        color = torch.cat((top[..., :3], color, bottom[..., :3]))
        variance = torch.cat((top[..., 3], variance, bottom[..., 3]))
    return atrous_extended_plain(color, variance, static, albedo, level,
                                 sigma_l, sigma_n, sigma_x, blur_variance,
                                 pack_out, row0, full_h, k, static_halo)


def atrous_extended_plain(color, variance, static, albedo, level: int,
                          sigma_l, sigma_n, sigma_x, blur_variance: bool,
                          pack_out: bool = False, row0: int = 0,
                          full_h=None, halo: int = 0, static_halo: int = 0):
    """Kernel D's level on a shard's input extended by `halo` rows above
    and below (h + 2 halo rows of color and variance), every tap masked
    by its global row; keeps the shard's own rows."""
    hx, w = variance.shape
    h = hx - 2 * halo
    full_h = h if full_h is None else full_h
    static = static[static_halo - halo:static_halo - halo + hx]
    position, normal = static[..., 0:3], static[..., 4:7]
    gy = torch.arange(hx, device=color.device) + (row0 - halo)
    row_ok = ((gy >= 0) & (gy < full_h))[:, None]
    in_image = row_ok.to(torch.float32).expand(hx, w)
    if halo:
        # rows past the image weigh nothing and are read as zeros
        color = torch.where(row_ok[..., None], color, 0.0)
        variance = torch.where(row_ok, variance, 0.0)
    step = 1 << level
    var_p = (gaussian3x3(variance, in_image) if blur_variance
             else torch.clamp_min(variance, 0.0))
    denom_l = 1.0 / fma(sqrt(var_p), sigma_l, 1e-6)
    one, eps = np.float32(1.0), np.float32(1e-6)     # float32 arithmetic
    inv_sn = float(one / (np.float32(sigma_n) + eps))
    inv_sx = float(one / (np.float32(sigma_x) + eps))
    lp = luminance(color)
    csum = torch.zeros(color.shape, device=color.device)
    vsum, wsum, w2sum = (torch.zeros(variance.shape, device=color.device)
                         for _ in range(3))
    k = 0
    for j in (-2, -1, 0, 1, 2):
        for i in (-2, -1, 0, 1, 2):
            hk = H5[k]
            k += 1
            dy, dx = j * step, i * step
            inb = shift(in_image, dy, dx)
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
    if halo:
        out, new_var = out[halo:halo + h], new_var[halo:halo + h]
    if albedo is not None:
        out = out * albedo
    if pack_out:
        return _views(torch.cat((out, new_var[..., None]), dim=-1))
    return out, new_var
