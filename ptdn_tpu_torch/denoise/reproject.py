"""SVGF temporal reprojection + accumulation (BackProjection rebuild).

Replicates the reference kernel (reference src/denoise.cu:185-317) over
(H, W, ...) tensors:

* world position -> previous-frame view space via the stored previous
  view matrix; NDC WITHOUT the tan(fov/2) term — the reference comments
  it out (denoise.cu:202-203) and we replicate;
* 2x2 bilinear tap with per-tap validity (in-bounds + same geomId +
  normal distance <= 0.1, denoise.cu:172-182), requiring ALL four taps
  valid, else a 3x3 uniform-average fallback (denoise.cu:262-286);
* EWMA with alpha = max(1/(N+1), alpha_min); the reference applies
  color_alpha to the CURRENT color but moment_alpha to the PREVIOUS
  moments (denoise.cu:297-301) — replicated;
* variance = max(0, m2 - m1^2); total rejection writes history=1,
  variance=100 (denoise.cu:311-315).

`back_projection_auto` dispatches as the JAX package's pallas backend
does: motion of at most one pixel (every static-camera frame) goes to
kernel C (ops/cuda/reproject.py); anything else, such as frame 0 whose
previous view is the identity or a moving camera, to the banded
reprojection (`back_projection_banded`, kernel C's band mode), which
rejects a tap whose row falls outside its band's slab. The choice and
the band starts come from `motion_bounds`, read on the host in one
device-to-host sync, unless the caller passes them (the SVGF module keeps
them while the camera is still). `back_projection`, the plain gather with
clamped indices and no band rule, stays as the oracle the tests hold the
other branches against.
"""

from __future__ import annotations

import torch

from ptdn_tpu_torch.ops.fp import fma, sqrt

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


def back_projection(res, current_color, curr_gb, prev_gb, prev_viewmat,
                    color_history, moment_history, history_length,
                    color_alpha_min, moment_alpha_min):
    """Back-projection for any motion, by gathers with clamped indices
    (the JAX package's XLA oracle, denoise/reproject.py:716). Returns
    (variance, color_acc, moment_acc, history_update)."""
    base = _reproj_base(res, curr_gb["position"], prev_viewmat)
    return gather_back_projection(res, current_color, curr_gb, prev_gb,
                                  base, color_history, moment_history,
                                  history_length, color_alpha_min,
                                  moment_alpha_min)


# The JAX package's 9-gather packed variant (ptdn_tpu/denoise/reproject.py:
# 205 back_projection_packed): the nine 3x3 taps as row gathers of one
# packed (H * W, 10) table, the 2x2 bilinear taps among them. The port's
# back_projection gathers exactly so (gather_back_projection).
back_projection_packed = back_projection


def back_projection_window(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min):
    """Back-projection by one gathered row per pixel (ptdn_tpu/denoise/
    reproject.py:120 back_projection_window): the previous frame padded
    by 2 pixels (zeros, geom id -1, so a tap outside the image never
    validates) and packed as a grid of complete 3x3 windows of 10
    channels, 90 floats a row, over window centres [-1, h] x [-1, w];
    each pixel gathers the row of its clipped base and reads every tap
    from it. The JAX function splits that gather into 8-wide column
    groups past a 110 MB table, for a TPU gather cliff; this gathers
    whole rows. Returns (variance, color_acc, moment_acc,
    history_update)."""
    w, h = res
    fx, fy, fracx, fracy, base_valid = _reproj_base(
        res, curr_gb["position"], prev_viewmat)
    pack = prev_pack(color_history, moment_history, history_length,
                     prev_gb["normal"], prev_gb["geom_id"])
    padded = torch.nn.functional.pad(pack.permute(2, 0, 1),
                                     (2, 2, 2, 2)).permute(1, 2, 0)
    border = torch.ones((h + 4, w + 4), dtype=torch.bool,
                        device=pack.device)
    border[2:-2, 2:-2] = False
    padded[..., 9] = torch.where(border, -1.0, padded[..., 9])
    gh, gw = h + 2, w + 2
    table = torch.cat([padded[a:a + gh, b:b + gw] for a in range(3)
                       for b in range(3)], dim=-1).reshape(gh * gw, 90)
    rows = (fy + 1).clamp(0, gh - 1) * gw + (fx + 1).clamp(0, gw - 1)
    g = table[rows].reshape(h, w, 9, 10)
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            vals = g[..., (dy + 1) * 3 + (dx + 1), :]
            qx, qy = fx + dx, fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            taps[(dy, dx)] = (vals[..., 0:6],
                              tap_valid(vals, inb, curr_gb["geom_id"],
                                        curr_gb["normal"]))
    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_gb["geom_id"],
                                 history_length, luminance(current_color),
                                 color_alpha_min, moment_alpha_min)


def back_projection_packed2(res, current_color, curr_gb, prev_gb,
                            prev_viewmat, color_history, moment_history,
                            history_length, color_alpha_min,
                            moment_alpha_min):
    """Back-projection by four gathered rows per pixel (ptdn_tpu/denoise/
    reproject.py:580 back_projection_packed2): the previous frame packed
    per 2x2 pixel block (40 floats a row), so the 3x3 window, which always
    lies in 2x2 blocks, is four rows. Its 16 slots are summed block by
    block, as the JAX function sums them, so the bilinear sums take the
    four taps in the order the blocks hold them. h and w must be even.
    Returns (variance, color_acc, moment_acc, history_update)."""
    w, h = res
    hb, wb = h // 2, w // 2
    fx, fy, fracx, fracy, base_valid = _reproj_base(
        res, curr_gb["position"], prev_viewmat)
    curr_geom, curr_normal = curr_gb["geom_id"], curr_gb["normal"]
    pix = prev_pack(color_history, moment_history, history_length,
                    prev_gb["normal"], prev_gb["geom_id"])
    table = pix.reshape(hb, 2, wb, 2, 10).permute(0, 2, 1, 3, 4).reshape(
        hb * wb, 40)
    by0 = torch.div(fy - 1, 2, rounding_mode="floor")
    bx0 = torch.div(fx - 1, 2, rounding_mode="floor")
    quad = [(0, 0), (1, 0), (0, 1), (1, 1)]
    vbil = {k: torch.zeros_like(base_valid) for k in quad}
    slots = []
    for a in (0, 1):
        for b in (0, 1):
            rows = ((by0 + a).clamp(0, hb - 1) * wb
                    + (bx0 + b).clamp(0, wb - 1))
            g = table[rows]
            for i in (0, 1):
                for j in (0, 1):
                    vals = g[..., (i * 2 + j) * 10:(i * 2 + j) * 10 + 10]
                    gy, gx = 2 * (by0 + a) + i, 2 * (bx0 + b) + j
                    dy, dx = gy - fy, gx - fx
                    inb = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
                    valid = tap_valid(vals, inb, curr_geom, curr_normal)
                    slots.append((vals, dy, dx, valid))
                    for ty, tx in quad:
                        vbil[ty, tx] = vbil[ty, tx] | (
                            (dy == ty) & (dx == tx) & valid)
    all_valid = base_valid
    for k in quad:
        all_valid = all_valid & vbil[k]
    zero = torch.zeros_like(fracx)
    pc = torch.zeros_like(current_color)
    pm = torch.zeros(curr_geom.shape + (2,), device=zero.device)
    fc, fm = torch.zeros_like(pc), torch.zeros_like(pm)
    ph = sumw = fh = cnt = zero
    for vals, dy, dx, valid in slots:
        wy = torch.where(dy == 0, 1.0 - fracy, torch.where(dy == 1, fracy,
                                                           0.0))
        wx = torch.where(dx == 0, 1.0 - fracx, torch.where(dx == 1, fracx,
                                                           0.0))
        bw = torch.where(all_valid & valid, wy * wx, 0.0)
        pc = fma(bw[..., None], vals[..., 0:3], pc)
        pm = fma(bw[..., None], vals[..., 3:5], pm)
        ph = fma(bw, vals[..., 5], ph)
        sumw = sumw + bw
        fb = torch.where(valid & (dy.abs() <= 1) & (dx.abs() <= 1), 1.0, 0.0)
        fc = fc + fb[..., None] * vals[..., 0:3]
        fm = fm + fb[..., None] * vals[..., 3:5]
        fh = fh + fb * vals[..., 5]
        cnt = cnt + fb
    bilinear_ok = all_valid & (sumw >= 0.01)
    safe = torch.clamp_min(sumw, 1e-20)
    return _accumulate(bilinear_ok, (pc / safe[..., None],
                                     pm / safe[..., None], ph / safe),
                       (fc, fm, fh, cnt), current_color, curr_geom,
                       history_length, luminance(current_color),
                       color_alpha_min, moment_alpha_min)


# rows per band of the banded reprojection, and the rows its slab reaches
# beyond the band's mean vertical shift (ptdn_tpu/denoise/reproject.py:577)
BAND_ROWS = 64
BAND_MARGIN = 16


class Rows:
    """A shard's place in the image for the back-projection: its pixels
    are image rows row0 .. row0 + h - 1 of a full_h-row image, and the
    previous frame's planes it is given hold image rows from prev_row0
    (csrc/reproject.cuh:ReprojRows). None is the whole image."""

    @staticmethod
    def of(rows, h: int):
        return (0, h, 0) if rows is None else tuple(int(r) for r in rows)

    @staticmethod
    def check(rows, h: int, prev_h: int, banded: bool):
        """Refuse a window of the previous frame that misses a row the
        taps may read: the whole image for the band mode, else the rows
        within 2 of the shard's (the stencil's reach) inside the image."""
        row0, full_h, prev_row0 = Rows.of(rows, h)
        lo, hi = ((0, full_h) if banded
                  else (max(row0 - 2, 0), min(row0 + h + 2, full_h)))
        if prev_row0 > lo or prev_row0 + prev_h < hi:
            raise ValueError(f"previous rows [{prev_row0}, "
                             f"{prev_row0 + prev_h}) miss [{lo}, {hi})")

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


def band_starts(res, fy, geom_id, band_rows: int = BAND_ROWS,
                margin: int = BAND_MARGIN) -> torch.Tensor:
    """Each band's slab start in the padded grid (int64 (n_bands,)):
    start = clip(r0 + s_b - margin, 0, h + 2 - slab_h), s_b the band's
    mean vertical displacement over pixels with geometry, rounded half up
    (ptdn_tpu/denoise/reproject.py:466-476).

    The JAX package sums the displacements in float32, exact only while
    the band's sum stays below 2**24 in magnitude (a 64-row band at 1920
    wide holds 122,880 pixels, so a mean vertical flow above ~136 px can
    round there). This sums in int64, then divides in float32 as it
    does: the two agree wherever the float32 sum is exact, and may differ
    by a row of s_b beyond it."""
    w, h = res
    return starts_from_sums(*band_sums(res, fy, geom_id, band_rows), h,
                            band_rows, margin)


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


def back_projection_banded(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min, band_rows: int = BAND_ROWS,
                           margin: int = BAND_MARGIN, starts=None,
                           rows=None):
    """Back-projection for any motion with the JAX package's band rule
    (ptdn_tpu/denoise/reproject.py:406 back_projection_banded): per band
    of `band_rows` rows, a slab of band_rows + 2 * margin + 1 padded rows
    centred on the band's mean vertical shift; a pixel whose base row
    falls outside its band's slab is rejected (history restart) instead
    of read. The JAX function gathers from a packed slab table because a
    TPU's gathers are count-bound; here the taps are read directly (with
    clamped indices in the plain version), which gives the same values
    wherever a tap is valid. `starts` are band_starts (the tail of
    motion_bounds), computed here when not given. CPU tensors take the
    plain version; CUDA tensors launch kernel C's band mode. `rows`
    places a shard (Rows); its starts are then the image's, given."""
    from ptdn_tpu_torch.ops.cuda import reproject as kernel_c

    if starts is None:
        _, fy, _, _, _ = _reproj_base(res, curr_gb["position"],
                                      prev_viewmat)
        starts = band_starts(res, fy, curr_gb["geom_id"], band_rows,
                             margin).to(torch.int32)
    return kernel_c.back_projection_banded(
        res, current_color, curr_gb, prev_gb, prev_viewmat, color_history,
        moment_history, history_length, color_alpha_min, moment_alpha_min,
        starts, band_rows, margin, rows=rows)


def back_projection_auto(res, current_color, curr_gb, prev_gb, prev_viewmat,
                         color_history, moment_history, history_length,
                         color_alpha_min, moment_alpha_min, near=None,
                         starts=None, rows=None):
    """Kernel C (or its plain version on CPU) where the motion allows it,
    else the banded path (back_projection_banded). `near` and `starts`
    are motion_bounds' flag and band starts, computed here (one host
    read) when not given. `rows` places a shard (Rows), whose previous
    frame is the stencil's window when near, else the whole image."""
    from ptdn_tpu_torch.ops.cuda.reproject import back_projection_stencil

    if near is None:
        bounds = motion_bounds(res, curr_gb, prev_viewmat)
        near, starts = bool(bounds[0]), bounds[1:]
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    if near:
        return back_projection_stencil(*args, rows=rows)
    return back_projection_banded(*args, starts=starts, rows=rows)
