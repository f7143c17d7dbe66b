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


def _reproj_base(res, pos, prev_viewmat):
    """Reproject world position through the previous view matrix to
    prev-frame pixel coords (denoise.cu:195-217, incl. the reference's
    omitted tan(fov/2) quirk). Returns (fx, fy, fracx, fracy,
    base_valid), fx/fy as int64."""
    w, h = res
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
                           color_alpha_min, moment_alpha_min, in_slab=None):
    """The 3x3 taps of `base` (_reproj_base's output) gathered with
    clamped indices, then _accumulate_from_taps. `in_slab` (H, W) bool,
    where given, rejects the base and every tap of the pixels where it is
    False (the banded path's rule)."""
    w, h = res
    fx, fy, fracx, fracy, base_valid = base
    pack = prev_pack(color_history, moment_history, history_length,
                     prev_gb["normal"], prev_gb["geom_id"])
    taps = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            qx, qy = fx + dx, fy + dy
            inb = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            if in_slab is not None:
                inb = inb & in_slab
            vals = pack[qy.clamp(0, h - 1), qx.clamp(0, w - 1)]
            taps[(dy, dx)] = (vals[..., 0:6],
                              tap_valid(vals, inb, curr_gb["geom_id"],
                                        curr_gb["normal"]))
    if in_slab is not None:
        base_valid = base_valid & in_slab
    return _accumulate_from_taps(taps, base_valid, fracx, fracy,
                                 current_color, curr_gb["geom_id"],
                                 history_length, luminance(current_color),
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


# rows per band of the banded reprojection, and the rows its slab reaches
# beyond the band's mean vertical shift (ptdn_tpu/denoise/reproject.py:577)
BAND_ROWS = 64
BAND_MARGIN = 16


def slab_rows(h: int, band_rows: int, margin: int) -> int:
    """Rows of a band's slab in the padded grid of h + 2 rows."""
    return min(band_rows + 2 * margin + 1, h + 2)


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
    n_bands = -(-h // band_rows)
    pad = n_bands * band_rows - h
    dev = fy.device
    iy = torch.arange(h, device=dev)[:, None]
    valid = geom_id >= 0
    dyv = torch.where(valid, fy - iy, 0)
    rows = torch.nn.functional.pad(dyv, (0, 0, 0, pad))
    vrows = torch.nn.functional.pad(valid.to(torch.int64), (0, 0, 0, pad))
    total = rows.reshape(n_bands, -1).sum(dim=1)
    cnt = vrows.reshape(n_bands, -1).sum(dim=1).clamp_min(1)
    s_b = torch.floor(total.to(torch.float32) / cnt.to(torch.float32)
                      + 0.5).to(torch.int64)
    r0 = torch.arange(n_bands, device=dev) * band_rows
    return (r0 + s_b - margin).clamp(0, h + 2 - slab_rows(h, band_rows,
                                                          margin))


def in_slab(res, fy, starts, band_rows: int = BAND_ROWS,
            margin: int = BAND_MARGIN) -> torch.Tensor:
    """(H, W) bool: the pixel's clipped padded base row gi = clip(fy + 1,
    0, h + 1) lies in its band's slab [start, start + slab_h)
    (ptdn_tpu/denoise/reproject.py:486-491)."""
    w, h = res
    gi = (fy + 1).clamp(0, h + 1)
    band = torch.arange(h, device=fy.device) // band_rows
    li = gi - starts.to(torch.int64)[band][:, None]
    return (li >= 0) & (li < slab_rows(h, band_rows, margin))


def motion_bounds(res, curr_gb, prev_viewmat, band_rows: int = BAND_ROWS,
                  margin: int = BAND_MARGIN) -> torch.Tensor:
    """int32 (1 + n_bands,): [0] is 1 where every reprojected base of a
    pixel with geometry lies within +-1 px of the pixel itself (the
    kernel-C domain), else 0; [1:] are the band starts of the banded
    reprojection (band_starts), from the same reprojection. One host read
    of it decides the branch, and the starts stay on the device."""
    w, h = res
    fx, fy, _, _, _ = _reproj_base(res, curr_gb["position"], prev_viewmat)
    dev = fx.device
    iy = torch.arange(h, device=dev)[:, None]
    ix = torch.arange(w, device=dev)[None, :]
    valid = curr_gb["geom_id"] >= 0
    dyv = torch.where(valid, (fy - iy).abs(), 0)
    dxv = torch.where(valid, (fx - ix).abs(), 0)
    near = (dyv.max() <= 1) & (dxv.max() <= 1)
    starts = band_starts(res, fy, curr_gb["geom_id"], band_rows, margin)
    return torch.cat([near.to(torch.int64)[None], starts]).to(torch.int32)


def back_projection_banded(res, current_color, curr_gb, prev_gb,
                           prev_viewmat, color_history, moment_history,
                           history_length, color_alpha_min,
                           moment_alpha_min, band_rows: int = BAND_ROWS,
                           margin: int = BAND_MARGIN, starts=None):
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
    plain version; CUDA tensors launch kernel C's band mode."""
    from ptdn_tpu_torch.ops.cuda import reproject as kernel_c

    if starts is None:
        _, fy, _, _, _ = _reproj_base(res, curr_gb["position"],
                                      prev_viewmat)
        starts = band_starts(res, fy, curr_gb["geom_id"], band_rows,
                             margin).to(torch.int32)
    return kernel_c.back_projection_banded(
        res, current_color, curr_gb, prev_gb, prev_viewmat, color_history,
        moment_history, history_length, color_alpha_min, moment_alpha_min,
        starts, band_rows, margin)


def back_projection_auto(res, current_color, curr_gb, prev_gb, prev_viewmat,
                         color_history, moment_history, history_length,
                         color_alpha_min, moment_alpha_min, near=None,
                         starts=None):
    """Kernel C (or its plain version on CPU) where the motion allows it,
    else the banded path (back_projection_banded). `near` and `starts`
    are motion_bounds' flag and band starts, computed here (one host
    read) when not given."""
    from ptdn_tpu_torch.ops.cuda.reproject import back_projection_stencil

    if near is None:
        bounds = motion_bounds(res, curr_gb, prev_viewmat)
        near, starts = bool(bounds[0]), bounds[1:]
    args = (res, current_color, curr_gb, prev_gb, prev_viewmat,
            color_history, moment_history, history_length, color_alpha_min,
            moment_alpha_min)
    if near:
        return back_projection_stencil(*args)
    return back_projection_banded(*args, starts=starts)
