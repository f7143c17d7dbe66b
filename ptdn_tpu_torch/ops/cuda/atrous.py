"""Kernel D: one edge-stopping à-trous level (csrc/atrous.cu), with its
plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/atrous.py:
atrous_level_pallas, whose arithmetic both versions follow: the three
edge-stopping weights fold into one exp of the summed distances (the
reference's min(1, exp(-x)) clamps are no-ops for x >= 0), divisions by
the sigma terms become reciprocal multiplies, and taps outside the image
weigh zero.

As the TPU kernel does, the G-buffer planes are packed once per frame
(pack_static_planes: position and normal in one (H, W, 8) buffer) and the
level's color and variance travel packed from one level to the next (one
(H, W, 4) buffer, which the wrapper takes and returns as the views
``cv[..., :3]`` and ``cv[..., 3]``). A level that feeds the color history
or ends the filter writes the (H, W, 3) and (H, W) layout of the SVGF
state instead (``pack_out=False``), and a level reads either layout.

Shard mode (the TPU kernel's row0, full_h, halo_top and halo_bottom):
the level filters the h rows of a shard whose first row is image row
`row0` of a `full_h`-row image, from inputs that carry real neighbour
rows, `halo` above and below the color and variance and `static_halo`
around the G-buffer (parallel/halo.py:halo_rows, zeros past the image).
Taps are masked by their global row, so each pixel equals the unsharded
level's bit for bit. The halo is the taps' exact reach, 2 << level rows
(the variance pre-blur reads one row, inside it); the albedo of the last
level is read at the pixel only and has none.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ptdn_tpu_torch.denoise.atrous import H5, gaussian3x3, shift
from ptdn_tpu_torch.denoise.reproject import _norm3, luminance
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.fp import fma, sqrt

# csrc/atrous.cu: a block is ROWS warps; warp r filters row r of a tile
# of the sub-lattices of stride step = 1 << level, its lane q the pixel
# of lattice column q // P of phase q % P, for P = min(PHASES, step)
# adjacent phases, and the block stages the tile with the HALO pixels
# the 5x5 taps reach on every side of each lattice
ROWS = 8
PHASES = 4
HALO = 2


class AtrousArgs(ctypes.Structure):
    """Mirror of csrc/atrous.cu:AtrousArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "cv", "var", "stat", "albedo", "cv_out", "var_out")]
        + [(k, ctypes.c_int) for k in ("w", "h", "level", "blur_variance",
                                       "phases", "tiles_x", "tiles_y")]
        + [(k, ctypes.c_float) for k in ("sigma_l", "sigma_n", "sigma_x")]
        + [(k, ctypes.c_int) for k in ("row0", "full_h", "halo",
                                       "static_halo")])


def atrous_halo(level: int) -> int:
    """Rows the level's taps reach above and below a pixel: 2 << level."""
    return 2 << level


def pack_static_planes(position: torch.Tensor,
                       normal: torch.Tensor) -> torch.Tensor:
    """The frame's G-buffer position and normal (H, W, 3) packed into one
    (H, W, 8) float32 buffer, x y z 0 x y z 0, which every level reads
    (ptdn_tpu/ops/pallas/atrous.py:pack_static_planes packs the same
    planes once per frame for the TPU kernel). Position lies at
    [..., 0:3], normal at [..., 4:7]."""
    pad = position.new_zeros(1).expand(position.shape[:2] + (1,))
    return torch.cat((position, pad, normal, pad), dim=-1)


def atrous_tiling(h: int, w: int, level: int):
    """Kernel D's launch geometry: (blocks, phases, tiles_y, tiles_x). The
    image's pixels fall into step x step sub-lattices of stride step =
    1 << level (pixel (y, x) into phase (y % step, x % step)), on which
    the level's dilated taps are a dense 5x5 neighbourhood. A block takes
    one row phase and `phases` = min(PHASES, step) adjacent column phases
    and, of those lattices, a tile of ROWS rows and 32 // phases columns,
    tiles_y x tiles_x tiles a lattice: lane q of warp r filters lattice
    row r, column q // phases of phase q % phases, so that the lanes of a
    warp hold runs of adjacent pixels (atrous_tile_pixels spells the
    mapping out)."""
    step = 1 << level
    phases = min(PHASES, step)
    tiles_y = -(-(-(-h // step)) // ROWS)
    tiles_x = -(-(-(-w // step)) // (32 // phases))
    return (step * (step // phases) * tiles_y * tiles_x, phases, tiles_y,
            tiles_x)


def atrous_tile_pixels(h: int, w: int, level: int):
    """The pixels kernel D's blocks filter and stage, as its code maps
    them (csrc/atrous.cu:atrous_level_kernel): (y, x) of every thread
    whose pixel lies in the image, and (y, x) of every staged pixel that
    does, each an int64 array over all blocks."""
    step = 1 << level
    blocks, phases, tiles_y, tiles_x = atrous_tiling(h, w, level)
    cols = 32 // phases
    b = np.arange(blocks)[:, None]
    tiles = tiles_y * tiles_x
    group, t = b // tiles, b % tiles
    py, px = group // (step // phases), (group % (step // phases)) * phases
    ty, tx = t // tiles_x, t % tiles_x
    oy = py + (ty * ROWS - HALO) * step
    ox = px + (tx * cols - HALO) * step
    th = np.arange(ROWS * 32)[None, :]
    r, q = th // 32, th % 32
    y = oy + (r + HALO) * step
    x = ox + (q // phases + HALO) * step + q % phases
    sc = cols + 2 * HALO
    k = np.arange((ROWS + 2 * HALO) * sc * phases)[None, :]
    sy = oy + (k // (sc * phases)) * step
    sx = ox + ((k // phases) % sc) * step + k % phases

    def inside(yy, xx):
        m = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return yy[m], xx[m]
    return inside(y, x), inside(sy, sx)


def _views(cv: torch.Tensor):
    return cv[..., :3], cv[..., 3]


def atrous_level_plain(color, variance, static, albedo, level: int,
                       sigma_l, sigma_n, sigma_x, blur_variance: bool,
                       pack_out: bool = False, row0: int = 0,
                       full_h=None, halo: int = 0, static_halo: int = 0):
    """Plain PyTorch version of kernel D (see atrous_level), on the same
    tensors: position and normal are views of `static`. Shard mode
    filters the extended rows with every tap masked by its global row,
    then keeps the shard's own."""
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


def atrous_level(color, variance, static, albedo, level: int, sigma_l,
                 sigma_n, sigma_x, blur_variance: bool,
                 pack_out: bool = False, row0: int = 0, full_h=None,
                 halo: int = 0, static_halo: int = 0):
    """One à-trous level: color (H, W, 3) and variance (H, W), either
    separate contiguous tensors or the views of one packed (H, W, 4)
    buffer that a level with `pack_out` returned; `static` the frame's
    pack_static_planes; `albedo` (H, W, 3) remodulates the output (the
    last level with add_color) or is None. Returns (color_out,
    variance_out) in new tensors: the views of a packed buffer with
    `pack_out`, else contiguous. CPU tensors take the plain version;
    CUDA tensors launch kernel D.

    Shard mode: the output's h rows are image rows row0.. of a
    `full_h`-row image; color and variance hold h + 2 * halo rows and
    `static` h + 2 * static_halo, the shard's rows in the middle, with
    halo >= atrous_halo(level) and static_halo >= halo (none where the
    shard is the whole image); `albedo` holds h rows."""
    _lib.require(color.device, "atrous_level")
    h = variance.shape[0] - 2 * halo
    if (row0, full_h) not in ((0, None), (0, h)):
        if halo < atrous_halo(level) or static_halo < halo or h <= 0:
            raise ValueError(f"shard mode at level {level} needs halo >= "
                             f"{atrous_halo(level)} <= static_halo, got "
                             f"{halo}, {static_halo} ({h} rows)")
        if static.shape[0] != h + 2 * static_halo:
            raise ValueError(f"static holds {static.shape[0]} rows, not "
                             f"{h} + 2 * {static_halo}")
    args = (color, variance, static, albedo, level, sigma_l, sigma_n,
            sigma_x, blur_variance, pack_out, row0, full_h, halo,
            static_halo)
    if color.device.type == "cpu":
        return atrous_level_plain(*args)
    return _atrous_level_kernel(*args)


def _packed_pair(color, variance) -> bool:
    """Are color and variance the [..., :3] and [..., 3] views of one
    contiguous, 16-byte aligned (H, W, 4) float32 buffer?"""
    h, w = variance.shape
    return (color.dtype == variance.dtype == torch.float32
            and tuple(color.shape) == (h, w, 3)
            and color.stride() == (4 * w, 4, 1)
            and variance.stride() == (4 * w, 4)
            and variance.data_ptr() == color.data_ptr() + 12
            and color.data_ptr() % 16 == 0)


def _atrous_level_kernel(color, variance, static, albedo, level, sigma_l,
                         sigma_n, sigma_x, blur_variance, pack_out=False,
                         row0=0, full_h=None, halo=0, static_halo=0):
    hx, w = variance.shape
    h = hx - 2 * halo
    packed_in = _packed_pair(color, variance)
    ins = [("static", static, (h + 2 * static_halo, w, 8))]
    if not packed_in:
        ins += [("color", color, (hx, w, 3)), ("variance", variance, (hx, w))]
    if albedo is not None:
        ins.append(("albedo", albedo, (h, w, 3)))
    for name, t, shape in ins:
        _lib.check_tensor(t, torch.float32, shape, name)
    dev = color.device
    if pack_out:
        cv_out = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
        out, var_out = _views(cv_out)
    else:
        cv_out = out = torch.empty((h, w, 3), dtype=torch.float32,
                                   device=dev)
        var_out = torch.empty((h, w), dtype=torch.float32, device=dev)
    blocks, phases, tiles_y, tiles_x = atrous_tiling(h, w, level)
    p = _lib.ptr
    args = AtrousArgs(
        p(color), None if packed_in else p(variance), p(static), p(albedo),
        p(cv_out), None if pack_out else p(var_out), w, h, level,
        int(blur_variance), phases, tiles_x, tiles_y, float(sigma_l),
        float(sigma_n), float(sigma_x), row0, h if full_h is None else full_h,
        halo, static_halo)
    _lib.launch("ptdn_atrous_level", args, ctypes.c_int(blocks))
    atrous_level.launches += 1
    if halo:
        atrous_level.shard_launches += 1
    return out, var_out


atrous_level.launches = 0
atrous_level.shard_launches = 0     # of them, in shard mode
