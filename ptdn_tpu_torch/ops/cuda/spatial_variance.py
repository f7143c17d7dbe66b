"""Kernel R: native mode's spatial variance and its short-history
fallback (csrc/spatial_variance.cu), with its plain PyTorch version
(denoise/variance.py).

Replaces XLA code of the JAX package, outside any Pallas kernel:
ptdn_tpu/denoise/variance.py:spatial_variance and
variance_with_spatial_fallback (as C's band mode and Q replace XLA code).
A block takes a TILE_W x TILE_H tile of pixels: the pixels whose history
is shorter than 4 frames (every pixel without a history) run the 7x7
bilateral moment estimate, from the tile and its RADIUS-pixel ring
staged in shared memory, and the others keep the temporal variance, in
one pass, with the select made per pixel on the card instead of the JAX
package's lax.cond on any pixel needing it: the same values, no host
read.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ptdn_tpu_torch.denoise.variance import (RADIUS, spatial_variance,
                                             variance_with_spatial_fallback)
from ptdn_tpu_torch.ops.cuda import _lib

# csrc/spatial_variance.cu: a block of TILE_W x TILE_H threads owns a
# tile of as many pixels and stages it with a RADIUS-pixel ring
TILE_W = 16
TILE_H = 16


class SpatialVarianceArgs(ctypes.Structure):
    """Mirror of csrc/spatial_variance.cu:SpatialVarianceArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("color", "pos", "nrm",
                                                 "hist", "var", "out")]
                + [(k, ctypes.c_int) for k in ("w", "h")]
                + [(k, ctypes.c_float) for k in ("sigma_n", "sigma_x")])


def sv_tiling(h: int, w: int, tile=(TILE_W, TILE_H)):
    """Kernel R's grid: (tiles_y, tiles_x) tiles of `tile` (width,
    height) pixels."""
    return -(-h // tile[1]), -(-w // tile[0])


def sv_tile_pixels(h: int, w: int):
    """The pixels kernel R's blocks filter and stage, as its code maps
    them (csrc/spatial_variance.cu:spatial_variance_kernel): (block, y,
    x) of every thread whose pixel lies in the image, and (block, y, x)
    of every staged pixel that does, each an int64 array over all
    blocks."""
    tiles_y, tiles_x = sv_tiling(h, w)
    b = np.arange(tiles_y * tiles_x)[:, None]
    ty, tx = (b // tiles_x) * TILE_H, (b % tiles_x) * TILE_W
    t = np.arange(TILE_W * TILE_H)[None, :]
    side = TILE_W + 2 * RADIUS
    s = np.arange(side * (TILE_H + 2 * RADIUS))[None, :]

    def inside(yy, xx):
        yy, xx = np.broadcast_arrays(yy, xx)
        bb = np.broadcast_to(b, yy.shape)
        m = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return bb[m], yy[m], xx[m]
    return (inside(ty + t // TILE_W, tx + t % TILE_W),
            inside(ty - RADIUS + s // side, tx - RADIUS + s % side))


def sv_block_need(need: np.ndarray, tile=(TILE_W, TILE_H)) -> np.ndarray:
    """The number of pixels that run the taps in each block of kernel R's
    grid (block-major), for `need` (H, W) bool, with tiles of `tile`
    (width, height) pixels."""
    h, w = need.shape
    tiles_y, tiles_x = sv_tiling(h, w, tile)
    pad = np.zeros((tiles_y * tile[1], tiles_x * tile[0]), bool)
    pad[:h, :w] = need
    return pad.reshape(tiles_y, tile[1], tiles_x, tile[0]).sum(
        axis=(1, 3)).reshape(-1)


def spatial_variance_plain(color, gbuffer, sigma_n, sigma_x,
                           history: Optional[torch.Tensor] = None,
                           variance: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel R (see spatial_variance_fallback)."""
    if history is None:
        return spatial_variance(color, gbuffer, sigma_n, sigma_x)
    return variance_with_spatial_fallback(variance, history, color, gbuffer,
                                          sigma_n, sigma_x)


def spatial_variance_fallback(color: torch.Tensor,
                              gbuffer: Dict[str, torch.Tensor], sigma_n,
                              sigma_x,
                              history: Optional[torch.Tensor] = None,
                              variance: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The variance of native mode's SVGF frame, (H, W) float32: with
    `history` (H, W) int32 and `variance` (H, W), the temporal variance
    where the history is at least 4 frames and the spatial estimate of
    `color` (H, W, 3) elsewhere; without them the spatial estimate on
    every pixel. The G-buffer's position and normal are (H, W, 3). CPU
    tensors take the plain version; CUDA tensors launch kernel R."""
    _lib.require(color.device, "spatial_variance_fallback")
    if color.device.type == "cpu":
        return spatial_variance_plain(color, gbuffer, sigma_n, sigma_x,
                                      history, variance)
    return _spatial_variance_kernel(color, gbuffer, sigma_n, sigma_x,
                                    history, variance)


def _spatial_variance_kernel(color, gbuffer, sigma_n, sigma_x, history=None,
                             variance=None):
    h, w = color.shape[0], color.shape[1]
    color = color.contiguous()
    pos = gbuffer["position"].contiguous()
    nrm = gbuffer["normal"].contiguous()
    for name, t in (("color", color), ("position", pos), ("normal", nrm)):
        _lib.check_tensor(t, torch.float32, (h, w, 3), name)
    if history is not None:
        _lib.check_tensor(history, torch.int32, (h, w), "history")
        _lib.check_tensor(variance, torch.float32, (h, w), "variance")
    out = torch.empty((h, w), dtype=torch.float32, device=color.device)
    p = _lib.ptr
    args = SpatialVarianceArgs(
        color=p(color), pos=p(pos), nrm=p(nrm), hist=p(history),
        var=p(variance), out=p(out), w=w, h=h, sigma_n=float(sigma_n),
        sigma_x=float(sigma_x))
    _lib.launch("ptdn_spatial_variance", args)
    spatial_variance_fallback.launches += 1
    return out


spatial_variance_fallback.launches = 0
