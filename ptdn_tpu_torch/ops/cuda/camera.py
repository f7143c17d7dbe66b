"""Kernels S1 (camera_rays) and S2 (primary_finish): a moved camera's
rays and the primary hit's G-buffer position, albedo and hit flag
(csrc/motion.cu), with their plain PyTorch versions.

The JAX package computes both as XLA code (ptdn_tpu/ops/camera.py:
generate_camera_rays; engine/wavefront.py:albedo_from and the position
`t * d + o`), fused there into a few TPU ops. The plain versions round
each fused multiply-add through ops/fp.py's float64 emulation, ~24 small
launches over every pixel on the card; the kernels call `fmaf` at the
same places, one thread a pixel, so each equals its plain version bit
for bit. CPU tensors take the plain versions.

S1 runs wherever the camera rays are made (every moved frame, and a
restored state, whose rays are not frame state). S2 follows kernel A on
a moved frame: the position of the new hit, its albedo, the material
color or, with `show_texture` on a textured material, the nearest texel
(Texture::getColor), and its hit flag; on a restored state the position
alone, from the restored hit distance.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ptdn_tpu_torch.ops.camera import generate_camera_rays_plain
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.scene_intersect import tex_index, texel_rgb
from ptdn_tpu_torch.ops.fp import fma


class CameraArgs(ctypes.Structure):
    """Mirror of csrc/motion.cu:CameraArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("pos", "view", "up", "right",
                                                "pl", "o", "d")]
                + [(k, ctypes.c_int) for k in ("w", "h", "row0")]
                + [(k, ctypes.c_float) for k in ("cx", "cy")])


class FinishArgs(ctypes.Structure):
    """Mirror of csrc/motion.cu:FinishArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("t", "o", "d", "mat", "uv",
                                                "geom", "position", "albedo",
                                                "hit")]
                + [(k, ctypes.c_int) for k in ("n", "show_tex")])


def camera_rays(cam: Dict[str, torch.Tensor], resolution: Tuple[int, int],
                row0: int = 0, full_height: Optional[int] = None):
    """ops/camera.py:generate_camera_rays: (origins, directions), each
    (N, 3) in index = x + y*W order, of rows row0.. of a `full_height`-row
    image. CPU camera tensors take the plain version; CUDA ones launch
    kernel S1."""
    dev = cam["view"].device
    _lib.require(dev, "camera_rays")
    if dev.type == "cpu":
        return generate_camera_rays_plain(cam, resolution, row0, full_height)
    return _camera_rays_kernel(cam, resolution, row0, full_height)


def _camera_rays_kernel(cam, resolution, row0=0, full_height=None):
    w, h = resolution
    hc = h if full_height is None else full_height
    shapes = {"position": 3, "view": 3, "up": 3, "right": 3,
              "pixel_length": 2}
    for k, n in shapes.items():
        _lib.check_tensor(cam[k], torch.float32, (n,), f"camera {k}")
    o = torch.empty((w * h, 3), dtype=torch.float32, device=cam["view"].device)
    d = torch.empty_like(o)
    p = _lib.ptr
    # the pixel grid's centre offsets, float32 as the plain version's
    # scalars (exact: half-integers)
    args = CameraArgs(p(cam["position"]), p(cam["view"]), p(cam["up"]),
                      p(cam["right"]), p(cam["pixel_length"]), p(o), p(d),
                      w, h, int(row0), w * 0.5 - 0.5, hc * 0.5 - 0.5)
    _lib.launch("ptdn_camera_rays", args)
    camera_rays.launches += 1
    return o, d


def albedo_from(ds, mat_id: torch.Tensor, uv: torch.Tensor,
                show_texture: bool) -> torch.Tensor:
    """Material color or nearest texel (pathtrace.cu:320-322, 343-354)."""
    mat = mat_id.to(torch.int64)
    color = ds.mat_attr[mat, 0:3]
    if not show_texture:
        return color
    idx = tex_index(ds, mat, uv[:, 0], uv[:, 1])
    return torch.where((idx >= 0)[:, None],
                       torch.stack(texel_rgb(ds, idx), dim=-1), color)


def primary_finish_plain(ds, o, d, t, isect=None,
                         show_texture: bool = False):
    """Plain PyTorch version of kernel S2 (see primary_finish)."""
    position = fma(t[:, None], d, o)
    if isect is None:
        return position, None, None
    return (position, albedo_from(ds, isect["mat_id"], isect["uv"],
                                  show_texture), isect["geom_id"] >= 0)


def primary_finish(ds, o: torch.Tensor, d: torch.Tensor, t: torch.Tensor,
                   isect: Optional[Dict[str, torch.Tensor]] = None,
                   show_texture: bool = False):
    """(position, albedo, hit): the G-buffer position t * d + o (one
    rounding, as fmaf) of the primary hits at distance t (N,) along rays
    o, d (N, 3), and where kernel A's dict `isect` of those rays is given
    (its int32 mat_id (N,), uv (N, 2) and int32 geom_id (N,); t is its
    t) the hits' albedo (N, 3) (albedo_from) and bool hit flag (N,)
    (geom_id >= 0), else None and None. CPU tensors take the plain
    version; CUDA tensors launch kernel S2."""
    _lib.require(t.device, "primary_finish")
    if t.device.type == "cpu":
        return primary_finish_plain(ds, o, d, t, isect, show_texture)
    return _primary_finish_kernel(ds, o, d, t, isect, show_texture)


def texture_dev(ds) -> _lib.SceneDev:
    """The part of the kernels' scene view (csrc/ptdn.cuh:SceneDev) that
    an albedo reads: the material table and the texture atlas."""
    tensors = dict(mat_attr=ds.mat_attr, tex_wh=ds.tex_wh,
                   tex_flat=ds.tex_flat_u32)
    for k, x in tensors.items():
        if x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError(f"scene tensor {k}: expected contiguous on "
                             f"cuda, got {x.device}")
    return _lib.SceneDev(**{k: x.data_ptr() for k, x in tensors.items()},
                         tex_h=int(ds.tex_atlas.shape[1]),
                         tex_w=int(ds.tex_atlas.shape[2]))


def _primary_finish_kernel(ds, o, d, t, isect=None, show_texture=False):
    n = t.shape[0]
    _lib.check_tensor(t, torch.float32, (n,), "t")
    _lib.check_tensor(o, torch.float32, (n, 3), "o")
    _lib.check_tensor(d, torch.float32, (n, 3), "d")
    position = torch.empty((n, 3), dtype=torch.float32, device=t.device)
    mat = uv = geom = albedo = hit = None
    if isect is not None:
        mat, uv, geom = isect["mat_id"], isect["uv"], isect["geom_id"]
        _lib.check_tensor(mat, torch.int32, (n,), "mat_id")
        _lib.check_tensor(uv, torch.float32, (n, 2), "uv")
        _lib.check_tensor(geom, torch.int32, (n,), "geom_id")
        albedo = torch.empty_like(position)
        hit = torch.empty(n, dtype=torch.bool, device=t.device)
    p = _lib.ptr
    args = FinishArgs(p(t), p(o), p(d), p(mat), p(uv), p(geom), p(position),
                      p(albedo), p(hit), n, int(bool(show_texture)))
    _lib.launch("ptdn_primary_finish", texture_dev(ds), args)
    primary_finish.launches += 1
    return position, albedo, hit


camera_rays.launches = 0
primary_finish.launches = 0
