"""Kernel E (shade_bounce): one bounce of shading over the sorted
wavefront's lane planes (csrc/shade.cu), with its plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/shade.py:shade_bounce_pallas
in its sorted-wavefront mode: a trailing pixel plane seeds each lane's
TEA stream (pix_seed), so the random streams follow pixels however the
coherence sort moves lanes. The plane layouts are the JAX package's: 22
planes in (I_*) plus the pixel plane, 21 out (O_*), each (NB, 128)
float32, masks as 0.0 / 1.0. The plain version is ops/bsdf.py:shade on
those planes; the kernel runs the same body per thread (csrc/shade.cuh).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ptdn_tpu_torch.ops.bsdf import shade
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.rng import init_rand

# input plane indices (shade.py:35-38)
(I_OX, I_OY, I_OZ, I_DX, I_DY, I_DZ, I_T, I_NX, I_NY, I_NZ,
 I_AR, I_AG, I_AB, I_TR, I_TG, I_TB, I_RR, I_RG, I_RB,
 I_MAT, I_ACT, I_DIF) = range(22)
N_IN = 22
I_PIX = N_IN
# output plane indices (shade.py:40-43)
(O_DX, O_DY, O_DZ, O_SPX, O_SPY, O_SPZ, O_TR, O_TG, O_TB,
 O_RR, O_RG, O_RB, O_DIF, O_ACT, O_SDX, O_SDY, O_SDZ,
 O_CR, O_CG, O_CB, O_NEE) = range(21)
N_OUT = 21


class ShadeParams(ctypes.Structure):
    """Mirror of csrc/shade.cuh:ShadeParams."""
    _fields_ = ([("mats", ctypes.c_void_p)]
                + [(k, ctypes.c_int) for k in ("shadow_ray", "reduce_var",
                                               "alb_skip")]
                + [(k, ctypes.c_float) for k in ("light_x", "light_y",
                                                 "light_z", "lrad", "sint")])


class ShadeArgs(ctypes.Structure):
    """Mirror of csrc/shade.cu:ShadeArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("inp", "out")]
                + [("n", ctypes.c_int)]
                + [(k, ctypes.c_uint) for k in ("fd", "lane0")]
                + [("p", ShadeParams)])


def shade_params(mat_attr, *, light_pos, lrad, sint, alb_skip, shadow_ray,
                 reduce_var) -> ShadeParams:
    """The shading parameters of kernels E and H."""
    return ShadeParams(
        mats=_lib.ptr(mat_attr), shadow_ray=int(shadow_ray),
        reduce_var=int(reduce_var), alb_skip=int(alb_skip),
        light_x=light_pos[0], light_y=light_pos[1], light_z=light_pos[2],
        lrad=lrad, sint=sint)


def _mask(b: torch.Tensor) -> torch.Tensor:
    return torch.where(b, 1.0, 0.0)


def shade_bounce_plain(planes: torch.Tensor, mat_attr: torch.Tensor, *,
                       fd: int, lane0: int, light_pos: Sequence[float],
                       lrad: float, sint: float, alb_skip: bool,
                       shadow_ray: bool, reduce_var: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel E (see shade_bounce)."""
    p = planes.reshape(N_IN + 1, -1)
    s = {"o": (p[I_OX], p[I_OY], p[I_OZ]), "d": (p[I_DX], p[I_DY], p[I_DZ]),
         "t": p[I_T], "n": (p[I_NX], p[I_NY], p[I_NZ]),
         "alb": (p[I_AR], p[I_AG], p[I_AB]),
         "tr": (p[I_TR], p[I_TG], p[I_TB]),
         "mat": p[I_MAT].to(torch.int64), "act": p[I_ACT] > 0.5,
         "dif": p[I_DIF] > 0.5}
    pix = p[I_PIX].to(torch.int32).to(torch.int64)
    seed = init_rand(pix + lane0, torch.full_like(pix, fd))
    r = shade(s, seed, mat_attr, light_pos, lrad, sint, alb_skip,
              shadow_ray, reduce_var)
    rad = tuple(p[k] + e for k, e in zip((I_RR, I_RG, I_RB), r["er"]))
    out = (*r["d"], *r["sp"], *r["tr"], *rad, _mask(r["dif"]),
           _mask(r["act"]), *r["sd"], *r["c"], _mask(r["nee"]))
    return torch.stack(out).reshape((N_OUT,) + tuple(planes.shape[1:]))


def shade_bounce(planes: torch.Tensor, mat_attr: torch.Tensor, *, fd: int,
                 lane0: int, light_pos: Sequence[float], lrad: float,
                 sint: float, alb_skip: bool, shadow_ray: bool,
                 reduce_var: bool) -> torch.Tensor:
    """Shade every lane: planes (23, NB, 128) float32 — the I_* planes
    then the pixel plane; mat_attr the (M, 16) material table. fd is
    frame + depth, lane0 the first pixel's global index; light_pos, lrad
    and sint the light center, disk radius and intensity; alb_skip skips
    the albedo multiply (first bounce under sep_color). Returns the
    (21, NB, 128) O_* planes. CPU tensors take the plain version; CUDA
    tensors launch kernel E."""
    _lib.require(planes.device, "shade_bounce")
    kw = dict(fd=fd, lane0=lane0, light_pos=light_pos, lrad=lrad,
              sint=sint, alb_skip=alb_skip, shadow_ray=shadow_ray,
              reduce_var=reduce_var)
    if planes.device.type == "cpu":
        return shade_bounce_plain(planes, mat_attr, **kw)
    return _shade_bounce_kernel(planes, mat_attr, **kw)


def _shade_bounce_kernel(planes, mat_attr, *, fd, lane0, light_pos, lrad,
                         sint, alb_skip, shadow_ray, reduce_var):
    shape = tuple(planes.shape[1:])
    _lib.check_tensor(planes, torch.float32, (N_IN + 1,) + shape, "planes")
    _lib.check_tensor(mat_attr, torch.float32, (mat_attr.shape[0], 16),
                      "mat_attr")
    out = torch.empty((N_OUT,) + shape, dtype=torch.float32,
                      device=planes.device)
    args = ShadeArgs(
        inp=_lib.ptr(planes), out=_lib.ptr(out), n=out[0].numel(),
        fd=fd & 0xFFFFFFFF, lane0=lane0 & 0xFFFFFFFF,
        p=shade_params(mat_attr, light_pos=light_pos, lrad=lrad, sint=sint,
                       alb_skip=alb_skip, shadow_ray=shadow_ray,
                       reduce_var=reduce_var))
    _lib.launch("ptdn_shade_bounce", args)
    shade_bounce.launches += 1
    return out


shade_bounce.launches = 0
