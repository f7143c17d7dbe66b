"""Kernels F (trace_bounce) and H (bounce_fused) (csrc/bounce.cuh), with
their plain PyTorch versions. The kernels run their build for the
scene's constants (csrc/scene/bounce.cu) where the scene has one
(GeomInfo.path_scene), else the kernel library's (csrc/bounce.cu); both
compute the same bits.

F: NEE visibility, the lit radiance add, the next closest hit and the
next albedo of the sorted wavefront's bounce.

Replaces the TPU kernel ptdn_tpu/ops/pallas/bounce.py:trace_bounce_pallas
(its joint next + shadow chunk scan, scene_intersect.py:joint_mesh_tiles)
and the albedo fetch after it (engine/wavefront.py:fetch_alb), whose
texel route back to the lanes is the TPU kernel
ptdn_tpu/ops/pallas/path.py:uncompact_tiles_pallas. Input: the bounce's
planes in the lanes' unsorted order, kernel E's 21 O_* planes followed by
the crossed-chunk range planes nlo, nhi, slo, shi and the pixel plane
(kernel Q, ops/cuda/ranges.py:ranges_and_key), and the order of the
coherence sort (engine/wavefront.py:permute_planes): sorted lane i reads
lane order[i], so the planes are never copied into sorted order. Output,
below the last depth: the next bounce's 22 I_* planes (the B_* planes
but uv, with the next albedo as I_AR..I_AB) and its pixel plane, in
sorted order, which kernel E reads as they lie; on the last depth the
(N, 3) radiance, each lane's in its pixel's row. The kernel scans each
block of 128 sorted lanes' chunks once, from triangles staged in shared
memory, each lane within its own ranges (csrc/chunk_scan.cuh); the plain
version gathers the planes by the order and scans every chunk with the
per-lane cull, which visits the same chunks (csrc/bounce.cuh says why),
so the two compute one function. The TPU kernel's tile-wide texel
compaction is dropped: a GPU thread reads its own texel at no such
cost.

H: the whole bounce of the unsorted per-bounce engine in one launch,
replacing the TPU kernel ptdn_tpu/ops/pallas/bounce.py:bounce_fused_pallas
without its pixel-plane mode, which no engine uses: kernel E's shading
of the 22 I_* planes with each lane's random stream seeded by its own
index (lane_seed), F's NEE visibility and lit add, and, when do_next,
the next closest hit (act *= hit); on the last depth the lane's current
t, normal and material stay and uv is 0. Both versions scan every chunk
with the per-lane cull. H writes no albedo: kernel K fetches it after
H, as the JAX engine's fetch_alb follows the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.scene_intersect import (GeomInfo, closest_hit,
                                                     entry, light_visible,
                                                     scene_dev, tex_index,
                                                     texel_rgb)
from ptdn_tpu_torch.ops.cuda.shade import (I_MAT, I_NX, I_NY, I_NZ, I_T,
                                           N_IN, N_OUT, O_ACT, O_CB, O_CG,
                                           O_CR, O_DIF, O_DX, O_DY, O_DZ,
                                           O_NEE, O_RB, O_RG, O_RR, O_SDX,
                                           O_SDY, O_SDZ, O_SPX, O_SPY, O_SPZ,
                                           O_TB, O_TG, O_TR, ShadeParams,
                                           shade_bounce_plain, shade_params)

# the four range planes after E's output (bounce.py:231-233), then the
# pixel plane: F's input
R_NLO, R_NHI, R_SLO, R_SHI, R_PIX = range(N_OUT, N_OUT + 5)
N_TIN = N_OUT + 5
# F's output below the last depth: the next bounce's I_* planes and its
# pixel plane
N_NEXT = N_IN + 1
# output plane indices (bounce.py:69-71)
(B_SPX, B_SPY, B_SPZ, B_DX, B_DY, B_DZ, B_T, B_NX, B_NY, B_NZ,
 B_TR, B_TG, B_TB, B_RR, B_RG, B_RB, B_MAT, B_ACT, B_DIF,
 B_UU, B_VV) = range(21)
N_BOUT = 21


class TraceArgs(ctypes.Structure):
    """Mirror of csrc/bounce.cu:TraceArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("inp", "order", "out")]
                + [(k, ctypes.c_int) for k in ("n", "light_geom", "do_vis",
                                               "do_next", "show_tex")]
                + [(k, ctypes.c_float) for k in ("emit_r", "emit_g",
                                                 "emit_b")])


class BounceArgs(ctypes.Structure):
    """Mirror of csrc/bounce.cu:BounceArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("inp", "out")]
                + [("n", ctypes.c_int)]
                + [(k, ctypes.c_uint) for k in ("fd", "lane0")]
                + [("p", ShadeParams)]
                + [(k, ctypes.c_int) for k in ("light_geom", "do_vis",
                                               "do_next")]
                + [(k, ctypes.c_float) for k in ("emit_r", "emit_g",
                                                 "emit_b")])


def _lit_radiance(ds, gi, p, light_geom, do_vis, emit):
    """The radiance planes of E's output p plus, on the NEE lanes that
    see the light, the NEE contribution times `emit`."""
    rad = [p[O_RR], p[O_RG], p[O_RB]]
    if do_vis:
        lit = light_visible(ds, gi, (p[O_SPX], p[O_SPY], p[O_SPZ]),
                            (p[O_SDX], p[O_SDY], p[O_SDZ]), light_geom,
                            p[O_NEE] > 0.5)
        # a select: cr can be inf or NaN on lanes without a shadow ray
        rad = [r + torch.where(lit, p[c] * e, 0.0)
               for r, c, e in zip(rad, (O_CR, O_CG, O_CB), emit)]
    return rad


def _next_hit(ds, gi, p):
    """The next closest hit of E's output p: the B_T .. B_NZ, B_MAT,
    B_ACT, B_UU, B_VV planes, and the hit material (int64)."""
    act = p[O_ACT]
    t, geom, nrm, uv, mat = closest_hit(ds, gi, (p[O_SPX], p[O_SPY], p[O_SPZ]),
                                        (p[O_DX], p[O_DY], p[O_DZ]),
                                        alive=act > 0.5)
    act2 = act * torch.where(geom >= 0, 1.0, 0.0)
    return (t, *nrm, mat.to(torch.float32), act2, *uv), mat


def _b_planes(p, rad, hit, shape):
    t, nx, ny, nz, matf, act, uu, vv = hit
    out = torch.stack([p[O_SPX], p[O_SPY], p[O_SPZ], p[O_DX], p[O_DY],
                       p[O_DZ], t, nx, ny, nz, p[O_TR], p[O_TG], p[O_TB],
                       *rad, matf, act, p[O_DIF], uu, vv])
    return out.reshape((N_BOUT,) + shape)


def trace_lanes_plain(ds, gi: GeomInfo, planes: torch.Tensor, *,
                      light_geom: int, do_vis: bool, do_next: bool,
                      emit: Sequence[float], show_tex: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """F's arithmetic on planes (25 or more, NB, 128) already in the
    lanes' sorted order (E's O_* planes, then nlo, nhi, slo, shi): the 21
    B_* planes and, when do_next, the (3, NB, 128) next albedo, else
    None; on the last depth the B_* planes but the radiance are
    constants."""
    shape = tuple(planes.shape[1:])
    p = planes.reshape(planes.shape[0], -1)
    rad = _lit_radiance(ds, gi, p, light_geom, do_vis, emit)
    if not do_next:
        act = p[O_ACT]
        one, zero = torch.ones_like(act), torch.zeros_like(act)
        out = _b_planes(p, rad, (one, zero, zero, one, zero, act, zero, zero),
                        shape)
        return out, None
    hit, mat = _next_hit(ds, gi, p)
    # the next albedo: the material color, or the texel on a live lane of
    # a textured material
    alb = [ds.mat_attr[mat, c] for c in range(3)]
    if show_tex:
        idx = torch.where(hit[5] > 0.5, tex_index(ds, mat, hit[6], hit[7]),
                          -1)
        alb = [torch.where(idx >= 0, x, a)
               for x, a in zip(texel_rgb(ds, idx), alb)]
    return (_b_planes(p, rad, hit, shape),
            torch.stack(alb).reshape((3,) + shape))


def trace_bounce_plain(ds, gi: GeomInfo, allp: torch.Tensor,
                       order: torch.Tensor, *,
                       out: Optional[torch.Tensor] = None, light_geom: int,
                       do_vis: bool, do_next: bool, emit: Sequence[float],
                       show_tex: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel F (see trace_bounce): the planes
    gathered into sorted order, trace_lanes_plain, then the next
    bounce's planes assembled or the radiance put to its pixels' rows."""
    shape = tuple(allp.shape[1:])
    p = allp.reshape(N_TIN, -1).index_select(1, order)
    b, alb = trace_lanes_plain(ds, gi, p, light_geom=light_geom,
                               do_vis=do_vis, do_next=do_next, emit=emit,
                               show_tex=show_tex)
    if do_next:
        res = torch.cat([b[0:10], alb, b[10:19],
                         p[R_PIX:R_PIX + 1]]).reshape((N_NEXT,) + shape)
    else:
        res = torch.empty((p.shape[1], 3), device=p.device)
        res[p[R_PIX].to(torch.int64)] = b[B_RR:B_RB + 1].T
    if out is None:
        return res
    return out.copy_(res)


def trace_bounce(ds, gi: GeomInfo, allp: torch.Tensor, order: torch.Tensor,
                 *, out: Optional[torch.Tensor] = None, light_geom: int,
                 do_vis: bool, do_next: bool, emit: Sequence[float],
                 show_tex: bool) -> torch.Tensor:
    """Trace one bounce of the sorted wavefront: allp (26, NB, 128)
    float32, the bounce's planes in the lanes' unsorted order (E's O_*
    planes, nlo, nhi, slo, shi, the pixel plane); order (N,) int64, the
    coherence sort's (sorted lane i is lane order[i]). do_vis: add the
    radiance of NEE lanes that see light geom `light_geom` (emit: its
    color times emittance); do_next: find the next closest hit and the
    next bounce's albedo; show_tex: textured materials take their nearest
    texel as albedo. Returns, when do_next, the next bounce's (23, NB,
    128) I_* planes and pixel plane in sorted order, else the (N, 3)
    radiance in pixel order, written into `out` where given (a new tensor
    else; the sorted wavefront passes the planes its E read). CPU tensors
    take the plain version; CUDA tensors launch kernel F."""
    _lib.require(allp.device, "trace_bounce")
    kw = dict(out=out, light_geom=light_geom, do_vis=do_vis,
              do_next=do_next, emit=emit, show_tex=show_tex)
    if allp.device.type == "cpu":
        return trace_bounce_plain(ds, gi, allp, order, **kw)
    return _trace_bounce_kernel(ds, gi, allp, order, **kw)


def _scene_build(gi: GeomInfo):
    """The library F and H launch from: the scene's own build
    (csrc/scene/bounce.cu) where it has one, else (None) the kernel
    library's (csrc/bounce.cu), for the scenes past its limits."""
    return (None if gi.path_scene is None
            else _lib.scene_kernels(gi.path_scene, "bounce"))


def _trace_bounce_kernel(ds, gi, allp, order, *, out=None, light_geom,
                         do_vis, do_next, emit, show_tex):
    shape = tuple(allp.shape[1:])
    _lib.check_tensor(allp, torch.float32, (N_TIN,) + shape, "allp")
    n = allp[0].numel()
    _lib.check_tensor(order, torch.int64, (n,), "order")
    out_shape = (N_NEXT,) + shape if do_next else (n, 3)
    if out is None:
        out = torch.empty(out_shape, dtype=torch.float32, device=allp.device)
    _lib.check_tensor(out, torch.float32, out_shape, "out")
    p = _lib.ptr
    args = TraceArgs(inp=p(allp), order=p(order), out=p(out), n=n,
                     light_geom=light_geom, do_vis=int(do_vis),
                     do_next=int(do_next), show_tex=int(show_tex),
                     emit_r=emit[0], emit_g=emit[1], emit_b=emit[2])
    _lib.launch(entry(gi, "ptdn_trace_bounce"),
                scene_dev(ds, gi, allp.device), args, lib=_scene_build(gi))
    trace_bounce.launches += 1
    return out


trace_bounce.launches = 0


def bounce_fused_plain(ds, gi: GeomInfo, planes: torch.Tensor, *, fd: int,
                       lane0: int, light_pos: Sequence[float], lrad: float,
                       sint: float, alb_skip: bool, shadow_ray: bool,
                       reduce_var: bool, light_geom: int, do_vis: bool,
                       do_next: bool, emit: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of kernel H (see bounce_fused): E's plain
    version with the lane index as the pixel plane, then F's visibility
    and next hit over every chunk."""
    shape = tuple(planes.shape[1:])
    lanes = torch.arange(planes[0].numel(), dtype=torch.float32,
                         device=planes.device).reshape((1,) + shape)
    p = shade_bounce_plain(
        torch.cat([planes, lanes]), ds.mat_attr, fd=fd, lane0=lane0,
        light_pos=light_pos, lrad=lrad, sint=sint, alb_skip=alb_skip,
        shadow_ray=shadow_ray, reduce_var=reduce_var).reshape(N_OUT, -1)
    rad = _lit_radiance(ds, gi, p, light_geom, do_vis, emit)
    if do_next:
        hit, _ = _next_hit(ds, gi, p)
    else:
        # the current intersection stays; uv is 0
        q = planes.reshape(N_IN, -1)
        zero = torch.zeros_like(q[I_T])
        hit = (q[I_T], q[I_NX], q[I_NY], q[I_NZ], q[I_MAT], p[O_ACT], zero,
               zero)
    return _b_planes(p, rad, hit, shape)


def bounce_fused(ds, gi: GeomInfo, planes: torch.Tensor, *, fd: int,
                 lane0: int, light_pos: Sequence[float], lrad: float,
                 sint: float, alb_skip: bool, shadow_ray: bool,
                 reduce_var: bool, light_geom: int, do_vis: bool,
                 do_next: bool, emit: Sequence[float]) -> torch.Tensor:
    """One whole bounce of the unsorted per-bounce engine: planes
    (22, NB, 128) float32 in the I_* layout, lanes in pixel order (lane i
    seeds its random stream with (i + lane0, fd)). fd is frame + depth;
    light_pos, lrad, sint, alb_skip, shadow_ray and reduce_var as in
    shade_bounce; light_geom, do_vis and emit as in trace_bounce; do_next:
    find the next closest hit (else keep the current one, uv 0). Returns
    the (21, NB, 128) B_* planes. CPU tensors take the plain version;
    CUDA tensors launch kernel H."""
    _lib.require(planes.device, "bounce_fused")
    kw = dict(fd=fd, lane0=lane0, light_pos=light_pos, lrad=lrad, sint=sint,
              alb_skip=alb_skip, shadow_ray=shadow_ray,
              reduce_var=reduce_var, light_geom=light_geom, do_vis=do_vis,
              do_next=do_next, emit=emit)
    if planes.device.type == "cpu":
        return bounce_fused_plain(ds, gi, planes, **kw)
    return _bounce_fused_kernel(ds, gi, planes, **kw)


def _bounce_fused_kernel(ds, gi, planes, *, fd, lane0, light_pos, lrad, sint,
                         alb_skip, shadow_ray, reduce_var, light_geom,
                         do_vis, do_next, emit):
    shape = tuple(planes.shape[1:])
    _lib.check_tensor(planes, torch.float32, (N_IN,) + shape, "planes")
    out = torch.empty((N_BOUT,) + shape, dtype=torch.float32,
                      device=planes.device)
    args = BounceArgs(
        inp=_lib.ptr(planes), out=_lib.ptr(out), n=out[0].numel(),
        fd=fd & 0xFFFFFFFF, lane0=lane0 & 0xFFFFFFFF,
        p=shade_params(ds.mat_attr, light_pos=light_pos, lrad=lrad,
                       sint=sint, alb_skip=alb_skip, shadow_ray=shadow_ray,
                       reduce_var=reduce_var),
        light_geom=light_geom, do_vis=int(do_vis), do_next=int(do_next),
        emit_r=emit[0], emit_g=emit[1], emit_b=emit[2])
    _lib.launch(entry(gi, "ptdn_bounce_fused"),
                scene_dev(ds, gi, planes.device), args, lib=_scene_build(gi))
    bounce_fused.launches += 1
    return out


bounce_fused.launches = 0
