"""Kernel F (trace_bounce): NEE visibility, the lit radiance add, the
next closest hit and the next albedo of the sorted wavefront's bounce
(csrc/bounce.cu), with its plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/bounce.py:trace_bounce_pallas
(its joint next + shadow chunk scan, scene_intersect.py:joint_mesh_tiles)
and the albedo fetch after it (engine/wavefront.py:fetch_alb), whose
texel route back to the lanes is the TPU kernel
ptdn_tpu/ops/pallas/path.py:uncompact_tiles_pallas. Input: kernel E's 21
O_* planes followed by the crossed-chunk range planes nlo, nhi, slo, shi
(engine/wavefront.py:ranges_and_key); output: the 21 planes of the B_*
layout and, when do_next, the (3, NB, 128) albedo of the next bounce.
The kernel bounds each lane's chunk scans by its own ranges; the plain
version scans every chunk with the per-lane cull, which visits the same
chunks (csrc/bounce.cu says why), so the two compute one function. The
TPU kernel's tile-wide texel compaction is dropped: a GPU thread reads
its own texel at no such cost.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.scene_intersect import (GeomInfo, closest_hit,
                                                     light_visible, scene_dev,
                                                     tex_index, texel_rgb)
from ptdn_tpu_torch.ops.cuda.shade import (N_OUT, O_ACT, O_CB, O_CG, O_CR,
                                           O_DIF, O_DX, O_DY, O_DZ, O_NEE,
                                           O_RB, O_RG, O_RR, O_SDX, O_SDY,
                                           O_SDZ, O_SPX, O_SPY, O_SPZ, O_TB,
                                           O_TG, O_TR)

# the four range planes after E's output (bounce.py:231-233)
R_NLO, R_NHI, R_SLO, R_SHI = range(N_OUT, N_OUT + 4)
N_TIN = N_OUT + 4
# output plane indices (bounce.py:69-71)
(B_SPX, B_SPY, B_SPZ, B_DX, B_DY, B_DZ, B_T, B_NX, B_NY, B_NZ,
 B_TR, B_TG, B_TB, B_RR, B_RG, B_RB, B_MAT, B_ACT, B_DIF,
 B_UU, B_VV) = range(21)
N_BOUT = 21


class TraceArgs(ctypes.Structure):
    """Mirror of csrc/bounce.cu:TraceArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("inp", "out", "alb")]
                + [(k, ctypes.c_int) for k in ("n", "light_geom", "do_vis",
                                               "do_next", "show_tex")]
                + [(k, ctypes.c_float) for k in ("emit_r", "emit_g",
                                                 "emit_b")])


def trace_bounce_plain(ds, gi: GeomInfo, planes: torch.Tensor, *,
                       light_geom: int, do_vis: bool, do_next: bool,
                       emit: Sequence[float], show_tex: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of kernel F (see trace_bounce)."""
    p = planes.reshape(N_TIN, -1)
    sp = (p[O_SPX], p[O_SPY], p[O_SPZ])
    d = (p[O_DX], p[O_DY], p[O_DZ])
    act = p[O_ACT]
    rad = [p[O_RR], p[O_RG], p[O_RB]]
    if do_vis:
        lit = light_visible(ds, gi, sp, (p[O_SDX], p[O_SDY], p[O_SDZ]),
                            light_geom, p[O_NEE] > 0.5)
        # a select: cr can be inf or NaN on lanes without a shadow ray
        rad = [r + torch.where(lit, p[c] * e, 0.0)
               for r, c, e in zip(rad, (O_CR, O_CG, O_CB), emit)]
    alb = None
    if do_next:
        t, geom, nrm, uv, mat = closest_hit(ds, gi, sp, d, alive=act > 0.5)
        act2 = act * torch.where(geom >= 0, 1.0, 0.0)
        hit = (t, *nrm, mat.to(torch.float32), act2, *uv)
        # the next albedo: the material color, or the texel on a live
        # lane of a textured material
        alb = [ds.mat_attr[mat, c] for c in range(3)]
        if show_tex:
            idx = torch.where(act2 > 0.5, tex_index(ds, mat, uv[0], uv[1]),
                              -1)
            alb = [torch.where(idx >= 0, x, a)
                   for x, a in zip(texel_rgb(ds, idx), alb)]
    else:
        one, zero = torch.ones_like(act), torch.zeros_like(act)
        hit = (one, zero, zero, one, zero, act, zero, zero)
    t, nx, ny, nz, matf, act_out, uu, vv = hit
    out = torch.stack([*sp, *d, t, nx, ny, nz, p[O_TR], p[O_TG], p[O_TB],
                       *rad, matf, act_out, p[O_DIF], uu, vv])
    shape = tuple(planes.shape[1:])
    return (out.reshape((N_BOUT,) + shape),
            None if alb is None else torch.stack(alb).reshape((3,) + shape))


def trace_bounce(ds, gi: GeomInfo, planes: torch.Tensor, *, light_geom: int,
                 do_vis: bool, do_next: bool, emit: Sequence[float],
                 show_tex: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Trace one bounce of the sorted wavefront: planes (25, NB, 128)
    float32 (E's O_* planes, then nlo, nhi, slo, shi). do_vis: add the
    radiance of NEE lanes that see light geom `light_geom` (emit: its
    color times emittance); do_next: find the next closest hit and the
    next bounce's albedo (else the last depth's constant planes);
    show_tex: textured materials take their nearest texel as albedo.
    Returns the (21, NB, 128) B_* planes and, when do_next, the
    (3, NB, 128) next albedo, else None. CPU tensors take the plain
    version; CUDA tensors launch kernel F."""
    _lib.require(planes.device, "trace_bounce")
    kw = dict(light_geom=light_geom, do_vis=do_vis, do_next=do_next,
              emit=emit, show_tex=show_tex)
    if planes.device.type == "cpu":
        return trace_bounce_plain(ds, gi, planes, **kw)
    return _trace_bounce_kernel(ds, gi, planes, **kw)


def _trace_bounce_kernel(ds, gi, planes, *, light_geom, do_vis, do_next,
                         emit, show_tex):
    shape = tuple(planes.shape[1:])
    _lib.check_tensor(planes, torch.float32, (N_TIN,) + shape, "planes")
    dev = planes.device
    out = torch.empty((N_BOUT,) + shape, dtype=torch.float32, device=dev)
    alb = (torch.empty((3,) + shape, dtype=torch.float32, device=dev)
           if do_next else None)
    p = _lib.ptr
    args = TraceArgs(inp=p(planes), out=p(out), alb=p(alb), n=out[0].numel(),
                     light_geom=light_geom, do_vis=int(do_vis),
                     do_next=int(do_next), show_tex=int(show_tex),
                     emit_r=emit[0], emit_g=emit[1], emit_b=emit[2])
    _lib.launch("ptdn_trace_bounce", scene_dev(ds, gi, dev), args)
    trace_bounce.launches += 1
    return out, alb


trace_bounce.launches = 0
