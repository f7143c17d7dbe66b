"""The path tracer of one frame in plain PyTorch: camera rays, the
primary hit, the G-buffer and the bounce loop.

A frozen copy of the port's plain versions (ptdn_tpu_torch/ops/cuda/
shade.py, bounce.py, path.py and engine/wavefront.py), which the
benchmark holds the program's frames to. Two engines, as the program
chooses them: the whole path (kernel B1's plain version, then B2's) for
scenes of at most four triangle chunks, and for the rest the per-bounce
shading (kernel E's plain version) and next hit (kernel F's) over the
lanes in pixel order. The program's sorted wavefront reorders the lanes
between the two by a key of their crossed chunks; the random stream
follows the pixel, and the plain next hit scans every chunk with the
per-lane cull, so the order changes no pixel's arithmetic and the
reference leaves it out.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.bsdf import shade
from perfbench.reference.camera import generate_camera_rays
from perfbench.reference.fp import fma
from perfbench.reference.intersect import (GeomInfo, TCHUNK, closest_hit,
                                           geom_info, light_visible,
                                           scene_intersect_full_plain,
                                           tex_index, texel_rgb)
from perfbench.reference.parser import MESH
from perfbench.reference.rng import init_rand


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


def _mask(b: torch.Tensor) -> torch.Tensor:
    return torch.where(b, 1.0, 0.0)


def shade_bounce_plain(planes: torch.Tensor, mat_attr: torch.Tensor, *,
                       fd: int, lane0: int, light_pos: Sequence[float],
                       lrad: float, sint: float, alb_skip: bool,
                       shadow_ray: bool, reduce_var: bool,
                       lights: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel E (see shade_bounce), `out` as
    there."""
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
              shadow_ray, reduce_var, lights)
    rad = tuple(p[k] + e for k, e in zip((I_RR, I_RG, I_RB), r["er"]))
    o = (*r["d"], *r["sp"], *r["tr"], *rad, _mask(r["dif"]),
         _mask(r["act"]), *r["sd"], *r["c"], _mask(r["nee"]))
    if lights is not None:
        o += (r["li"].to(torch.float32),)
    res = torch.stack(o).reshape((len(o),) + tuple(planes.shape[1:]))
    return res if out is None else out.copy_(res)


# the four range planes after E's output (bounce.py:231-233)
R_NLO, R_NHI, R_SLO, R_SHI = range(N_OUT, N_OUT + 4)


N_TIN = N_OUT + 4


# output plane indices (bounce.py:69-71)
(B_SPX, B_SPY, B_SPZ, B_DX, B_DY, B_DZ, B_T, B_NX, B_NY, B_NZ,
 B_TR, B_TG, B_TB, B_RR, B_RG, B_RB, B_MAT, B_ACT, B_DIF,
 B_UU, B_VV) = range(21)


N_BOUT = 21


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


def trace_bounce_plain(ds, gi: GeomInfo, planes: torch.Tensor, *,
                       light_geom: int, do_vis: bool, do_next: bool,
                       emit: Sequence[float], show_tex: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of kernel F (see trace_bounce)."""
    shape = tuple(planes.shape[1:])
    p = planes.reshape(N_TIN, -1)
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


def path_trace_plain(ds, gi: GeomInfo, prim: Dict[str, torch.Tensor], *,
                     frame: int, lane0: int, depth: int,
                     light: Dict, flags: Dict,
                     counts: Optional[Dict[str, int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1 (see path_trace). `counts`, where
    given, adds up the work kernel B1 does on these inputs: the lanes it
    shades (live at the start of a depth), the shadow rays it tests and
    the bounce rays it traces."""
    n = prim["t"].shape[0]
    dev = prim["t"].device
    col = lambda x: tuple(x[:, k] for k in range(x.shape[1]))  # noqa: E731
    one = torch.ones(n, device=dev)
    s = {"o": col(prim["o"]), "d": col(prim["d"]), "t": prim["t"],
         "n": col(prim["normal"]), "alb": col(prim["albedo"]),
         "mat": prim["mat_id"].to(torch.int64), "act": prim["hit"],
         "dif": torch.zeros(n, dtype=torch.bool, device=dev),
         "tr": (one, one, one)}
    pix = torch.arange(n, dtype=torch.int64, device=dev) + lane0
    contrib, tex = [], []
    zero = torch.zeros(n, device=dev)
    for dd in range(1, depth + 1):
        seed = init_rand(pix, torch.full_like(pix, frame + dd))
        r = shade(s, seed, ds.mat_attr, light["pos"], light["radius"],
                  light["intensity"], dd == 1 and flags["alb_skip1"],
                  flags["shadow_ray"], flags["reduce_var"])
        contrib += list(r["er"])
        if counts is not None:
            counts["shade"] += int(s["act"].sum())
            counts["nee"] += int(r["nee"].sum()) if flags["do_vis"] else 0
            counts["next"] += int(r["act"].sum()) if dd < depth else 0
        if flags["do_vis"]:
            lit = light_visible(ds, gi, r["sp"], r["sd"], light["geom"],
                                r["nee"], static=True)
            contrib += [torch.where(lit, c * e, 0.0)
                        for c, e in zip(r["c"], light["emit"])]
        else:
            contrib += [zero, zero, zero]
        if dd == depth:
            break
        t, geom, nrm, uv, mat = closest_hit(ds, gi, r["sp"], r["d"],
                                            alive=r["act"], static=True)
        act = r["act"] & (geom >= 0)
        alb = tuple(ds.mat_attr[mat, k] for k in range(3))
        tidx = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if flags["show_tex"]:
            tidx = torch.where(act, tex_index(ds, mat, uv[0], uv[1]), -1)
            alb = tuple(torch.where(tidx >= 0, 1.0, a) for a in alb)
        tex.append(tidx.to(torch.int32))
        s = {"o": r["sp"], "d": r["d"], "t": t, "n": nrm, "alb": alb,
             "mat": mat, "act": act, "dif": r["dif"], "tr": r["tr"]}
    texidx = (torch.stack(tex) if tex else
              torch.empty((0, n), dtype=torch.int32, device=dev))
    return torch.stack(contrib), texidx


def deferred_radiance_plain(ds, contrib: torch.Tensor, texidx: torch.Tensor,
                            depth: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (see deferred_radiance)."""
    n = contrib.shape[1]
    if depth > 1:
        textured = texidx >= 0
        ratio = [torch.where(textured, c, 1.0)
                 for c in texel_rgb(ds, texidx.to(torch.int64))]
    one = torch.ones(n, device=contrib.device)
    cum = [one, one, one]
    rad = [torch.zeros(n, device=contrib.device) for _ in range(3)]
    for d in range(1, depth + 1):
        base = 6 * (d - 1)
        for c in range(3):
            rad[c] = rad[c] + contrib[base + c] * cum[c]
        if d >= 2:
            for c in range(3):
                cum[c] = cum[c] * ratio[c][d - 2]
        for c in range(3):
            rad[c] = rad[c] + contrib[base + 3 + c] * cum[c]
    return torch.stack(rad, dim=-1)


PCACHE_KEYS = ("t", "normal", "uv", "mat_id", "geom_id", "hit", "albedo")


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


def static_light_radius(ds, light_geom: int) -> float:
    """Half the diagonal of the light geom's world AABB, the shadow-range
    margin of bounce_sorted (wavefront.py:1114-1116), as a float32
    value."""
    ext = (ds.geom_bb_max[light_geom] - ds.geom_bb_min[light_geom]).double()
    return float(np.float32(0.5 * float(torch.sqrt((ext * ext).sum()))))
