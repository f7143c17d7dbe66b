"""Kernels B1 (path_trace) and B2 (deferred_radiance), with their plain
PyTorch versions.

B1 (csrc/path_trace.cuh) replaces the TPU kernel ptdn_tpu/ops/pallas/
path.py: path_trace_fused_pallas in two builds of one body: built once per
scene with the scene's baked rows as constants (csrc/scene/path_trace.cu,
_lib.build_scene), and, for the scenes past that build's limits
(GeomInfo.path_scene is None: more than B1_MAX_GEOMS geoms or B1_MAX_MATS
materials, or a constant that is not finite), the table build, which
reads the same rows from device memory (csrc/path_trace_table.cu, in the
kernel library; its launches count in path_trace.table_launches). B2
(csrc/path.cu) replaces uncompact_tiles_pallas with the gather of
engine/wavefront.py:packed_texel_gather and deferred_radiance. The whole
depth loop runs with the texture modulation of depths >= 2 deferred: B1
walks every path with albedo 1.0 on textured lanes and emits per depth
the emissive and NEE contributions plus the flat texel index the albedo
multiply would have sampled; B2 gathers those texels and rebuilds the
radiance with a running product of per-depth ratios (path.py:23-41):

    cum = 1; rad = 0
    for d in 1..D:
        rad += cE_d * cum          # emissive uses pre-albedo throughput
        if d >= 2: cum *= ratio_d  # depth-1 albedo is exact in-kernel
        rad += cN_d * cum          # NEE uses post-albedo throughput

The texel indices are plain per lane ((D-1, N) int32, -1 untextured):
the TPU kernel compacted them per 4096-lane tile only because TPU gathers
are count-bound, which a GPU's are not.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ptdn_tpu_torch.ops.bsdf import shade
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.scene_intersect import (GeomInfo, closest_hit,
                                                     entry, light_visible,
                                                     scene_dev, tex_index,
                                                     texel_rgb)
from ptdn_tpu_torch.ops.rng import init_rand


class PathArgs(ctypes.Structure):
    """Mirror of csrc/path_trace.cuh:PathArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "o", "d", "t", "nrm", "alb", "mat", "act", "contrib", "texidx")]
        + [(k, ctypes.c_int) for k in ("n", "depth")]
        + [(k, ctypes.c_uint) for k in ("frame", "lane0")]
        + [(k, ctypes.c_int) for k in (
            "light_geom", "shadow_ray", "reduce_var", "do_vis", "alb_skip1",
            "show_tex")]
        + [(k, ctypes.c_float) for k in (
            "light_x", "light_y", "light_z", "lrad", "sint", "emit_r",
            "emit_g", "emit_b")])


def path_trace_plain(ds, gi: GeomInfo, prim: Dict[str, torch.Tensor], *,
                     frame: int, lane0: int, depth: int,
                     light: Dict, flags: Dict) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain PyTorch version of kernel B1 (see path_trace)."""
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


def path_trace(ds, gi: GeomInfo, prim: Dict[str, torch.Tensor], *,
               frame: int, lane0: int, depth: int, light: Dict,
               flags: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole bounce loop from the primary hit.

    prim: o, d (N, 3) primary rays; t (N,), normal (N, 3), albedo (N, 3),
    mat_id (N,) int32, hit (N,) bool from the primary hit. light: geom
    (int), pos (3 floats), radius, intensity, emit (3 floats: color x
    emittance). flags: shadow_ray, reduce_var, do_vis, alb_skip1,
    show_tex. Returns contrib (6*depth, N) f32 — per depth d the
    emissive rgb then the lit NEE rgb — and texidx (depth-1, N) int32.
    CPU tensors take the plain version; CUDA tensors launch kernel B1, its
    per-scene build where the scene has one (gi.path_scene), else its
    table build."""
    _lib.require(prim["t"].device, "path_trace")
    if prim["t"].device.type == "cpu":
        return path_trace_plain(ds, gi, prim, frame=frame, lane0=lane0,
                                depth=depth, light=light, flags=flags)
    return _path_trace_kernel(ds, gi, prim, frame, lane0, depth, light,
                              flags)


def _path_trace_kernel(ds, gi, prim, frame, lane0, depth, light, flags):
    n = prim["t"].shape[0]
    for k, dt, shape in (("o", torch.float32, (n, 3)),
                         ("d", torch.float32, (n, 3)),
                         ("t", torch.float32, (n,)),
                         ("normal", torch.float32, (n, 3)),
                         ("albedo", torch.float32, (n, 3)),
                         ("mat_id", torch.int32, (n,)),
                         ("hit", torch.bool, (n,))):
        _lib.check_tensor(prim[k], dt, shape, k)
    dev = prim["t"].device
    contrib = torch.empty((6 * depth, n), dtype=torch.float32, device=dev)
    texidx = torch.empty((depth - 1, n), dtype=torch.int32, device=dev)
    p = _lib.ptr
    args = PathArgs(
        o=p(prim["o"]), d=p(prim["d"]), t=p(prim["t"]),
        nrm=p(prim["normal"]), alb=p(prim["albedo"]), mat=p(prim["mat_id"]),
        act=p(prim["hit"]), contrib=p(contrib), texidx=p(texidx), n=n,
        depth=depth, frame=frame, lane0=lane0, light_geom=light["geom"],
        **{k: int(bool(flags[k])) for k in ("shadow_ray", "reduce_var",
                                            "do_vis", "alb_skip1",
                                            "show_tex")},
        light_x=light["pos"][0], light_y=light["pos"][1],
        light_z=light["pos"][2], lrad=light["radius"],
        sint=light["intensity"], emit_r=light["emit"][0],
        emit_g=light["emit"][1], emit_b=light["emit"][2])
    if gi.path_scene is None:
        _lib.launch(entry(gi, "ptdn_path_trace_table"),
                    scene_dev(ds, gi, dev), args)
        path_trace.table_launches += 1
    else:
        _lib.launch("ptdn_path_trace", scene_dev(ds, gi, dev), args,
                    lib=_lib.scene_kernels(gi.path_scene))
        path_trace.launches += 1
    return contrib, texidx


path_trace.launches = 0         # the per-scene build's
path_trace.table_launches = 0   # the table build's


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


def deferred_radiance(ds, contrib: torch.Tensor, texidx: torch.Tensor,
                      depth: int) -> torch.Tensor:
    """Radiance (N, 3) from B1's per-depth contributions and texel
    indices. CPU tensors take the plain version; CUDA tensors launch
    kernel B2."""
    _lib.require(contrib.device, "deferred_radiance")
    if contrib.device.type == "cpu":
        return deferred_radiance_plain(ds, contrib, texidx, depth)
    return _deferred_radiance_kernel(ds, contrib, texidx, depth)


def _deferred_radiance_kernel(ds, contrib, texidx, depth):
    n = contrib.shape[1]
    _lib.check_tensor(contrib, torch.float32, (6 * depth, n), "contrib")
    _lib.check_tensor(texidx, torch.int32, (depth - 1, n), "texidx")
    rad = torch.empty((n, 3), dtype=torch.float32, device=contrib.device)
    p = _lib.ptr
    _lib.launch("ptdn_deferred_radiance", p(contrib), p(texidx),
                p(ds.tex_flat_u32), ctypes.c_int(n), ctypes.c_int(depth),
                p(rad))
    deferred_radiance.launches += 1
    return rad


deferred_radiance.launches = 0
