"""The path tracer of one frame: camera rays, the cached primary hit, the
G-buffer, the whole-path kernel and the deferred radiance.

This is the JAX package's make_trace_fn (engine/wavefront.py:895-1445) on
the branch its default configuration takes for scenes of at most four
triangle chunks (`use_path`): one launch of kernel A for the primary hit
when the camera changed, one of kernel B1 for every bounce of every
pixel, one of kernel B2 for the radiance. Lane i is pixel i = x + y*W and
seeds its random stream with (i, frame + depth), as the reference's
initRand (pathtrace.cu:328).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda.path import deferred_radiance, path_trace
from ptdn_tpu_torch.ops.fp import fma
from ptdn_tpu_torch.ops.cuda.scene_intersect import (geom_info,
                                                     scene_intersect_full,
                                                     tex_index, texel_rgb)
from ptdn_tpu_torch.scene.parser import MESH
from ptdn_tpu_torch.scene.scene import DeviceScene

PCACHE_KEYS = ("t", "normal", "uv", "mat_id", "geom_id", "hit", "albedo")
MAX_PATH_CHUNKS = 4


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


def init_primary_cache(n: int, device) -> Dict[str, torch.Tensor]:
    f = dict(dtype=torch.float32, device=device)
    return {
        "pcache_t": torch.zeros(n, **f),
        "pcache_normal": torch.zeros((n, 3), **f),
        "pcache_uv": torch.zeros((n, 2), **f),
        "pcache_mat_id": torch.zeros(n, dtype=torch.int32, device=device),
        "pcache_geom_id": torch.full((n,), -1, dtype=torch.int32,
                                     device=device),
        "pcache_hit": torch.zeros(n, dtype=torch.bool, device=device),
        "pcache_albedo": torch.zeros((n, 3), **f),
    }


class PathTracer(nn.Module):
    """Scene tensors as buffers, the primary-hit cache as buffers, and
    forward(cam, params, frame, cam_changed) -> (radiance (N, 3),
    gbuffer of (N, ...) tensors)."""

    def __init__(self, scene, cfg, resolution: Tuple[int, int], device):
        super().__init__()
        n_chunks = -(-scene.n_tris // 128)
        use_sort = (cfg.sort_rays if cfg.sort_rays is not None
                    else n_chunks > MAX_PATH_CHUNKS)
        light_analytic = scene.geom_types[0] != MESH
        if not cfg.fuse_path or use_sort or n_chunks > MAX_PATH_CHUNKS:
            raise NotImplementedError(
                "only the whole-path pipeline for scenes of at most "
                f"{MAX_PATH_CHUNKS} triangle chunks is ported")
        if cfg.shadow_ray and not light_analytic:
            raise NotImplementedError("NEE toward a mesh light is not ported")
        if not cfg.compat:
            raise NotImplementedError("native mode (compat=False) is not "
                                      "ported")
        self.w, self.h = resolution
        self.depth = cfg.trace_depth
        ds = scene.device(device)
        for f in dataclasses.fields(DeviceScene):
            self.register_buffer(f.name, getattr(ds, f.name),
                                 persistent=False)
        for k, v in init_primary_cache(self.w * self.h, device).items():
            self.register_buffer(k, v)
        self.gi = geom_info(scene, device)
        # the reference samples geoms[0] for NEE (pathtrace.cu:360-361)
        light_mat = scene.materials[scene.geom_material_ids[0]]
        emit = (np.asarray(light_mat.color, np.float32)
                * np.float32(light_mat.emittance))
        self.light = {"geom": 0,
                      "pos": [float(x) for x in scene.geoms[0].translation],
                      "emit": [float(x) for x in emit]}
        self.show_texture = cfg.show_texture and len(scene.textures) > 0
        self.flags = {
            "shadow_ray": cfg.shadow_ray, "reduce_var": cfg.reduce_var,
            "do_vis": (cfg.shadow_ray and light_analytic
                       and float(light_mat.emittance) > 0.0),
            "alb_skip1": cfg.sep_color and cfg.denoise_enable,
            "show_tex": self.show_texture}

    @property
    def ds(self) -> DeviceScene:
        return DeviceScene(**{f.name: getattr(self, f.name)
                              for f in dataclasses.fields(DeviceScene)})

    def forward(self, cam: Dict[str, torch.Tensor], params, frame: int,
                cam_changed: bool):
        ds = self.ds
        origin, direction = generate_camera_rays(cam, (self.w, self.h))
        if cam_changed:
            # primary visibility is a function of the camera alone: a
            # static camera reuses last frame's hit and albedo
            isect = scene_intersect_full(ds, self.gi, origin, direction)
            isect["albedo"] = albedo_from(ds, isect["mat_id"], isect["uv"],
                                          self.show_texture)
            for k in PCACHE_KEYS:
                setattr(self, "pcache_" + k, isect[k])
        prim = {k: getattr(self, "pcache_" + k) for k in PCACHE_KEYS}
        light = dict(self.light, radius=float(params["light_radius"]),
                     intensity=float(params["shadow_intensity"]))
        contrib, texidx = path_trace(
            ds, self.gi, dict(prim, o=origin, d=direction), frame=int(frame),
            lane0=0, depth=self.depth, light=light, flags=self.flags)
        radiance = deferred_radiance(ds, contrib, texidx, self.depth)
        gbuffer = {
            "position": fma(prim["t"][:, None], direction, origin),
            "normal": prim["normal"],
            "albedo": prim["albedo"],
            "ialbedo": torch.ones_like(prim["albedo"]),
            "geom_id": prim["geom_id"],
        }
        return radiance, gbuffer
