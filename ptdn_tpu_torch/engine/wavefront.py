"""The path tracer of one frame: camera rays, the cached primary hit, the
G-buffer and the bounce loop.

This is the JAX package's make_trace_fn (engine/wavefront.py:895-1515)
on its four engines, chosen as there (:936-965, 1392-1476): the sorted
wavefront for scenes of more than four triangle chunks (or
`sort_rays=True`) while `fuse_bounce`; else the whole-path kernel while
`fuse_path` (the default on cornell, or `sort_rays=False` at any chunk
count); else the unsorted fused per-bounce engine while `fuse_bounce`;
else the split per-bounce engine. Kernel A gives the primary hit when
the camera changed; a static camera reuses it, with the camera rays and
the G-buffer position.

* Whole path (`whole_path`): one launch of kernel B1 walks every bounce
  of every pixel, one of kernel B2 rebuilds the radiance. Lane i is
  pixel i = x + y*W and seeds its random stream with (i, frame + depth),
  as the reference's initRand (pathtrace.cu:328).
* Sorted wavefront (`sorted`, bounce_sorted :1088-1187): the lanes
  carry 22 state planes and a pixel-id plane. Per bounce kernel E shades
  every lane; each lane's crossed-chunk ranges of its next and shadow ray
  give it a coherence key (ranges_and_key); a stable sort of the key
  reorders every plane (permute_planes, with kernel G's in-row permute
  first on scenes of at most 8 chunks); kernel F traces NEE visibility
  and the next closest hit over each lane's ranges and reads the next
  bounce's albedo (the texel where textured). The RNG follows the
  pixel plane, so the sort only reorders the whole-path engine's
  arithmetic; the radiance returns to pixel order at the end.
* Unsorted fused per-bounce engine (`bounce_fused`, `fuse_path=False`,
  bounce_fused :1045-1086): the same 22 planes in pixel order; per
  bounce one launch of kernel H shades, traces the NEE visibility and
  finds the next hit, then, below the last depth, kernel K reads every
  lane's texel on textured scenes (fetch_alb).
* Split per-bounce engine (`bounce_split`, `fuse_path=False,
  fuse_bounce=False`, the JAX engine bounce_pallas :1189-1282): per
  bounce kernel E shades, kernel I traces the shadow rays, and below the
  last depth kernel J (textured scenes, with K for the texels) or kernel
  A finds the next hit.

Left out of the sorted engine, as workarounds of the TPU: the
active-prefix ladder and the sub-batching past the gather cliff
(:777-864), which only reproduce the same stable order more cheaply
there; and the knobs PTDN_REGROUP, PTDN_SORT_EVERY, PTDN_SORT_KEY,
PTDN_JOINT and PTDN_GATHER_CLIFF, whose defaults the port takes: regroup
4 on at most 8 chunks and none above, a sort every bounce, the morton
key, and F's two chunk scans in place of the joint one. Not ported:
native mode (`compat=False`), NEE toward a mesh light, and the sorted
engine's `sort_group` and `sort_every`; each raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda.bounce import (B_MAT, B_UU, B_VV, bounce_fused,
                                            trace_bounce)
from ptdn_tpu_torch.ops.cuda.compact import sparse_gather
from ptdn_tpu_torch.ops.cuda.inrow import inrow_permute
from ptdn_tpu_torch.ops.cuda.path import deferred_radiance, path_trace
from ptdn_tpu_torch.ops.cuda.scene_intersect import (
    TCHUNK, geom_info, light_visibility, scene_intersect_full,
    scene_intersect_full_tex, tex_index, texel_rgb)
from ptdn_tpu_torch.ops.cuda.shade import (I_AB, I_AR, I_RB, I_RR, O_ACT,
                                           O_CB, O_CR, O_DIF, O_DX, O_DY,
                                           O_DZ, O_NEE, O_RB, O_RR, O_SDX,
                                           O_SDY, O_SDZ, O_SPX, O_SPY, O_SPZ,
                                           O_TB, O_TR, shade_bounce)
from ptdn_tpu_torch.ops.fp import dot3, fma, sqrt
from ptdn_tpu_torch.scene.parser import MESH
from ptdn_tpu_torch.scene.scene import DeviceScene

PCACHE_KEYS = ("t", "normal", "uv", "mat_id", "geom_id", "hit", "albedo")
SENTINEL = 1 << 30      # the sort key of a dead lane, past every live one
MAX_RANGE_SLABS = 64    # chunk AABB tests per ray before supergroups


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


# ---------------------------------------------------------------------------
# the sorted wavefront's glue (plain PyTorch, as it was XLA glue in JAX)

def chunk_range_planes(ds, o, d, n_chunks: int, t_limit=None):
    """Per lane the [lo, hi] chunk ids bounding every chunk AABB the ray
    o + t d crosses (t >= 0, and tmin <= t_limit where given), (n_chunks,
    -1) where it crosses none (wavefront.py:522-598). The slab is the
    kernels' own (subtract, then multiply by 1/d), so a chunk outside the
    range is one the kernels' per-lane cull skips. Past 64 chunks the test
    runs on supergroups of G = ceil(n / 64) consecutive chunks (their
    union AABBs) and the range rounds out to whole groups, still a
    superset. All chunks are tested at once as an (..., C) batch."""
    shape = torch.broadcast_shapes(o[0].shape, d[0].shape)
    dev = o[0].device
    inv = tuple(1.0 / c for c in d)

    def slab_ranges(bmin, bmax, count):
        if count == 0:
            return (torch.zeros(shape, dtype=torch.int32, device=dev),
                    torch.full(shape, -1, dtype=torch.int32, device=dev))
        t0 = [(bmin[:, k] - o[k][..., None]) * inv[k][..., None]
              for k in range(3)]
        t1 = [(bmax[:, k] - o[k][..., None]) * inv[k][..., None]
              for k in range(3)]
        tmin = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                           torch.minimum(t0[1], t1[1])),
                             torch.minimum(t0[2], t1[2]))
        tmax = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        crossed = (tmax >= 0.0) & (tmin <= tmax)
        if t_limit is not None:
            # a box entered beyond t_limit cannot occlude (shadow rays)
            crossed = crossed & (tmin <= t_limit[..., None])
        iota = torch.arange(count, dtype=torch.int32, device=dev)
        lo = torch.where(crossed, iota, count).amin(dim=-1)
        hi = torch.where(crossed, iota, -1).amax(dim=-1)
        return lo.to(torch.int32), hi.to(torch.int32)

    cmin = ds.tri_chunk_min[:n_chunks]
    cmax = ds.tri_chunk_max[:n_chunks]
    if n_chunks <= MAX_RANGE_SLABS:
        return slab_ranges(cmin, cmax, n_chunks)
    g = max(2, -(-n_chunks // MAX_RANGE_SLABS))
    n_super = -(-n_chunks // g)
    pad = n_super * g - n_chunks
    inf = torch.full((pad, 3), float("inf"), device=dev)
    smin = torch.cat([cmin, inf]).reshape(n_super, g, 3).amin(dim=1)
    smax = torch.cat([cmax, -inf]).reshape(n_super, g, 3).amax(dim=1)
    slo, shi = slab_ranges(smin, smax, n_super)
    lo = torch.clamp_max(slo * g, n_chunks)
    hi = torch.where(shi < 0, -1, torch.clamp_max(shi * g + (g - 1),
                                                  n_chunks - 1))
    return lo.to(torch.int32), hi.to(torch.int32)


def _interleave7(a, b, n_chunks: int):
    """Morton interleave of two chunk ids squeezed into 7 bits each (a
    monotone squeeze past 127 chunks, so the top of a large scene does
    not fold into one bucket): a's bits odd, b's even."""
    def to7(x):
        if n_chunks > 127:
            x = x * 127 // n_chunks
        return torch.clamp(x, 0, 127)[..., None]
    bit = torch.arange(7, dtype=torch.int32, device=a.device)
    # the bits never overlap, so their sum is their OR
    return ((((to7(a) >> bit) & 1) << (2 * bit + 1))
            + (((to7(b) >> bit) & 1) << (2 * bit))).sum(-1, dtype=torch.int32)


def ranges_and_key(ds, sh: torch.Tensor, pix: torch.Tensor, n_chunks: int,
                   do_vis: bool, light_pos=None, light_radius=None):
    """Crossed-chunk ranges and the coherence sort key of the shaded
    wavefront (wavefront.py:617-704). sh: E's (21, NB, 128) planes; pix:
    the (NB, 128) pixel plane. Returns (allp, key): allp (26, NB, 128) =
    sh, nlo, nhi, slo, shi (as float32), pix — F's input plus the pixel
    plane — and key (N,) int32. The shadow range is bounded by the
    distance to the light center plus `light_radius` (the light AABB's
    half diagonal); lanes without a shadow ray and dead lanes get empty
    ranges, and dead lanes the key SENTINEL so whole tiles go idle. With
    do_vis the key interleaves (nlo, slo) over (nhi, shi) (the morton
    key), else it is nlo * (C + 1) + nhi. The next and the shadow ray of
    a lane share their origin, so one batched pass finds both ranges (no
    limit is an infinite one)."""
    sp = (sh[O_SPX], sh[O_SPY], sh[O_SPZ])
    no_limit = torch.full_like(sp[0], float("inf"))
    s_limit = no_limit
    if light_pos is not None:
        e = tuple(light_pos[k] - sp[k] for k in range(3))
        s_limit = sqrt(dot3(e, e)) + light_radius
    d = tuple(sh[[a, b]] for a, b in ((O_DX, O_SDX), (O_DY, O_SDY),
                                      (O_DZ, O_SDZ)))
    lo, hi = chunk_range_planes(ds, sp, d, n_chunks,
                                t_limit=torch.stack([no_limit, s_limit]))
    # dead lanes and lanes without a shadow ray: empty ranges
    alive = sh[O_ACT] > 0.5
    keep = torch.stack([alive, alive & (sh[O_NEE] > 0.5)])
    lo = torch.where(keep, lo, n_chunks)
    hi = torch.where(keep, hi, -1)
    (nlo, slo), (nhi, shi) = lo, hi
    if do_vis:
        key = (_interleave7(nlo, slo, n_chunks) * 16384
               + _interleave7(torch.clamp_min(nhi, 0),
                              torch.clamp_min(shi, 0), n_chunks))
    else:
        key = nlo * (n_chunks + 1) + torch.clamp_min(nhi, 0)
    key = torch.where(keep[0], key, SENTINEL).to(torch.int32)
    ranges = torch.stack([nlo, nhi, slo, shi]).to(torch.float32)
    return torch.cat([sh, ranges, pix[None]]), key.reshape(-1)


def permute_planes(allp: torch.Tensor, key: torch.Tensor,
                   regroup: int = 0) -> torch.Tensor:
    """Reorder the lanes of allp (K, NB, 128) by a stable sort of `key`
    (N,) (wavefront.py:735-875), in one gather of every plane. With
    regroup G > 1: a stable in-row argsort of the key first, applied to
    every plane by kernel G, then the stable sort of each group of G
    lanes by its smallest key, moving G lanes at a time."""
    k, nb = allp.shape[0], allp.shape[1]
    n = nb * 128
    g = int(regroup) if regroup else 1
    if 128 % g:
        raise ValueError(f"regroup {g} must divide 128")
    if g > 1:
        key_s, order = torch.sort(key.reshape(nb, 128), dim=1, stable=True)
        allp = inrow_permute(allp, order.to(torch.int32))
        key = key_s.reshape(n // g, g).amin(dim=1)
    order = torch.sort(key, stable=True).indices
    if g > 1:
        order = (order[:, None] * g
                 + torch.arange(g, device=order.device)).reshape(n)
    return allp.reshape(k, n).index_select(1, order).reshape(k, nb, 128)


def static_light_radius(ds, light_geom: int) -> float:
    """Half the diagonal of the light geom's world AABB, the shadow-range
    margin of bounce_sorted (wavefront.py:1114-1116), as a float32
    value."""
    ext = (ds.geom_bb_max[light_geom] - ds.geom_bb_min[light_geom]).double()
    return float(np.float32(0.5 * float(torch.sqrt((ext * ext).sum()))))


class PathTracer(nn.Module):
    """Scene tensors as buffers, the primary-hit cache as buffers, and
    forward(cam, params, frame, cam_changed) -> (radiance (N, 3),
    gbuffer of (N, ...) tensors)."""

    def __init__(self, scene, cfg, resolution: Tuple[int, int], device):
        super().__init__()
        n_chunks = -(-scene.n_tris // TCHUNK)
        light_analytic = scene.geom_types[0] != MESH
        if not cfg.compat:
            raise NotImplementedError("native mode (compat=False) is not "
                                      "ported (ROADMAP Queue 1 item 9)")
        if cfg.shadow_ray and not light_analytic:
            raise NotImplementedError("NEE toward a mesh light is not ported")
        # the JAX package's engine choice (wavefront.py:936-965, 1392-1476)
        use_sort = (bool(cfg.sort_rays if cfg.sort_rays is not None
                         else n_chunks > 4) and cfg.fuse_bounce)
        if use_sort and (cfg.sort_group not in (None, 1)
                         or cfg.sort_every not in (None, 1)):
            raise NotImplementedError("sort_group and sort_every are not "
                                      "ported (ROADMAP Queue 1 item 12)")
        self.engine = ("sorted" if use_sort else "whole_path" if cfg.fuse_path
                       else "bounce_fused" if cfg.fuse_bounce
                       else "bounce_split")
        self.n_chunks = n_chunks
        self.regroup = int(cfg.sort_regroup if cfg.sort_regroup is not None
                           else (4 if n_chunks <= 8 else 0))
        self.w, self.h = resolution
        # the sorted planes hold whole 128-lane rows; the pixel and chunk
        # ids ride in float32 planes, exact below 2^24
        self.n_pad = -(-(self.w * self.h) // 128) * 128
        assert self.n_pad < 2 ** 24 and n_chunks < 2 ** 24
        self.depth = cfg.trace_depth
        ds = scene.device(device)
        for f in dataclasses.fields(DeviceScene):
            self.register_buffer(f.name, getattr(ds, f.name),
                                 persistent=False)
        for k, v in init_primary_cache(self.w * self.h, device).items():
            self.register_buffer(k, v)
        # the camera rays and the G-buffer position, functions of the
        # camera alone like the primary hit: made when the camera changed,
        # reused while it is still
        for k in ("ray_o", "ray_d", "position"):
            self.register_buffer(k, torch.zeros((self.w * self.h, 3),
                                                device=device),
                                 persistent=False)
        self.gi = geom_info(scene, device)
        # the reference samples geoms[0] for NEE (pathtrace.cu:360-361)
        light_mat = scene.materials[scene.geom_material_ids[0]]
        emit = (np.asarray(light_mat.color, np.float32)
                * np.float32(light_mat.emittance))
        self.light = {"geom": 0,
                      "pos": [float(x) for x in scene.geoms[0].translation],
                      "emit": [float(x) for x in emit],
                      "half_diag": static_light_radius(ds, 0)}
        # the same color as (3, 1, 1) planes, for the split engine's lit add
        self.register_buffer("emit_planes",
                             torch.from_numpy(emit).reshape(3, 1, 1).to(
                                 device), persistent=False)
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
        if cam_changed:
            # primary visibility is a function of the camera alone: a
            # static camera reuses last frame's rays, hit, albedo and
            # G-buffer position
            self.ray_o, self.ray_d = generate_camera_rays(cam,
                                                          (self.w, self.h))
            isect = scene_intersect_full(ds, self.gi, self.ray_o, self.ray_d)
            isect["albedo"] = albedo_from(ds, isect["mat_id"], isect["uv"],
                                          self.show_texture)
            for k in PCACHE_KEYS:
                setattr(self, "pcache_" + k, isect[k])
            self.position = fma(isect["t"][:, None], self.ray_d, self.ray_o)
        prim = {k: getattr(self, "pcache_" + k) for k in PCACHE_KEYS}
        light = dict(self.light, radius=float(params["light_radius"]),
                     intensity=float(params["shadow_intensity"]))
        prim_rays = dict(prim, o=self.ray_o, d=self.ray_d)
        radiance = getattr(self, "trace_" + self.engine)(ds, prim_rays,
                                                         light, int(frame))
        gbuffer = {
            "position": self.position,
            "normal": prim["normal"],
            "albedo": prim["albedo"],
            "ialbedo": torch.ones_like(prim["albedo"]),
            "geom_id": prim["geom_id"],
        }
        return radiance, gbuffer

    def trace_whole_path(self, ds, prim: Dict[str, torch.Tensor],
                         light: Dict, frame: int) -> torch.Tensor:
        """Every bounce of every pixel in one launch of kernel B1, the
        radiance rebuilt by kernel B2. Returns the radiance (N, 3)."""
        contrib, texidx = path_trace(ds, self.gi, prim, frame=frame, lane0=0,
                                     depth=self.depth, light=light,
                                     flags=self.flags)
        return deferred_radiance(ds, contrib, texidx, self.depth)

    def _lane_planes(self, prim: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The 22 I_* planes (22, NB, 128) of the primary hit, the carry
        of every per-bounce engine (wavefront.py:1447-1464); the padding
        lanes of the last row are dead from the start (hit False)."""
        n, n_pad = self.w * self.h, self.n_pad
        nb = n_pad // 128
        dev = prim["t"].device

        def plane(x, fill=0.0):
            x = x.to(torch.float32)
            if n_pad > n:
                x = torch.cat([x, torch.full((n_pad - n,), fill,
                                             device=dev)])
            return x.reshape(nb, 128)

        one = torch.ones(n, device=dev)
        zero = torch.zeros(n, device=dev)
        return torch.stack(
            [plane(prim["o"][:, k]) for k in range(3)]
            + [plane(prim["d"][:, k], 1.0 if k == 2 else 0.0)
               for k in range(3)]
            + [plane(prim["t"])]
            + [plane(prim["normal"][:, k]) for k in range(3)]
            + [plane(prim["albedo"][:, k]) for k in range(3)]
            + [plane(one)] * 3 + [plane(zero)] * 3
            + [plane(prim["mat_id"]), plane(prim["hit"]), plane(zero)])

    def _radiance(self, rad: torch.Tensor) -> torch.Tensor:
        """(N, 3) pixel radiance from the (3, NB, 128) radiance planes of
        lanes in pixel order."""
        return rad.reshape(3, -1)[:, :self.w * self.h].T.contiguous()

    def _albedo(self, ds, mat: torch.Tensor, idx=None) -> torch.Tensor:
        """The (3,) + mat.shape albedo of int64 materials `mat`: the
        material color, or where idx (int32 flat texel indices, -1
        untextured) is given and >= 0 the texel, read by kernel K."""
        if idx is None:
            return ds.mat_attr[:, 0:3].T[:, mat]
        return sparse_gather(ds.tex_flat_u32.view(torch.int32), idx,
                             mat.to(torch.int32), ds.mat_attr)

    def trace_bounce_fused(self, ds, prim: Dict[str, torch.Tensor],
                           light: Dict, frame: int) -> torch.Tensor:
        """The unsorted fused engine's depth loop from the primary hit
        (bounce_fused and its carry, wavefront.py:1045-1086, 1446-1498):
        per bounce kernel H, then below the last depth the next albedo of
        every lane, dead ones included, through kernel K on textured
        scenes (fetch_alb: albedo_from with sparse_cap); on the last the
        input albedo stays. Returns the radiance (N, 3)."""
        planes = self._lane_planes(prim)
        fl = self.flags
        for depth in range(1, self.depth + 1):
            do_next = depth < self.depth
            out = bounce_fused(
                ds, self.gi, planes, fd=frame + depth, lane0=0,
                light_pos=light["pos"], lrad=light["radius"],
                sint=light["intensity"],
                alb_skip=depth == 1 and fl["alb_skip1"],
                shadow_ray=fl["shadow_ray"], reduce_var=fl["reduce_var"],
                light_geom=light["geom"], do_vis=fl["do_vis"],
                do_next=do_next, emit=light["emit"])
            if do_next:
                mat = out[B_MAT].to(torch.int64)
                idx = (tex_index(ds, mat, out[B_UU], out[B_VV]).to(
                    torch.int32) if fl["show_tex"] else None)
                alb = self._albedo(ds, mat, idx)
            else:
                alb = planes[I_AR:I_AB + 1]
            planes = torch.cat([out[0:10], alb, out[10:19]])
        return self._radiance(planes[I_RR:I_RB + 1])

    def trace_bounce_split(self, ds, prim: Dict[str, torch.Tensor],
                           light: Dict, frame: int) -> torch.Tensor:
        """The unsorted split engine's depth loop from the primary hit
        (bounce_pallas and its carry, wavefront.py:1189-1282, 1470-1476):
        per bounce kernel E on the lanes in pixel order (an iota pixel
        plane gives lane_seed's streams), kernel I's visibility of the
        shadow rays with the lit add `radiance + where(nee & lit, c *
        emit, 0)`, and below the last depth the next hit: kernels J and K
        (texel indices, then the albedo of every lane) on textured
        scenes, else kernel A and the material color. Returns the
        radiance (N, 3)."""
        planes = self._lane_planes(prim)
        nb = self.n_pad // 128
        pix = torch.arange(self.n_pad, dtype=torch.float32,
                           device=planes.device).reshape(1, nb, 128)
        fl = self.flags

        def rays(sh, k):
            return sh[k:k + 3].reshape(3, -1).T
        for depth in range(1, self.depth + 1):
            sh = shade_bounce(
                torch.cat([planes, pix]), ds.mat_attr, fd=frame + depth,
                lane0=0, light_pos=light["pos"], lrad=light["radius"],
                sint=light["intensity"],
                alb_skip=depth == 1 and fl["alb_skip1"],
                shadow_ray=fl["shadow_ray"], reduce_var=fl["reduce_var"])
            rad = sh[O_RR:O_RB + 1]
            if fl["shadow_ray"]:
                vis = light_visibility(ds, self.gi, rays(sh, O_SPX),
                                       rays(sh, O_SDX), light["geom"])
                if fl["do_vis"]:
                    lit = (sh[O_NEE] > 0.5) & vis.reshape(nb, 128)
                    rad = rad + torch.where(
                        lit, sh[O_CR:O_CB + 1] * self.emit_planes, 0.0)
            if depth == self.depth:
                break
            if fl["show_tex"]:
                nxt, idx = scene_intersect_full_tex(ds, self.gi,
                                                    rays(sh, O_SPX),
                                                    rays(sh, O_DX))
            else:
                nxt = scene_intersect_full(ds, self.gi, rays(sh, O_SPX),
                                           rays(sh, O_DX))
                idx = None
            alb = self._albedo(ds, nxt["mat_id"].to(torch.int64), idx)
            act = sh[O_ACT] * nxt["hit"].reshape(nb, 128)
            planes = torch.cat([
                sh[O_SPX:O_SPZ + 1], sh[O_DX:O_DZ + 1],
                nxt["t"].reshape(1, nb, 128),
                nxt["normal"].T.reshape(3, nb, 128),
                alb.reshape(3, nb, 128), sh[O_TR:O_TB + 1], rad,
                nxt["mat_id"].to(torch.float32).reshape(1, nb, 128),
                act[None], sh[O_DIF:O_DIF + 1]])
        return self._radiance(rad)

    def trace_sorted(self, ds, prim: Dict[str, torch.Tensor], light: Dict,
                     frame: int) -> torch.Tensor:
        """The sorted wavefront's depth loop from the primary hit
        (bounce_sorted and its carry, wavefront.py:1088-1187, 1447-1494);
        returns the radiance (N, 3) in pixel order."""
        n, n_pad = self.w * self.h, self.n_pad
        nb = n_pad // 128
        dev = prim["t"].device
        planes = self._lane_planes(prim)
        pix = torch.arange(n_pad, dtype=torch.float32,
                           device=dev).reshape(nb, 128)
        fl = self.flags
        for depth in range(1, self.depth + 1):
            sh = shade_bounce(
                torch.cat([planes, pix[None]]), ds.mat_attr,
                fd=frame + depth, lane0=0, light_pos=light["pos"],
                lrad=light["radius"], sint=light["intensity"],
                alb_skip=depth == 1 and fl["alb_skip1"],
                shadow_ray=fl["shadow_ray"], reduce_var=fl["reduce_var"])
            allp, key = ranges_and_key(ds, sh, pix, self.n_chunks,
                                       fl["do_vis"], light["pos"],
                                       light["half_diag"])
            allp = permute_planes(allp, key, self.regroup)
            pix = allp[-1]
            do_next = depth < self.depth
            out, alb = trace_bounce(
                ds, self.gi, allp[:-1], light_geom=light["geom"],
                do_vis=fl["do_vis"], do_next=do_next, emit=light["emit"],
                show_tex=fl["show_tex"])
            # the last depth's albedo is never read (fetch_alb's else)
            planes = torch.cat([out[0:10], out[0:3] if alb is None else alb,
                                out[10:19]])
        # pixel ids are a permutation of 0..n_pad-1: scatter them back
        radiance = torch.empty((n_pad, 3), device=dev)
        radiance[pix.reshape(-1).to(torch.int64)] = (
            planes[16:19].reshape(3, n_pad).T)
        return radiance[:n]
