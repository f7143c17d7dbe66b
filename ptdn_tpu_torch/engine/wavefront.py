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
  give it a coherence key (ranges_and_key, kernel Q); a stable sort of
  the key reorders every plane (permute_planes, with kernel G's in-row permute
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

With `shadow_ray` on, two cases take the split engine whatever
fuse_path, fuse_bounce and sort_rays say, as in the JAX package
(:935-971): a mesh light at geom 0, and native mode (`compat=False`)
with more than one emissive geom. Their shadow test is the full closest
hit, kernel A, compared with the target geom (make_light_visibility,
:457-478): geom 0, or in native mode the light each NEE lane drew from
kernel E's light table (the JAX oracle bounce, :1321-1345: the selection
draw before the disk sample, the contribution weighted by the light's
color and the light count). Native mode's true barycentric mesh normals
are a constant of the kernels' builds (GeomInfo.compat).

Left out of the sorted engine, as workarounds of the TPU: the
active-prefix ladder and the sub-batching past the gather cliff
(:777-864), which only reproduce the same stable order more cheaply
there; and the knobs PTDN_REGROUP, PTDN_SORT_EVERY, PTDN_SORT_KEY,
PTDN_JOINT and PTDN_GATHER_CLIFF, whose defaults the port takes: regroup
4 on at most 8 chunks and none above, a sort every bounce, the morton
key, and F's two chunk scans in place of the joint one. Not ported: the
sorted engine's `sort_group` and `sort_every`, which raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda.bounce import (B_MAT, B_UU, B_VV, bounce_fused,
                                            trace_bounce)
from ptdn_tpu_torch.ops.cuda.compact import sparse_gather
from ptdn_tpu_torch.ops.cuda.inrow import inrow_permute
from ptdn_tpu_torch.ops.cuda.path import deferred_radiance, path_trace
# the sorted wavefront's range and key glue, kernel Q: the tests call it
# under these names
from ptdn_tpu_torch.ops.cuda.ranges import (  # noqa: F401
    N_ALLP, SENTINEL, chunk_range_planes, range_boxes, ranges_and_key)
from ptdn_tpu_torch.ops.cuda.scene_intersect import (
    TCHUNK, geom_info, light_visibility, scene_intersect_full,
    scene_intersect_full_tex, tex_index, texel_rgb)
from ptdn_tpu_torch.ops.cuda.shade import (I_AB, I_AR, I_RB, I_RR, O_ACT,
                                           O_CB, O_CR, O_DIF, O_DX, O_DZ,
                                           O_LI, O_NEE, O_RB, O_RR, O_SDX,
                                           O_SPX, O_SPZ, O_TB, O_TR, N_OUT,
                                           light_table, shade_bounce)
from ptdn_tpu_torch.ops.fp import fma
from ptdn_tpu_torch.scene.parser import MESH
from ptdn_tpu_torch.scene.scene import DeviceScene
from ptdn_tpu_torch.utils.stats import span

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
    gbuffer of (N, ...) tensors).

    A shard of a taller image (parallel/sharded.py) traces rows [row0,
    row0 + h) of a `full_height`-row image: its camera rays are those
    rows' and its lanes seed their random streams from lane0 = row0 * W
    (the JAX tracer's row0, wavefront.py:994-1013), so that each pixel
    draws the single-device stream. Shards of one process pass the first
    shard's tracer as `shared`: its scene tensors, per-scene tables and
    builds serve them all."""

    def __init__(self, scene, cfg, resolution: Tuple[int, int], device,
                 row0: int = 0, full_height: Optional[int] = None,
                 shared: Optional["PathTracer"] = None):
        super().__init__()
        n_chunks = -(-scene.n_tris // TCHUNK)
        light_analytic = scene.geom_types[0] != MESH
        # native mode's uniform selection among the scene's lights
        # (wavefront.py:956-970)
        self.multi_light = ((not cfg.compat) and cfg.shadow_ray
                            and len(scene.lights) > 1)
        # the shadow test is the full closest hit (kernel A) where the
        # light is a mesh or drawn per lane (make_light_visibility)
        self.shadow_closest = cfg.shadow_ray and (self.multi_light
                                                  or not light_analytic)
        # the JAX package's engine choice (wavefront.py:936-971, 1392-1476):
        # the fused engines and the whole path need an analytic light and
        # one light, else the split engine
        use_sort = (bool(cfg.sort_rays if cfg.sort_rays is not None
                         else n_chunks > 4) and cfg.fuse_bounce
                    and not self.shadow_closest)
        if use_sort and (cfg.sort_group not in (None, 1)
                         or cfg.sort_every not in (None, 1)):
            raise NotImplementedError("sort_group and sort_every are not "
                                      "ported (ROADMAP Queue 1 item 6: do "
                                      "not port)")
        self.engine = ("bounce_split" if self.shadow_closest
                       else "sorted" if use_sort
                       else "whole_path" if cfg.fuse_path
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
        self.row0 = int(row0)
        self.full_height = full_height
        # the first pixel's global index x + y*W, a uint32 as in JAX
        self.lane0 = (self.row0 * self.w) & 0xFFFFFFFF
        ds = scene.device(device)
        for f in dataclasses.fields(DeviceScene):
            self.register_buffer(f.name, getattr(ds, f.name),
                                 persistent=False)
        if self.engine == "sorted":
            # kernel Q's chunk boxes (the supergroups' past 64 chunks),
            # made once per scene
            self.register_buffer("range_boxes",
                                 shared.range_boxes if shared is not None
                                 else range_boxes(ds, n_chunks),
                                 persistent=False)
        for k, v in init_primary_cache(self.w * self.h, device).items():
            self.register_buffer(k, v)
        # the camera rays and the G-buffer position, functions of the
        # camera alone like the primary hit: made when the camera changed,
        # reused while it is still; not frame state, so remade from the
        # camera after a restored state (rays_stale)
        for k in ("ray_o", "ray_d", "position"):
            self.register_buffer(k, torch.zeros((self.w * self.h, 3),
                                                device=device),
                                 persistent=False)
        self.rays_stale = True
        self.gi = (shared.gi if shared is not None
                   else geom_info(scene, device, cfg.compat))
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
        self.light_emissive = float(light_mat.emittance) > 0.0
        if self.multi_light:
            # kernel E's light table and each light's geom, the target of
            # its lanes' shadow test
            table = (shared.light_rows if shared is not None
                     else light_table(scene, device))
            self.register_buffer("light_rows", table, persistent=False)
            self.register_buffer("light_geoms", table[:, 6].to(torch.int32),
                                 persistent=False)
        self.show_texture = cfg.show_texture and len(scene.textures) > 0
        self.flags = {
            "shadow_ray": cfg.shadow_ray, "reduce_var": cfg.reduce_var,
            "do_vis": (cfg.shadow_ray and light_analytic
                       and self.light_emissive),
            "alb_skip1": cfg.sep_color and cfg.denoise_enable,
            "show_tex": self.show_texture}

    @property
    def ds(self) -> DeviceScene:
        return DeviceScene(**{f.name: getattr(self, f.name)
                              for f in dataclasses.fields(DeviceScene)})

    def forward(self, cam: Dict[str, torch.Tensor], params, frame: int,
                cam_changed: bool):
        ds = self.ds
        # primary visibility is a function of the camera alone: a static
        # camera reuses last frame's rays, hit, albedo and G-buffer
        # position; a restored state brings the hit without the rays
        if cam_changed or self.rays_stale:
            with span("ptdn.tracer.camera"):
                self.ray_o, self.ray_d = generate_camera_rays(
                    cam, (self.w, self.h), self.row0, self.full_height)
                if cam_changed:
                    isect = scene_intersect_full(ds, self.gi, self.ray_o,
                                                 self.ray_d)
                    isect["albedo"] = albedo_from(ds, isect["mat_id"],
                                                  isect["uv"],
                                                  self.show_texture)
                    for k in PCACHE_KEYS:
                        setattr(self, "pcache_" + k, isect[k])
                self.position = fma(self.pcache_t[:, None], self.ray_d,
                                    self.ray_o)
                self.rays_stale = False
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
        contrib, texidx = path_trace(ds, self.gi, prim, frame=frame,
                                     lane0=self.lane0,
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
            with span("ptdn.tracer.shade"):
                out = bounce_fused(
                    ds, self.gi, planes, fd=frame + depth,
                    lane0=self.lane0, light_pos=light["pos"],
                    lrad=light["radius"], sint=light["intensity"],
                    alb_skip=depth == 1 and fl["alb_skip1"],
                    shadow_ray=fl["shadow_ray"],
                    reduce_var=fl["reduce_var"], light_geom=light["geom"],
                    do_vis=fl["do_vis"], do_next=do_next,
                    emit=light["emit"])
            with span("ptdn.tracer.next_hit"):
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
        scenes, else kernel A and the material color. A mesh light's
        shadow test is kernel A's closest hit on geom 0 (make_light_
        visibility); native multi-light NEE draws each lane's light from
        E's light table, tests A's closest hit against that light's geom
        and adds E's weighted contribution as it is (the oracle bounce,
        :1321-1345). The lit add is gated by the light's emittance.
        Returns the radiance (N, 3)."""
        planes = self._lane_planes(prim)
        nb = self.n_pad // 128
        pix = torch.arange(self.n_pad, dtype=torch.float32,
                           device=planes.device).reshape(1, nb, 128)
        fl = self.flags

        def rays(sh, k):
            return sh[k:k + 3].reshape(3, -1).T
        lights = self.light_rows if self.multi_light else None
        for depth in range(1, self.depth + 1):
            with span("ptdn.tracer.shade"):
                sh = shade_bounce(
                    torch.cat([planes, pix]), ds.mat_attr, fd=frame + depth,
                    lane0=self.lane0, light_pos=light["pos"],
                    lrad=light["radius"], sint=light["intensity"],
                    alb_skip=depth == 1 and fl["alb_skip1"],
                    shadow_ray=fl["shadow_ray"],
                    reduce_var=fl["reduce_var"], lights=lights)
            rad = sh[O_RR:O_RB + 1]
            if fl["shadow_ray"]:
                with span("ptdn.tracer.visibility"):
                    c = sh[O_CR:O_CB + 1]
                    if self.shadow_closest:
                        hit = scene_intersect_full(
                            ds, self.gi, rays(sh, O_SPX),
                            rays(sh, O_SDX))["geom_id"]
                        target = (self.light_geoms[sh[O_LI].to(torch.int64)]
                                  if self.multi_light else light["geom"])
                        vis = hit.reshape(nb, 128) == target
                    else:
                        vis = light_visibility(
                            ds, self.gi, rays(sh, O_SPX), rays(sh, O_SDX),
                            light["geom"]).reshape(nb, 128)
                    if not self.multi_light:
                        c = c * self.emit_planes
                    if self.multi_light or self.light_emissive:
                        lit = (sh[O_NEE] > 0.5) & vis
                        rad = rad + torch.where(lit, c, 0.0)
            if depth == self.depth:
                break
            with span("ptdn.tracer.next_hit"):
                if fl["show_tex"]:
                    nxt, idx = scene_intersect_full_tex(
                        ds, self.gi, rays(sh, O_SPX), rays(sh, O_DX))
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
            with span("ptdn.tracer.shade"):
                # E writes its planes into the bounce's allp, Q the rest
                allp = torch.empty((N_ALLP, nb, 128), device=dev)
                shade_bounce(
                    torch.cat([planes, pix[None]]), ds.mat_attr,
                    fd=frame + depth, lane0=self.lane0,
                    light_pos=light["pos"], lrad=light["radius"],
                    sint=light["intensity"],
                    alb_skip=depth == 1 and fl["alb_skip1"],
                    shadow_ray=fl["shadow_ray"],
                    reduce_var=fl["reduce_var"], out=allp[:N_OUT])
            with span("ptdn.tracer.ranges"):
                allp, key = ranges_and_key(ds, allp, pix, self.n_chunks,
                                           fl["do_vis"], light["pos"],
                                           light["half_diag"],
                                           boxes=self.range_boxes)
            with span("ptdn.tracer.permute"):
                allp = permute_planes(allp, key, self.regroup)
            pix = allp[-1]
            do_next = depth < self.depth
            with span("ptdn.tracer.bounce"):
                out, alb = trace_bounce(
                    ds, self.gi, allp[:-1], light_geom=light["geom"],
                    do_vis=fl["do_vis"], do_next=do_next,
                    emit=light["emit"], show_tex=fl["show_tex"])
                # the last depth's albedo is never read (fetch_alb's else)
                planes = torch.cat([out[0:10],
                                    out[0:3] if alb is None else alb,
                                    out[10:19]])
        # pixel ids are a permutation of 0..n_pad-1: scatter them back
        radiance = torch.empty((n_pad, 3), device=dev)
        radiance[pix.reshape(-1).to(torch.int64)] = (
            planes[16:19].reshape(3, n_pad).T)
        return radiance[:n]
