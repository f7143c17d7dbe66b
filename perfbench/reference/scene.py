"""Scene assembly: parsed .txt -> host arrays -> DeviceScene tensors.

Mirrors the reference's load pipeline (Scene::Scene, src/scene.cpp:9-46):
parse materials/objects/camera, load OBJ meshes with world-space
pre-transform (scene.cpp:266-296: positions by `transform`, normals by
`invTranspose`, stored UN-normalized), accumulate per-mesh world AABBs,
assign global triangle ids, build the single global SAH BVH (which
reorders triangles into leaf order, scene.cpp:40-44), then scan emissive
geoms into the light list (scene.cpp:313-324).

Device layout: every device-side array is a float32/int32 torch tensor
in a `DeviceScene` dataclass, field for field and layout for layout the
JAX package's pytree, on the device the caller names. Geometry counts,
types and triangle ranges stay host-side.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import parser as P
from perfbench.reference.bvh import build_bvh
from perfbench.reference.objloader import load_obj
from perfbench.reference import math3d
from perfbench.reference.image_io import load_image_rgb

F = np.float32


@dataclasses.dataclass
class DeviceScene:
    """All per-scene device tensors."""
    # geoms (G)
    geom_translation: object    # (G, 3) f32
    geom_transform: object      # (G, 4, 4) f32
    geom_inverse: object        # (G, 4, 4) f32
    geom_inv_transpose: object  # (G, 4, 4) f32
    # materials (M)
    mat_color: object           # (M, 3) f32
    mat_spec_color: object      # (M, 3) f32
    mat_spec_exponent: object   # (M,) f32
    mat_reflective: object      # (M,) f32
    mat_refractive: object      # (M,) f32
    mat_ior: object             # (M,) f32
    mat_emittance: object       # (M,) f32
    mat_texid: object           # (M,) i32 (-1 = untextured)
    # triangles (T, world space, BVH leaf order)
    tri_v: object               # (T, 3, 3) f32 vertices
    tri_n: object               # (T, 3, 3) f32 per-vertex normals (unnormalized)
    tri_uv: object              # (T, 3, 2) f32
    tri_geom: object            # (T,) i32 owner geom index
    tri_mat: object             # (T,) i32 owner material id
    # flattened BVH (N nodes)
    bvh_min: object             # (N, 3) f32
    bvh_max: object             # (N, 3) f32
    bvh_count: object           # (N,) i32  (>0 leaf)
    bvh_axis: object            # (N,) i32
    bvh_prim_off: object        # (N,) i32
    bvh_right: object           # (N,) i32
    # per-mesh world AABBs (B)
    mesh_bb_min: object         # (B, 3) f32
    mesh_bb_max: object         # (B, 3) f32
    # per-geom world AABBs (unit cube corners through the transform,
    # slightly padded)
    geom_bb_min: object         # (G, 3) f32
    geom_bb_max: object         # (G, 3) f32
    # texture atlas (K textures padded to a common size)
    tex_atlas: object           # (K, Hmax, Wmax, 3) f32, raw 0..255 values
    tex_flat_u32: object        # (K*Hmax*Wmax,) u32 — texels byte-packed
                                # r | g<<8 | b<<16, one word per texel
    tex_wh: object              # (K, 2) i32 (w, h)
    # rows [0, C): 128-tri chunk AABBs (the kernels' per-ray chunk cull);
    # rows [C + 4c + s]: sub-chunk AABBs over tris [128c+32s,
    # 128c+32s+32), the JAX package's second level. Empty sub ranges get
    # inverted boxes (min=+3e37 > max=-3e37) that no ray crosses.
    tri_chunk_min: object       # (5C, 3) f32
    tri_chunk_max: object       # (5C, 3) f32
    # Moller-Trumbore rows (v0.xyz, e1.xyz, e2.xyz, 0,0,0) per triangle
    tri_moller: object          # (Tp, 12) f32
    # packed per-triangle attributes, one row per winning triangle:
    # v0,v1,v2 (9), n0,n1,n2 (9), uv0,uv1,uv2 (6), geom (1), mat (1),
    # pad (6)
    tri_attr: object            # (Tp, 32) f32
    # the same attributes transposed per chunk (row c*32+ch holds channel
    # ch of chunk c's 128 triangles), the JAX package's TPU layout
    tri_attr_t: object          # (C*32, 128) f32
    # packed material table: color (0:3), spec_color (3:6), spec_ex (6),
    # refl (7), refr (8), ior (9), emittance (10), texid (11), pad (4)
    mat_attr: object            # (M, 16) f32


@dataclasses.dataclass
class HostGeom:
    type: int
    material_id: int
    translation: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    transform: np.ndarray
    inverse: np.ndarray
    inv_transpose: np.ndarray


@dataclasses.dataclass
class Light:
    """Emissive-geom light entry (Scene::loadLight, scene.cpp:313-324)."""
    type: str
    geom_idx: int
    mat_idx: int


class Scene:
    """Host-side scene: parsing, mesh/texture load, BVH build, upload."""

    def __init__(self, path: str):
        parsed = P.parse_scene(path)
        self.camera = parsed.camera
        self.resolution: Tuple[int, int] = parsed.camera.resolution
        self.image_name: str = parsed.camera.image_name or "render"

        # ---- materials + textures ----
        self.materials = parsed.materials
        self.textures: List[np.ndarray] = []
        for m in self.materials:
            if m.texture_file is not None:
                tex_path = os.path.join(parsed.scene_dir, "Textures", m.texture_file)
                m.texid = len(self.textures)
                self.textures.append(load_image_rgb(tex_path))

        # ---- geoms + meshes (world-space pre-transform) ----
        self.geoms: List[HostGeom] = []
        tri_v, tri_n, tri_uv, tri_geom, tri_mat = [], [], [], [], []
        self.mesh_bb_min: List[np.ndarray] = []
        self.mesh_bb_max: List[np.ndarray] = []
        for gi, g in enumerate(parsed.geoms):
            tf = math3d.build_transformation_matrix(g.translation, g.rotation, g.scale)
            hg = HostGeom(
                type=g.type, material_id=g.material_id,
                translation=g.translation, rotation=g.rotation, scale=g.scale,
                transform=tf, inverse=np.linalg.inv(tf.astype(np.float64)).astype(F),
                inv_transpose=math3d.inverse_transpose(tf),
            )
            if g.type == P.MESH:
                mesh = load_obj(os.path.join(parsed.scene_dir, "Models", g.obj_file))
                v, nrm, uv = self._world_triangles(mesh, tf, hg.inv_transpose)
                tri_v.append(v); tri_n.append(nrm); tri_uv.append(uv)
                tri_geom.append(np.full(v.shape[0], gi, np.int32))
                tri_mat.append(np.full(v.shape[0], g.material_id, np.int32))
                self.mesh_bb_min.append(v.reshape(-1, 3).min(axis=0))
                self.mesh_bb_max.append(v.reshape(-1, 3).max(axis=0))
            self.geoms.append(hg)

        if tri_v:
            self.tri_v = np.concatenate(tri_v, axis=0)
            self.tri_n = np.concatenate(tri_n, axis=0)
            self.tri_uv = np.concatenate(tri_uv, axis=0)
            self.tri_geom = np.concatenate(tri_geom, axis=0)
            self.tri_mat = np.concatenate(tri_mat, axis=0)
        else:
            self.tri_v = np.zeros((0, 3, 3), F)
            self.tri_n = np.zeros((0, 3, 3), F)
            self.tri_uv = np.zeros((0, 3, 2), F)
            self.tri_geom = np.zeros(0, np.int32)
            self.tri_mat = np.zeros(0, np.int32)
        self.n_tris = int(self.tri_v.shape[0])

        # ---- global BVH over all triangles; reorder tris to leaf order ----
        if self.n_tris > 0:
            bmin = self.tri_v.min(axis=1)
            bmax = self.tri_v.max(axis=1)
            self.bvh, order = build_bvh(bmin, bmax)
            self.tri_v = self.tri_v[order]
            self.tri_n = self.tri_n[order]
            self.tri_uv = self.tri_uv[order]
            self.tri_geom = self.tri_geom[order]
            self.tri_mat = self.tri_mat[order]
        else:
            self.bvh = build_bvh(np.zeros((0, 3), F), np.zeros((0, 3), F))[0]

        # ---- lights (every emissive geom, in geom order; AREALIGHT only) ----
        self.lights: List[Light] = [
            Light(type="AREALIGHT", geom_idx=i, mat_idx=hg.material_id)
            for i, hg in enumerate(self.geoms)
            if self.materials[hg.material_id].emittance > 0
        ]

        self._device: Dict[str, DeviceScene] = {}

    @staticmethod
    def _world_triangles(mesh, transform, inv_transpose):
        """Pre-transform triangles to world space (scene.cpp:266-296)."""
        ntri = mesh.pos_idx.shape[0]
        v = mesh.positions[mesh.pos_idx.reshape(-1)].reshape(ntri, 3, 3)
        ones = np.ones((ntri, 3, 1), F)
        vh = np.concatenate([v, ones], axis=-1)            # (T,3,4)
        vw = np.einsum("ij,tkj->tki", transform, vh)[..., :3].astype(F)

        if mesh.normals.shape[0] > 0 and (mesh.nrm_idx >= 0).all():
            nobj = mesh.normals[mesh.nrm_idx.reshape(-1)].reshape(ntri, 3, 3)
            nh = np.concatenate([nobj, np.zeros((ntri, 3, 1), F)], axis=-1)
            nw = np.einsum("ij,tkj->tki", inv_transpose, nh)[..., :3].astype(F)
        else:
            # OBJ without normals: geometric face normal (the reference
            # leaves these uninitialized — we pick the sane definition)
            e1 = vw[:, 1] - vw[:, 0]
            e2 = vw[:, 2] - vw[:, 0]
            fn = np.cross(e1, e2)
            fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            nw = np.repeat(fn[:, None, :], 3, axis=1).astype(F)

        if mesh.texcoords.shape[0] > 0 and (mesh.uv_idx >= 0).all():
            uv = mesh.texcoords[mesh.uv_idx.reshape(-1)].reshape(ntri, 3, 2).astype(F)
        else:
            uv = np.zeros((ntri, 3, 2), F)
        return vw, nw, uv

    # ------------------------------------------------------------------
    def device(self, device) -> DeviceScene:
        """Upload (lazily, once per device) and return the DeviceScene."""
        key = str(torch.device(device))
        if key not in self._device:
            self._device[key] = self._build_device(torch.device(device))
        return self._device[key]

    def _build_device(self, device: torch.device) -> DeviceScene:
        geoms = self.geoms
        mats = self.materials

        def pad1(x, dt=F):
            """Ensure at least one row so gathers stay well-defined."""
            x = np.asarray(x, dt)
            if x.shape[0] == 0:
                x = np.zeros((1,) + x.shape[1:], dt)
            return x

        def pad_mult(x, dt=F, mult=128):
            """Pad rows to a multiple of `mult` so chunked dynamic slices
            never clamp (TPU-aligned; padding rows are degenerate)."""
            x = pad1(x, dt)
            n = x.shape[0]
            target = -(-n // mult) * mult
            if target != n:
                x = np.concatenate(
                    [x, np.zeros((target - n,) + x.shape[1:], dt)], axis=0)
            return x

        # texture atlas: pad to common size
        if self.textures:
            hm = max(t.shape[0] for t in self.textures)
            wm = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), hm, wm, 3), F)
            wh = np.zeros((len(self.textures), 2), np.int32)
            for k, t in enumerate(self.textures):
                atlas[k, : t.shape[0], : t.shape[1]] = t.astype(F)
                wh[k] = (t.shape[1], t.shape[0])
        else:
            atlas = np.zeros((1, 1, 1, 3), F)
            wh = np.ones((1, 2), np.int32)

        tv = pad_mult(self.tri_v)                     # (Tp, 3, 3)
        tp = tv.shape[0]
        v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
        e1, e2 = v1 - v0, v2 - v0
        n_chunks = tp // 128
        # chunk AABBs over REAL triangles only (padding rows excluded)
        cmin = np.full((5 * n_chunks, 3), np.inf, F)
        cmax = np.full((5 * n_chunks, 3), -np.inf, F)
        for c in range(n_chunks):
            lo, hi = c * 128, min((c + 1) * 128, self.n_tris)
            if lo < hi:
                cmin[c] = self.tri_v[lo:hi].reshape(-1, 3).min(axis=0)
                cmax[c] = self.tri_v[lo:hi].reshape(-1, 3).max(axis=0)
            else:
                cmin[c] = 0.0
                cmax[c] = 0.0
            # sub-chunk AABBs (32-tri quarters); empty -> inverted box
            for s in range(4):
                slo = c * 128 + s * 32
                shi = min(slo + 32, self.n_tris)
                r = n_chunks + 4 * c + s
                if slo < shi:
                    cmin[r] = self.tri_v[slo:shi].reshape(-1, 3).min(axis=0)
                    cmax[r] = self.tri_v[slo:shi].reshape(-1, 3).max(axis=0)
                else:
                    cmin[r] = 3e37
                    cmax[r] = -3e37

        # per-geom world AABBs: unit cube corners through each transform
        corners = np.array([[x, y, z, 1.0] for x in (-0.5, 0.5)
                            for y in (-0.5, 0.5) for z in (-0.5, 0.5)], F)
        gb_min, gb_max = [], []
        for g in geoms:
            wc = (corners @ g.transform.T)[:, :3]
            gb_min.append(wc.min(axis=0) - 1e-3)
            gb_max.append(wc.max(axis=0) + 1e-3)

        def j(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        bvh = self.bvh
        return DeviceScene(
            geom_translation=j(pad1([g.translation for g in geoms])),
            geom_transform=j(pad1([g.transform for g in geoms])),
            geom_inverse=j(pad1([g.inverse for g in geoms])),
            geom_inv_transpose=j(pad1([g.inv_transpose for g in geoms])),
            mat_color=j(pad1([m.color for m in mats])),
            mat_spec_color=j(pad1([m.specular_color for m in mats])),
            mat_spec_exponent=j(pad1([m.specular_exponent for m in mats])),
            mat_reflective=j(pad1([m.has_reflective for m in mats])),
            mat_refractive=j(pad1([m.has_refractive for m in mats])),
            mat_ior=j(pad1([m.index_of_refraction for m in mats])),
            mat_emittance=j(pad1([m.emittance for m in mats])),
            mat_texid=j(pad1([m.texid for m in mats], np.int32)),
            tri_v=j(pad_mult(self.tri_v)),
            tri_n=j(pad_mult(self.tri_n)),
            tri_uv=j(pad_mult(self.tri_uv)),
            tri_geom=j(pad_mult(self.tri_geom, np.int32)),
            tri_mat=j(pad_mult(self.tri_mat, np.int32)),
            bvh_min=j(pad1(bvh.bounds_min)),
            bvh_max=j(pad1(bvh.bounds_max)),
            bvh_count=j(pad1(bvh.prim_count, np.int32)),
            bvh_axis=j(pad1(bvh.axis, np.int32)),
            bvh_prim_off=j(pad1(bvh.prim_offset, np.int32)),
            bvh_right=j(pad1(bvh.right_child, np.int32)),
            mesh_bb_min=j(pad1(self.mesh_bb_min)),
            mesh_bb_max=j(pad1(self.mesh_bb_max)),
            geom_bb_min=j(pad1(gb_min)),
            geom_bb_max=j(pad1(gb_max)),
            tex_atlas=j(atlas),
            tex_flat_u32=j((atlas[..., 0].astype(np.uint32)
                            + (atlas[..., 1].astype(np.uint32) << 8)
                            + (atlas[..., 2].astype(np.uint32) << 16)
                            ).reshape(-1)),
            tex_wh=j(wh),
            tri_chunk_min=j(np.nan_to_num(cmin)),
            tri_chunk_max=j(np.nan_to_num(cmax)),
            tri_moller=j(np.concatenate(
                [v0, e1, e2, np.zeros_like(v0)], axis=1).astype(F)),
            mat_attr=j(np.concatenate([
                pad1([m.color for m in mats]),
                pad1([m.specular_color for m in mats]),
                pad1([m.specular_exponent for m in mats])[:, None],
                pad1([m.has_reflective for m in mats])[:, None],
                pad1([m.has_refractive for m in mats])[:, None],
                pad1([m.index_of_refraction for m in mats])[:, None],
                pad1([m.emittance for m in mats])[:, None],
                pad1([m.texid for m in mats], np.int32).astype(F)[:, None],
                np.zeros((max(len(mats), 1), 4), F)], axis=1).astype(F)),
            tri_attr=j(np.concatenate([
                tv.reshape(tp, 9),
                pad_mult(self.tri_n).reshape(tp, 9),
                pad_mult(self.tri_uv).reshape(tp, 6),
                pad_mult(self.tri_geom, np.int32).astype(F)[:, None],
                pad_mult(self.tri_mat, np.int32).astype(F)[:, None],
                np.zeros((tp, 6), F)], axis=1).astype(F)),
            tri_attr_t=j(np.ascontiguousarray(
                np.concatenate([
                    tv.reshape(tp, 9),
                    pad_mult(self.tri_n).reshape(tp, 9),
                    pad_mult(self.tri_uv).reshape(tp, 6),
                    pad_mult(self.tri_geom, np.int32).astype(F)[:, None],
                    np.zeros((tp, 7), F)], axis=1)
                .reshape(tp // 128, 128, 32).transpose(0, 2, 1)
                .reshape(tp // 128 * 32, 128))),
        )

    # static metadata used to build traced programs
    @property
    def geom_types(self) -> Tuple[int, ...]:
        return tuple(g.type for g in self.geoms)

    @property
    def geom_material_ids(self) -> Tuple[int, ...]:
        return tuple(g.material_id for g in self.geoms)
