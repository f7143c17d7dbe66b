"""Kernels A (the fully resolved closest hit), J (the same with each
ray's texel index), I (NEE visibility) and M (the unmerged analytic and
mesh bests) (csrc/scene_intersect.cu), their plain PyTorch versions, and
the scene-level hit and visibility code the other kernels' plain versions
share.

They replace the TPU kernels ptdn_tpu/ops/pallas/scene_intersect.py:
scene_intersect_full_pallas (A), scene_intersect_full_tex_pallas (J,
without its per-row compaction of the texel indices: kernel K reads each
lane's texel), light_visibility_pallas (I) and scene_intersect_pallas
(M). All four run a block of 128 rays on one chunk scan
(csrc/chunk_scan.cuh: A, J and M the closest-hit query alone,
csrc/closest_hit.cuh, M without the refine and the merge; I the any-hit
query alone, csrc/light_visibility.cuh), built per scene where the scene
has a header (csrc/scene/scene_intersect.cu) and in the kernel library
otherwise. What bounds them and
what their design does about that is in the source note of
csrc/scene_intersect.cu. All versions visit the
analytic geoms in scene order and the triangles chunk by chunk in
ascending index, with strict < throughout, so ties go to the first geom
and the lowest triangle; a chunk whose AABB a ray does not cross before
its running best is skipped.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.intersect import (FLT_MAX, FMA_X, FMA_Y, MUL_X,
                                          MUL_Y, MUL_Z, TWO, TWO_B,
                                          aabb_slab, baked_row_form,
                                          box_intersect, interpolate_tri_hit,
                                          moller, ray_triangle,
                                          sphere_intersect)
from ptdn_tpu_torch.scene.parser import CUBE, MESH

TCHUNK = 128
COLORDIVIDOR = 0.003921568627   # utilities.h:24


class GeomInfo(NamedTuple):
    """Static geometry of a scene: per-geom types on the host, an int32
    (G, 2) table of (type, material) on the device, the triangle count,
    the header kernels B1, F, H, A, J, I and M are built with for this
    scene (path_scene_header), None where the scene exceeds its limits,
    and on the device the tables B1's table build reads (table_rows): per
    geom its head and its baked rows' forms, (G, 16) int32, and its world
    box and row coefficients, (G, 17, 4) float32."""
    types: Tuple[int, ...]
    table: torch.Tensor
    n_tris: int
    path_scene: Optional[str]
    row_code: torch.Tensor
    row_coef: torch.Tensor


# the limits of the per-scene builds (kernels B1, F, H, A, J, I and M):
# their geom loops unroll over the geoms, and B1's material table lives
# in the 64 KB constant bank. A scene past them takes B1's table build
# (csrc/path_trace_table.cu) and the other kernels' builds in the kernel
# library (csrc/bounce.cu, csrc/scene_intersect.cu).
B1_MAX_GEOMS = 64
B1_MAX_MATS = 1024


def _c_floats(xs) -> str:
    """Finite float32 values as exact C hex-float literals."""
    return ", ".join(float(np.float32(x)).hex() + "f" for x in xs)


def baked_rows(scene):
    """Per geom the forms (ops/intersect.py:baked_row_form) of its five
    kinds of baked rows, three each (the inverse with and without bias,
    the transform with and without bias, the inverse transpose): codes
    (G * 15,) int32 and (c0, c1, c2, c3) coefficients (G * 15, 4)
    float32, geom-major, then kind, then row."""
    codes, coefs = [], []
    for g in scene.geoms:
        for m, bias in ((g.inverse, True), (g.inverse, False),
                        (g.transform, True), (g.transform, False),
                        (g.inv_transpose, False)):
            m32 = np.asarray(m, np.float32)
            for r in range(3):
                code, c = baked_row_form(m32[r], bias)
                codes.append(code)
                coefs.append(c)
    return (np.asarray(codes, np.int32).reshape(-1),
            np.asarray(coefs, np.float32).reshape(-1, 4))


def path_scene_header(scene, mat_attr: np.ndarray, codes: np.ndarray,
                      coefs: np.ndarray, mats) -> Optional[str]:
    """scene.h of the kernels built for this scene (csrc/scene/*.cu: B1,
    F, H, A and J): the geom count, each geom's type and material, the
    forms of its baked rows as codes and coefficients (baked_rows), for
    B1, the (M, 16) material table `mat_attr`, and `mats`, the scene's
    float32 (G, 4, 4) inverse, transform and inverse-transpose matrices,
    for the others. None if the scene has more than B1_MAX_GEOMS geoms or
    B1_MAX_MATS materials, or a constant that is not finite: B1's table
    build and the others' library builds take such a scene."""
    mats = [np.asarray(m, np.float32) for m in mats]
    if (len(scene.geoms) > B1_MAX_GEOMS or mat_attr.shape[0] > B1_MAX_MATS
            or not np.isfinite(mat_attr).all()
            or not np.isfinite(coefs).all()
            or not all(np.isfinite(m).all() for m in mats)):
        return None
    n_g = len(scene.geoms)
    return "\n".join([
        "// The per-scene kernels' constants, generated by",
        "// ptdn_tpu_torch/ops/cuda/scene_intersect.py:path_scene_header",
        "#pragma once",
        "namespace scene {",
        f"constexpr int kGeoms = {n_g};",
        "__device__ constexpr int kType[] = {"
        + ", ".join(str(g.type) for g in scene.geoms) + "};",
        "__device__ constexpr int kMat[] = {"
        + ", ".join(str(g.material_id) for g in scene.geoms) + "};",
        "__device__ constexpr int kCode[] = {"
        + ", ".join(str(c) for c in codes) + "};",
        "__device__ constexpr float kCoef[][4] = {"
        + ", ".join("{" + _c_floats(c) + "}" for c in coefs) + "};",
        "__constant__ float kMatAttr[] = {"
        + _c_floats(np.asarray(mat_attr, np.float32).reshape(-1)) + "};",
        *(f"__device__ constexpr float {key}[][16] = {{"
          + ", ".join("{" + _c_floats(m[g].reshape(-1)) + "}"
                      for g in range(n_g)) + "};"
          for key, m in zip(("kInvM", "kTfM", "kInvTM"), mats)),
        "}  // namespace scene", ""])


# B1's table build (csrc/path_trace_table.cu): the path in a geom's head
# word (its low 2 bits) and the head's cull flag
PATH_SKIP, PATH_GENERIC, PATH_DIAG, PATH_YROT = range(4)
HEAD_CULL = 4
# a geom whose box the table build may skip: a cube whose transform's
# condition number is at most CULL_COND and whose box is at most
# CULL_SIZE of the scene's extent on every axis (a large box is crossed
# by some lane of nearly every warp, and its test costs the rest)
CULL_COND = 16.0
CULL_SIZE = 0.125


def _row_path(gtype: int, codes) -> int:
    """The path of a geom of type `gtype` whose 15 baked rows (kind-major,
    baked_rows) have the forms `codes`: a cube whose row r of every kind
    is a lone product or an fma of slot r alone (PATH_DIAG); a cube whose
    rows 0 and 2 are two terms of x then z, with or without a bias, and
    row 1 one of y (PATH_YROT); no test for a mesh (PATH_SKIP); form_row
    for every other geom (PATH_GENERIC: spheres among them, which are
    few, and a third fixed path of their own ran slower)."""
    if gtype == MESH:
        return PATH_SKIP
    rows = [(int(c), k % 3) for k, c in enumerate(codes)]
    if gtype == CUBE and all(c in (MUL_X + r, FMA_X + r) for c, r in rows):
        return PATH_DIAG
    xz = 0 | 2 << 2   # the slots s0 = x, s1 = z in the code's bits 4-9
    if gtype == CUBE and all(
            c in (MUL_Y, FMA_Y) if r == 1
            else c & 15 in (TWO, TWO_B) and c >> 4 == xz for c, r in rows):
        return PATH_YROT
    return PATH_GENERIC


def table_rows(scene, codes: np.ndarray, coefs: np.ndarray, tf: np.ndarray):
    """The tables of B1's table build: (G, 16) int32, per geom its head
    (the path, _row_path, and HEAD_CULL) and the forms `codes` of its 15
    baked rows (baked_rows); (G, 17, 4) float32, per geom its padded world
    box's lo and hi (x, y, z, 0), then the coefficients `coefs` of its 15
    rows, with c3 = -0.0 on a lone product (c0 * v is fma(c0, v, -0.0)
    bit for bit, and the kernel fuses o - row exactly where c3 is 0).

    The box is that of the unit cube's corners through the float32
    transform `tf` (G, 4, 4), in float64, padded by 1e-3 of the larger of
    1 and its largest coordinate and rounded outward to float32; the head
    lets the kernel skip a cube whose box a ray misses where the
    transform's condition number is at most CULL_COND (the rounding of
    the object-space test then stays far inside the padding) and the box
    is small (CULL_SIZE) beside the union of the geoms' boxes."""
    n_g = len(scene.geoms)
    c15 = np.asarray(codes, np.int32).reshape(n_g, 15)
    rows = np.asarray(coefs, np.float32).reshape(n_g, 15, 4).copy()
    lone = (c15 >= MUL_X) & (c15 <= MUL_Z)
    rows[..., 3][lone] = np.float32(-0.0)
    head = np.zeros((n_g, 1), np.int32)
    box = np.zeros((n_g, 2, 4), np.float32)
    corners = np.array([[x, y, z, 1.0] for x in (-0.5, 0.5)
                        for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    wcs = [(corners @ np.asarray(tf[g], np.float64).T)[:, :3]
           for g in range(n_g)]
    extent = (np.max([w.max(axis=0) for w in wcs], axis=0)
              - np.min([w.min(axis=0) for w in wcs], axis=0))
    for g, (geom, wc) in enumerate(zip(scene.geoms, wcs)):
        pad = 1e-3 * max(1.0, float(np.abs(wc).max()))
        lo = np.float32(wc.min(axis=0) - pad)
        hi = np.float32(wc.max(axis=0) + pad)
        box[g, 0, :3] = np.nextafter(lo, np.float32(-np.inf))
        box[g, 1, :3] = np.nextafter(hi, np.float32(np.inf))
        head[g] = _row_path(geom.type, c15[g])
        if (geom.type == CUBE and np.isfinite(box[g]).all()
                and np.linalg.cond(np.asarray(tf[g], np.float64)[:3, :3])
                <= CULL_COND
                and (box[g, 1, :3] - box[g, 0, :3]
                     <= CULL_SIZE * extent).all()):
            head[g] |= HEAD_CULL
    return (np.concatenate([head, c15], axis=1),
            np.concatenate([box, rows], axis=1))


def table_box_missed(box: torch.Tensor, o, d) -> torch.Tensor:
    """B1's table-build cull (csrc/path_trace_table.cu:box_missed) in
    plain PyTorch: where the rays o, d (tuples of (N,) tensors) miss the
    box (2, 4) (lo, hi: table_rows' first two words) or leave it behind
    their origin; False where the slab test meets a NaN."""
    inv = tuple(1.0 / c for c in d)
    t0 = [(box[0, k] - o[k]) * inv[k] for k in range(3)]
    t1 = [(box[1, k] - o[k]) * inv[k] for k in range(3)]
    lo = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    hi = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    tmin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tmax = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return (tmax < 0.0) | (tmin > tmax)


def geom_info(scene, device) -> GeomInfo:
    table = torch.tensor([[t, m] for t, m in zip(scene.geom_types,
                                                  scene.geom_material_ids)],
                         dtype=torch.int32, device=device)
    codes, coefs = baked_rows(scene)
    ds = scene.device(device)
    header = path_scene_header(
        scene, ds.mat_attr.cpu().numpy(), codes, coefs,
        [m.cpu().numpy() for m in (ds.geom_inverse, ds.geom_transform,
                                   ds.geom_inv_transpose)])
    row_code, row_coef = table_rows(scene, codes, coefs,
                                    ds.geom_transform.cpu().numpy())
    return GeomInfo(scene.geom_types, table, scene.n_tris, header,
                    torch.from_numpy(row_code).to(device),
                    torch.from_numpy(row_coef).to(device))


def scene_dev(ds, gi: GeomInfo, device: torch.device) -> _lib.SceneDev:
    """The kernels' view of the scene tensors (csrc/ptdn.cuh:SceneDev),
    which must be contiguous and on the rays' `device`."""
    tensors = dict(
        tf=ds.geom_transform, inv=ds.geom_inverse,
        invt=ds.geom_inv_transpose, geom=gi.table, tri_moller=ds.tri_moller,
        chunk_min=ds.tri_chunk_min, chunk_max=ds.tri_chunk_max,
        tri_attr=ds.tri_attr, mat_attr=ds.mat_attr, tex_wh=ds.tex_wh,
        tex_flat=ds.tex_flat_u32, row_code=gi.row_code,
        row_coef=gi.row_coef)
    for k, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"scene tensor {k}: expected contiguous on "
                             f"{device}, got {t.device}")
    return _lib.SceneDev(
        **{k: t.data_ptr() for k, t in tensors.items()},
        n_geoms=len(gi.types), n_tris=gi.n_tris,
        n_chunks=-(-gi.n_tris // TCHUNK), tex_h=int(ds.tex_atlas.shape[1]),
        tex_w=int(ds.tex_atlas.shape[2]))


# ---------------------------------------------------------------------------
# plain PyTorch version (vectors are (x, y, z) tuples of (N,) tensors)

def analytic_best(ds, geom_types, o, d, static: bool = False):
    """Closest analytic hit in scene order, strict <: (t, geom, normal),
    t = FLT_MAX and geom = -1 where no cube or sphere is hit. `static`
    takes the whole-path kernel's baked row dots (B1 only)."""
    n = o[0].shape[0]
    dev = o[0].device
    best_t = torch.full((n,), FLT_MAX, device=dev)
    best_g = torch.full((n,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, device=dev)
    best_n = (zero, zero, zero)
    for gi, gtype in enumerate(geom_types):
        if gtype == MESH:
            continue
        if gtype == CUBE:
            t, nrm, _ = box_intersect(ds.geom_transform[gi],
                                      ds.geom_inverse[gi], o, d, static)
        else:
            t, nrm, _ = sphere_intersect(ds.geom_transform[gi],
                                         ds.geom_inverse[gi],
                                         ds.geom_inv_transpose[gi], o, d,
                                         static)
        better = (t > 0.0) & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_g = torch.where(better, gi, best_g)
        best_n = tuple(torch.where(better, a, b) for a, b in zip(nrm, best_n))
    return best_t, best_g, best_n


def _chunks(ds, n_tris):
    for c in range(-(-n_tris // TCHUNK)):
        lo, hi = c * TCHUNK, min((c + 1) * TCHUNK, n_tris)
        tri = ds.tri_moller[lo:hi]
        cols = [tri[:, k][None, :] for k in range(9)]
        yield (c, lo, tuple(cols[0:3]), tuple(cols[3:6]), tuple(cols[6:9]))


def _crossed(ds, c, o, inv_d, t_lim):
    tmin, tmax = aabb_slab(o, inv_d, ds.tri_chunk_min[c],
                           ds.tri_chunk_max[c])
    return (tmax >= 0.0) & (tmin <= tmax) & (tmin < t_lim)


def _rows(x, sel):
    return tuple(c[sel][:, None] for c in x)


def mesh_best(ds, n_tris, o, d, bt, cull: bool = True):
    """Closest triangle beating the running best `bt`: (bt, index), index
    -1 where none does. Each chunk is tested only on the lanes that cross
    its AABB before their running best, which is the kernels' per-lane
    cull (and keeps the plain version's work near the kernels'); with
    `cull` False on every lane. The lane-triangle tests made add up in
    mesh_best.tri_tests, the count chip_smoke.py bounds the kernels'
    operations with."""
    inv_d = tuple(1.0 / c for c in d)
    bt = bt.clone()
    bi = torch.full(bt.shape, -1, dtype=torch.int64, device=bt.device)
    every = torch.ones(bt.shape, dtype=torch.bool, device=bt.device)
    for c, lo, v0, e1, e2 in _chunks(ds, n_tris):
        crossed = _crossed(ds, c, o, inv_d, bt) if cull else every
        sel = crossed.nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        mesh_best.tri_tests += sel.numel() * v0[0].shape[1]
        t, ok = moller(_rows(o, sel), _rows(d, sel), v0, e1, e2)
        # min: the first index among equal minima
        gt, gk = torch.where(ok, t, FLT_MAX).min(dim=1)
        upd = gt < bt[sel]
        bt[sel] = torch.where(upd, gt, bt[sel])
        bi[sel] = torch.where(upd, lo + gk, bi[sel])
    return bt, bi


mesh_best.tri_tests = 0


def closest_hit(ds, gi: GeomInfo, o, d, alive=None, static: bool = False):
    """The fully resolved closest hit: (t, geom, normal, uv, mat) with
    t = -1 and geom = -1 on a miss. Lanes with alive False take no mesh
    hit (their result is unused). The normal is interpolated in compat
    mode, the only one the port runs. Every chunk is scanned with the
    per-lane cull; `static` as in analytic_best."""
    ta, ga, an = analytic_best(ds, gi.types, o, d, static)
    a_valid = ga >= 0
    t = torch.where(a_valid, ta, -1.0)
    geom, nrm = ga, an
    uv = (torch.zeros_like(ta), torch.zeros_like(ta))
    if gi.n_tris:
        bt0 = torch.where(a_valid, ta, FLT_MAX)
        if alive is not None:
            bt0 = torch.where(alive, bt0, -FLT_MAX)
        _, bi = mesh_best(ds, gi.n_tris, o, d, bt0)
        found = bi >= 0
        r = ds.tri_attr[bi.clamp(min=0)]
        col = [r[:, k] for k in range(26)]
        tm, u, v, hit = ray_triangle(o, d, tuple(col[0:3]), tuple(col[3:6]),
                                     tuple(col[6:9]))
        mh = hit & found & (tm > 0.0)
        mn, muv = interpolate_tri_hit(u, v, tuple(col[9:12]),
                                      tuple(col[12:15]), tuple(col[15:18]),
                                      tuple(col[18:20]), tuple(col[20:22]),
                                      tuple(col[22:24]), compat=True)
        wins = mh & (~a_valid | (tm < ta))
        t = torch.where(wins, tm, t)
        geom = torch.where(wins, col[24].to(torch.int64), geom)
        nrm = tuple(torch.where(wins, a, b) for a, b in zip(mn, nrm))
        uv = tuple(torch.where(wins, a, 0.0) for a in muv)
    mats = gi.table[:, 1].to(torch.int64)
    mat = torch.where(geom >= 0, mats[geom.clamp(min=0)], 0)
    return t, geom, nrm, uv, mat


def light_visible(ds, gi: GeomInfo, o, d, light_geom: int, nee,
                  static: bool = False):
    """NEE visibility: the closest analytic hit is `light_geom` and no
    triangle lies in front of it; False wherever `nee` is False. Every
    chunk is scanned, each on the still-lit lanes that cross it (counted
    in light_visible.tri_tests)."""
    ta, ga, _ = analytic_best(ds, gi.types, o, d, static)
    lit = (ga == light_geom) & nee
    inv_d = tuple(1.0 / c for c in d)
    for c, lo, v0, e1, e2 in _chunks(ds, gi.n_tris):
        sel = (lit & _crossed(ds, c, o, inv_d, ta)).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        light_visible.tri_tests += sel.numel() * v0[0].shape[1]
        t, ok = moller(_rows(o, sel), _rows(d, sel), v0, e1, e2)
        occluded = (ok & (t < ta[sel][:, None])).any(dim=1)
        lit[sel] = ~occluded
    return lit


light_visible.tri_tests = 0


def tex_index(ds, mat, u, v):
    """Flat texel index of Texture::getColor (sceneStructs.h:208-221):
    nearest texel with the V flip; -1 where the material is untextured."""
    texid = ds.mat_attr[mat, 11].to(torch.int64)
    tid = texid.clamp(min=0)
    w = ds.tex_wh[tid, 0].to(torch.float32)
    h = ds.tex_wh[tid, 1].to(torch.float32)
    hm, wm = int(ds.tex_atlas.shape[1]), int(ds.tex_atlas.shape[2])
    x = torch.minimum(w * u, w - 1.0).to(torch.int64).clamp(0, wm - 1)
    y = torch.minimum(h * (1.0 - v), h - 1.0).to(torch.int64).clamp(0, hm - 1)
    return torch.where(texid >= 0, tid * (hm * wm) + y * wm + x, -1)


def texel_rgb(ds, idx):
    """Unpacked texel colors (r, g, b) in [0, 1] at flat indices >= 0."""
    packed = ds.tex_flat_u32.view(torch.int32)[idx.clamp(min=0)]
    return tuple(((packed >> (8 * c)) & 0xFF).to(torch.float32)
                 * COLORDIVIDOR for c in range(3))


def scene_intersect_full_plain(ds, gi: GeomInfo, o,
                               d) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of kernel A; o, d: (N, 3)."""
    ot = tuple(o[:, k] for k in range(3))
    dt = tuple(d[:, k] for k in range(3))
    t, geom, nrm, uv, mat = closest_hit(ds, gi, ot, dt)
    geom = geom.to(torch.int32)
    return {"t": t, "normal": torch.stack(nrm, dim=-1),
            "uv": torch.stack(uv, dim=-1), "mat_id": mat.to(torch.int32),
            "geom_id": geom, "hit": geom >= 0}


def scene_intersect_full_tex_plain(ds, gi: GeomInfo, o, d):
    """Plain PyTorch version of kernel J: kernel A's dict and the int32
    texel index of every ray's hit material at its uv (-1 untextured)."""
    isect = scene_intersect_full_plain(ds, gi, o, d)
    tidx = tex_index(ds, isect["mat_id"].to(torch.int64), isect["uv"][:, 0],
                     isect["uv"][:, 1])
    return isect, tidx.to(torch.int32)


def scene_intersect_plain(ds, gi: GeomInfo, o, d,
                          cull: bool = True) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of kernel M; o, d: (N, 3)."""
    ot = tuple(o[:, k] for k in range(3))
    dt = tuple(d[:, k] for k in range(3))
    ta, ga, an = analytic_best(ds, gi.types, ot, dt)
    a_valid = ga >= 0
    t_m = torch.full_like(ta, -1.0)
    tri_m = torch.full_like(ga, -1)
    if gi.n_tris:
        bt, bi = mesh_best(ds, gi.n_tris, ot, dt,
                           torch.where(a_valid, ta, FLT_MAX), cull)
        t_m = torch.where(bi >= 0, bt, -1.0)
        tri_m = bi
    return {"t_a": torch.where(a_valid, ta, -1.0),
            "geom_a": ga.to(torch.int32),
            "normal_a": torch.stack(an, dim=-1),
            "t_m": t_m, "tri_m": tri_m.to(torch.int32)}


def light_visibility_plain(ds, gi: GeomInfo, o, d,
                           light_geom: int) -> torch.Tensor:
    """Plain PyTorch version of kernel I: light_visible on every ray."""
    ot = tuple(o[:, k] for k in range(3))
    dt = tuple(d[:, k] for k in range(3))
    return light_visible(ds, gi, ot, dt, light_geom,
                         torch.ones(o.shape[0], dtype=torch.bool,
                                    device=o.device))


# ---------------------------------------------------------------------------
# the wrappers

class RayArgs(ctypes.Structure):
    """Mirror of csrc/scene_intersect.cu:RayArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("o", "d")]
                + [(k, ctypes.c_int) for k in ("o_rs", "o_cs", "d_rs", "d_cs",
                                               "n")])


class BestArgs(ctypes.Structure):
    """Mirror of csrc/closest_hit.cuh:BestArgs."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("t_a", "geom_a", "nrm_a",
                                                 "t_m", "tri_m")]


class IsectArgs(ctypes.Structure):
    """Mirror of csrc/scene_intersect.cu:IsectArgs."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("t", "nrm", "uv", "geom",
                                                 "mat", "tidx")]


def _ray_args(o: torch.Tensor, d: torch.Tensor) -> RayArgs:
    """Rays o, d: (N, 3) float32 CUDA tensors of any strides (a view of
    three planes of a plane stack is taken as it is)."""
    n = o.shape[0]
    for name, x in (("o", o), ("d", d)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (n, 3)
                or x.device.type != "cuda"):
            raise ValueError(f"{name}: expected float32 ({n}, 3) on cuda, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    return RayArgs(o=o.data_ptr(), d=d.data_ptr(), o_rs=o.stride(0),
                   o_cs=o.stride(1), d_rs=d.stride(0), d_cs=d.stride(1), n=n)


def scene_intersect_full(ds, gi: GeomInfo, o: torch.Tensor,
                         d: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fully resolved closest hit of rays o, d (N, 3): the engine's
    intersect() dict (t, normal, uv, mat_id, geom_id, hit). CPU tensors
    take the plain version; CUDA tensors launch kernel A."""
    _lib.require(o.device, "scene_intersect_full")
    if o.device.type == "cpu":
        return scene_intersect_full_plain(ds, gi, o, d)
    return _scene_intersect_full_kernel(ds, gi, o, d)


def scene_intersect_full_tex(ds, gi: GeomInfo, o: torch.Tensor,
                             d: torch.Tensor):
    """Kernel A's hit dict of rays o, d (N, 3) and the (N,) int32 flat
    texel index of each hit material at its uv, -1 where untextured (on
    every ray, hit or not; kernel K reads the texels). CPU tensors take
    the plain version; CUDA tensors launch kernel J."""
    _lib.require(o.device, "scene_intersect_full_tex")
    if o.device.type == "cpu":
        return scene_intersect_full_tex_plain(ds, gi, o, d)
    return _scene_intersect_full_tex_kernel(ds, gi, o, d)


def scene_intersect(ds, gi: GeomInfo, o: torch.Tensor, d: torch.Tensor,
                    cull: bool = True) -> Dict[str, torch.Tensor]:
    """The unmerged closest hits of rays o, d (N, 3), as the TPU kernel
    scene_intersect_pallas returns them: the closest analytic hit (t_a,
    -1 where none; geom_a; normal_a, 0 where none) and the closest
    triangle beating it (t_m, -1 where none; tri_m). `cull` False scans
    every chunk for every ray (the same answer, more work). CPU tensors
    take the plain version; CUDA tensors launch kernel M."""
    _lib.require(o.device, "scene_intersect")
    if o.device.type == "cpu":
        return scene_intersect_plain(ds, gi, o, d, cull)
    return _scene_intersect_kernel(ds, gi, o, d, cull)


def light_visibility(ds, gi: GeomInfo, o: torch.Tensor, d: torch.Tensor,
                     light_geom: int) -> torch.Tensor:
    """NEE visibility of shadow rays o, d (N, 3): bool (N,), True where
    the closest analytic hit is geom `light_geom` and no triangle lies in
    front of it, on every ray (the caller masks the NEE lanes). CPU
    tensors take the plain version; CUDA tensors launch kernel I."""
    _lib.require(o.device, "light_visibility")
    if o.device.type == "cpu":
        return light_visibility_plain(ds, gi, o, d, light_geom)
    return _light_visibility_kernel(ds, gi, o, d, light_geom)


def _scene_lib(gi: GeomInfo):
    """The library kernels A, J, I and M launch from: the scene's own build
    (csrc/scene/scene_intersect.cu) where the scene has one
    (gi.path_scene), else None, the kernel library's; both compute the
    same bits."""
    return (None if gi.path_scene is None
            else _lib.scene_kernels(gi.path_scene, "scene_intersect"))


def _isect_kernel(name, ds, gi, o, d, tex: bool):
    """Kernel A or J (`name`, its C entry point), from _scene_lib."""
    ray = _ray_args(o, d)
    n = ray.n
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    out = {"t": torch.empty(n, **f32), "normal": torch.empty(n, 3, **f32),
           "uv": torch.empty(n, 2, **f32), "mat_id": torch.empty(n, **i32),
           "geom_id": torch.empty(n, **i32)}
    tidx = torch.empty(n, **i32) if tex else None
    p = _lib.ptr
    args = IsectArgs(t=p(out["t"]), nrm=p(out["normal"]), uv=p(out["uv"]),
                     geom=p(out["geom_id"]), mat=p(out["mat_id"]),
                     tidx=p(tidx))
    _lib.launch(name, scene_dev(ds, gi, o.device), ray, args,
                lib=_scene_lib(gi))
    out["hit"] = out["geom_id"] >= 0
    return out, tidx


def _scene_intersect_full_kernel(ds, gi, o, d):
    out, _ = _isect_kernel("ptdn_scene_intersect_full", ds, gi, o, d, False)
    scene_intersect_full.launches += 1     # counts kernel launches only
    return out


def _scene_intersect_full_tex_kernel(ds, gi, o, d):
    out = _isect_kernel("ptdn_scene_intersect_full_tex", ds, gi, o, d, True)
    scene_intersect_full_tex.launches += 1
    return out


def _scene_intersect_kernel(ds, gi, o, d, cull=True):
    ray = _ray_args(o, d)
    n = ray.n
    f32 = dict(dtype=torch.float32, device=o.device)
    i32 = dict(dtype=torch.int32, device=o.device)
    out = {"t_a": torch.empty(n, **f32), "geom_a": torch.empty(n, **i32),
           "normal_a": torch.empty(n, 3, **f32), "t_m": torch.empty(n, **f32),
           "tri_m": torch.empty(n, **i32)}
    p = _lib.ptr
    args = BestArgs(t_a=p(out["t_a"]), geom_a=p(out["geom_a"]),
                    nrm_a=p(out["normal_a"]), t_m=p(out["t_m"]),
                    tri_m=p(out["tri_m"]))
    _lib.launch("ptdn_scene_intersect", scene_dev(ds, gi, o.device), ray,
                args, ctypes.c_int(int(cull)), lib=_scene_lib(gi))
    scene_intersect.launches += 1
    return out


def _light_visibility_kernel(ds, gi, o, d, light_geom):
    ray = _ray_args(o, d)
    lit = torch.empty(ray.n, dtype=torch.bool, device=o.device)
    _lib.launch("ptdn_light_visibility", scene_dev(ds, gi, o.device), ray,
                ctypes.c_int(light_geom), _lib.ptr(lit), lib=_scene_lib(gi))
    light_visibility.launches += 1
    return lit


scene_intersect_full.launches = 0
scene_intersect_full_tex.launches = 0
scene_intersect.launches = 0
light_visibility.launches = 0
