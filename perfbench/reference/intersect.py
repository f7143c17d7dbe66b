"""Ray/primitive intersection math, plain PyTorch, float32.

Vectors are tuples of (N,) tensors (x, y, z), so each line is one
elementwise op in the same order as the JAX package's fused kernels
(ops/pallas/scene_intersect.py) and as csrc/ptdn.cuh. The semantics are
the JAX package's default knobs: one reciprocal per cube slab axis
(RECIP_SLAB, ops/intersect.py:33) and rsqrt normalization of the
object-space direction and the analytic normal (FAST_NORM,
ops/pallas/scene_intersect.py:79-96).

Reference parity (quirks kept on purpose):
* unit-cube slab test with sequential per-axis tmin update and the
  transform-(not invTranspose)-mapped normal (intersections.h:50-92);
* unit-sphere test (intersections.h:104-146);
* getPointOnRay's 1e-4 backoff along the NORMALIZED direction
  (intersections.h:29-31);
* distance-based return t = |origin - world_hit| (intersections.h:89,145);
* glm 0.9.x intersectRayTriangle: BACKFACE-CULLED Moller-Trumbore,
  epsilon = FLT_EPSILON (external/include/glm/gtx/intersect.inl);
* Triangle::Intersect's swapped barycentric weights for the smoothed
  normal (sceneStructs.h:162-170) when compat is on.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from perfbench.reference.fp import div_sqrt, dot3, fma, rsqrt, sqrt
from perfbench.reference.parser import CUBE, MESH

FLT_MAX = 3.402823466e38
FLT_EPSILON = 1.1920929e-07
BACKOFF = 1e-4   # getPointOnRay epsilon (intersections.h:30)


ONE = 3      # a plan slot that reads the constant 1.0
LONE = 64    # a plan code flag: the row is one lone term


def baked_row_plan(row, bias: bool):
    """The JAX whole-path kernel's baked row dot (_row_dot, static=True:
    exactly-zero coefficients drop out, 1 and -1 give v and -v, the terms
    sum left to right) as XLA on the CPU contracts it, in one fused form:
    ((a0, a1, a2, b), code) such that the row is
    fma(a2, v[s2], fma(a0, v[s0], a1 * v[s1])) + b, where s_k is the
    code's k-th 2-bit slot (0-2 pick x, y, z; 3 picks 1.0) and LONE
    marks a row that is one lone term (it fuses into o - row, as XLA
    contracts c - a*b). A dropped term leaves its slot to 1.0 with the
    coefficient -0.0, and an absent bias is -0.0: adding -0.0 changes
    nothing, not even the sign of a zero. Since +-1 * v is exact, the
    only choice left is which of the first two terms fuses: the second
    when the first is +-v and the second a product. baked_row_form
    resolves the plan into the expression that remains."""
    c = [float(x) for x in row[:3]]
    b = float(row[3]) if bias and float(row[3]) != 0.0 else -0.0
    present = [k for k in range(3) if c[k] != 0.0]
    if not present:
        # the empty row is +0.0 (or the bias) as in the reference
        return (-0.0, b if b != 0.0 else 0.0, -0.0, -0.0), (
            ONE | ONE << 2 | ONE << 4)
    if len(present) == 1:
        k = present[0]
        code = k | ONE << 2 | ONE << 4
        return (c[k], b, -0.0, -0.0), code | (0 if b != 0.0 else LONE)
    i, j = present[:2]
    if abs(c[i]) == 1.0 and abs(c[j]) != 1.0:
        i, j = j, i
    k = present[2] if len(present) == 3 else None
    return ((c[i], c[j], -0.0 if k is None else c[k], b),
            i | j << 2 | (ONE if k is None else k) << 4)


# The forms of a baked row (baked_row_form): CONST is c3; MUL_X + s is
# c0 * v[s]; FMA_X + s is fma(c0, v[s], c3); TWO is
# fma(c0, v[s0], c1 * v[s1]), THREE fma(c2, v[s2], TWO), and TWO_B and
# THREE_B add the bias c3. v[s] is x, y or z.
(CONST, MUL_X, MUL_Y, MUL_Z, FMA_X, FMA_Y, FMA_Z, TWO, TWO_B, THREE,
 THREE_B) = range(11)


def baked_row_form(row, bias: bool):
    """The baked row plan (baked_row_plan) resolved on the host into the
    one expression its terms leave: (code, (c0, c1, c2, c3)), the form
    in the code's low 4 bits and, for the forms of two or three terms,
    the slots s0, s1, s2 in its 2-bit fields from bit 4. Each form equals
    the plan bit for bit, because the pieces it drops are exact
    identities: x * 1 = x, fma(-0, 1, y) = y and y + (-0) = y, signed
    zeros included. A MUL row is the plan's LONE row, which fuses into
    o - row. csrc/path_trace.cuh:form_row switches on the same forms."""
    (a0, a1, a2, b), code = baked_row_plan(row, bias)
    s0, s1, s2 = ((code >> (2 * k)) & 3 for k in range(3))
    if s0 == ONE:
        return CONST, (0.0, 0.0, 0.0, a1)
    if code & LONE:
        return MUL_X + s0, (a0, 0.0, 0.0, 0.0)
    if s1 == ONE:
        return FMA_X + s0, (a0, 0.0, 0.0, a1)
    form = (TWO if s2 == ONE else THREE) + (1 if b != 0.0 else 0)
    return form | s0 << 4 | s1 << 6 | (0 if s2 == ONE else s2) << 8, (
        a0, a1, a2, b)


def form_value(code, c, v):
    """The value of the baked row of form `code` with coefficients c at
    v = (x, y, z), by that form's own expression (baked_row_form)."""
    f = code & 15
    if f == CONST:
        # a Python float as in the reference (a 0-dim tensor here would
        # sit on the host)
        return c[3]
    if f <= MUL_Z:
        return c[0] * v[f - MUL_X]
    if f <= FMA_Z:
        return fma(c[0], v[f - FMA_X], c[3])
    s0, s1, s2 = ((code >> (4 + 2 * k)) & 3 for k in range(3))
    acc = fma(c[0], v[s0], c[1] * v[s1])
    if f >= THREE:
        acc = fma(c[2], v[s2], acc)
    return acc + c[3] if f in (TWO_B, THREE_B) else acc


def row_dot(m, r, v, bias: bool, static: bool = False):
    """m[r,0]*x + m[r,1]*y + m[r,2]*z (+ m[r,3]): the full dot product,
    or with `static` the baked row of baked_row_form (m is then a nested
    list of floats)."""
    if static:
        return form_value(*baked_row_form(m[r], bias), v)
    e = dot3((m[r, 0], m[r, 1], m[r, 2]), v)
    return e + m[r, 3] if bias else e


def _sub_row(o, m, r, v, static: bool):
    """o - row_dot(m, r, v, bias=True); a baked row that is one lone
    product fuses into the subtraction, as XLA contracts c - a*b."""
    if static:
        code, c = baked_row_form(m[r], True)
        if MUL_X <= code <= MUL_Z:
            return fma(-c[0], v[code - MUL_X], o)
        return o - form_value(code, c, v)
    return o - row_dot(m, r, v, True)


def _mat(m, static: bool):
    return m.tolist() if static else m


def rnorm(x, y, z):
    return rsqrt(dot3((x, y, z), (x, y, z)))


def _object_ray(inverse, o, d, static: bool):
    qo = tuple(row_dot(inverse, r, o, True, static) for r in range(3))
    qd = tuple(row_dot(inverse, r, d, False, static) for r in range(3))
    qn = rnorm(*qd)
    return qo, tuple(c * qn for c in qd)


def _world_t(transform, o, qo, qd, t_obj, static: bool):
    po = tuple(fma(t_obj - BACKOFF, qd[k], qo[k]) for k in range(3))
    e = tuple(_sub_row(o[r], transform, r, po, static) for r in range(3))
    return po, sqrt(dot3(e, e))


def _unit(v):
    n = rnorm(*v)
    return tuple(c * n for c in v)


def box_intersect(transform, inverse, o, d, static: bool = False):
    """Unit-cube [-0.5, 0.5]^3 slab test (intersections.h:50-92).
    `static` takes the baked row dots of the whole-path kernel.

    Returns (t, normal, hit): t is the world-space distance |o - hit|,
    -1 where the ray misses."""
    transform, inverse = _mat(transform, static), _mat(inverse, static)
    qo, qd = _object_ray(inverse, o, d, static)
    shape = o[0].shape
    tmin = torch.full(shape, -1e38, device=o[0].device)
    tmax = torch.full(shape, 1e38, device=o[0].device)
    zero = torch.zeros(shape, device=o[0].device)
    tmin_n = [zero, zero, zero]
    tmax_n = [zero, zero, zero]
    for ax in range(3):
        rq = 1.0 / qd[ax]
        t1 = (-0.5 - qo[ax]) * rq
        t2 = (0.5 - qo[ax]) * rq
        ta = torch.minimum(t1, t2)
        tb = torch.maximum(t1, t2)
        um = (ta > 0) & (ta > tmin)
        tmin = torch.where(um, ta, tmin)
        ux = tb < tmax
        tmax = torch.where(ux, tb, tmax)
        nsign = torch.where(t2 < t1, 1.0, -1.0)
        for k in range(3):
            val = nsign if k == ax else zero
            tmin_n[k] = torch.where(um, val, tmin_n[k])
            tmax_n[k] = torch.where(ux, val, tmax_n[k])
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = torch.where(inside, tmax, tmin)
    n_o = tuple(torch.where(inside, tmax_n[k], tmin_n[k]) for k in range(3))
    _, t = _world_t(transform, o, qo, qd, t_obj, static)
    normal = _unit(tuple(row_dot(transform, r, n_o, False, static)
                         for r in range(3)))
    return torch.where(hit, t, -1.0), normal, hit


def sphere_intersect(transform, inverse, inv_transpose, o, d,
                     static: bool = False):
    """Unit sphere of radius 0.5 (intersections.h:104-146).
    Returns (t, normal, hit) like box_intersect."""
    transform, inverse, inv_transpose = (_mat(m, static) for m in (
        transform, inverse, inv_transpose))
    qo, qd = _object_ray(inverse, o, d, static)
    vdot = dot3(qo, qd)
    radicand = fma(vdot, vdot, -(dot3(qo, qo) - 0.25))
    sq = sqrt(torch.clamp_min(radicand, 0.0))
    t1 = -vdot + sq
    t2 = -vdot - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = torch.where(both_pos, torch.minimum(t1, t2),
                        torch.maximum(t1, t2))
    hit = (radicand >= 0) & ~both_neg
    po, t = _world_t(transform, o, qo, qd, t_obj, static)
    flip = torch.where(both_pos, 1.0, -1.0)
    nw = tuple(row_dot(inv_transpose, r, po, False, static) * flip
               for r in range(3))
    return torch.where(hit, t, -1.0), _unit(nw), hit


def moller(o, d, v0, e1, e2):
    """Backface-culled Moller-Trumbore of the fused kernels' scan: o, d
    and the triangle components broadcast against each other. Returns
    (t, ok) with ok = front-facing, inside and t > 0."""
    p = cross(d, e2)
    a = dot3(e1, p)
    f = 1.0 / a
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = f * dot3(s, p)
    q = cross(s, e1)
    v = f * dot3(d, q)
    t = f * dot3(e2, q)
    ok = ((a >= FLT_EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > 0.0))
    return t, ok


def ray_triangle(o, d, v0, v1, v2):
    """glm::intersectRayTriangle (glm/gtx/intersect.inl:36-74).
    Returns (t, u, v, hit): u weighs v1, v weighs v2, hit needs t >= 0."""
    e1 = tuple(v1[k] - v0[k] for k in range(3))
    e2 = tuple(v2[k] - v0[k] for k in range(3))
    p = cross(d, e2)
    a = dot3(e1, p)
    front = a >= FLT_EPSILON
    f = 1.0 / torch.where(front, a, 1.0)
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = f * dot3(s, p)
    q = cross(s, e1)
    v = f * dot3(d, q)
    t = f * dot3(e2, q)
    hit = (front & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= 0.0))
    return t, u, v, hit


def interpolate_tri_hit(u, v, n0, n1, n2, uv0, uv1, uv2, compat: bool):
    """Triangle::Intersect attribute interpolation (sceneStructs.h:160-172).
    compat keeps the reference's swapped normal weights
    (n0*u + n1*v + n2*(1-u-v)). The normal is divided by its length."""
    w = 1.0 - u - v
    uv = tuple(dot3((uv0[k], uv1[k], uv2[k]), (w, u, v)) for k in range(2))
    wn = (u, v, w) if compat else (w, u, v)
    n = tuple(dot3((n0[k], n1[k], n2[k]), wn) for k in range(3))
    nn = dot3(n, n)
    return tuple(div_sqrt(c, nn) for c in n), uv


def cross(a, b):
    """a x b, each component a difference of products."""
    return (fma(a[1], b[2], -(a[2] * b[1])), fma(a[2], b[0], -(a[0] * b[2])),
            fma(a[0], b[1], -(a[1] * b[0])))


def aabb_slab(o, inv_d, bmin, bmax):
    """Slab entry/exit of an AABB (boundingbox.h:62-79 with the fused
    kernels' operand order). Returns (tmin, tmax); the ray crosses the box
    where tmax >= 0 and tmin <= tmax."""
    t0 = [(bmin[k] - o[k]) * inv_d[k] for k in range(3)]
    t1 = [(bmax[k] - o[k]) * inv_d[k] for k in range(3)]
    tmin = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                       torch.minimum(t0[1], t1[1])),
                         torch.minimum(t0[2], t1[2]))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                       torch.maximum(t0[1], t1[1])),
                         torch.maximum(t0[2], t1[2]))
    return tmin, tmax


TCHUNK = 128


COLORDIVIDOR = 0.003921568627   # utilities.h:24


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
    hit (their result is unused). The normal is interpolated in the mode
    of gi.compat. Every chunk is scanned with the per-lane cull; `static`
    as in analytic_best."""
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
                                      tuple(col[22:24]), compat=gi.compat)
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


mesh_best.tri_tests = 0
light_visible.tri_tests = 0


class GeomInfo(NamedTuple):
    """The static geometry the plain versions read: per-geom types, an
    int32 (G, 2) table of (type, material), the triangle count and the
    mode of the mesh normals (compat mode's swapped weights, or native
    mode's true barycentric ones)."""
    types: Tuple[int, ...]
    table: torch.Tensor
    n_tris: int
    compat: bool = True


def geom_info(scene, device, compat: bool = True) -> GeomInfo:
    table = torch.tensor([[t, m] for t, m in zip(scene.geom_types,
                                                  scene.geom_material_ids)],
                         dtype=torch.int32, device=device)
    return GeomInfo(scene.geom_types, table, scene.n_tris, bool(compat))
