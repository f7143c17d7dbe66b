"""One bounce of shading, plain PyTorch: emissive termination, albedo
modulation, the NEE disk sample toward the light and scatterRay.

The semantics are those of the JAX package's fused shade body
(ops/pallas/shade.py:shade_tiles), line for line, which replicates the
reference: scatterRay (src/interactions.h:94-136) with Schlick's
refract-vs-reflect choice, computeShadowRay's uniform-in-radius disk
sample (pathtrace.cu:284-297) rotated by glm::rotation's quaternion
(glm/gtx/quaternion.inl:248-283), and the per-lane LCG advancing only at
the draw sites the reference's control flow reaches, so each lane
consumes the reference's exact variate sequence. The CUDA path kernel
(csrc/scene/path_trace.cu) runs the same body per thread.

Material properties come from the packed (M, 16) material table
(scene.DeviceScene.mat_attr: color 0:3, spec color 3:6, spec exponent 6,
refl 7, refr 8, ior 9, emittance 10, texid 11).
"""

from __future__ import annotations

from typing import Dict

import torch

from ptdn_tpu_torch.ops.fp import recip_sqrt, sqrt
from ptdn_tpu_torch.ops.rng import next_rand_masked

TWO_PI = 6.2831853071795864769
SQRT_ONE_THIRD = 0.5773502691896257645


def _pow5(x):
    """x ** 5 as XLA's integer_pow evaluates it: x * ((x*x)*(x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def shade(s: Dict[str, torch.Tensor], seed: torch.Tensor, mat_attr,
          light_pos, lrad, sint, alb_skip: bool, shadow_ray: bool,
          reduce_var: bool) -> Dict[str, torch.Tensor]:
    """Shade every lane of the state `s` (keys o, d: xyz tuples; t;
    n: xyz tuple; alb: rgb tuple; tr: rgb throughput tuple; mat: int64
    material id; act, dif: bool) with TEA seed `seed` (int64).

    Returns a dict: er (emissive contribution, rgb tuple), sp (spawn
    origin), d (new direction), tr (new throughput), sd (unit shadow
    direction), c (unlit NEE contribution), nee, act, dif (bool)."""
    (ox, oy, oz), (dx, dy, dz) = s["o"], s["d"]
    t = s["t"]
    nx, ny, nz = s["n"]
    tr, tg, tb = s["tr"]
    active = s["act"]
    diffuse_flag = s["dif"]
    m = mat_attr[s["mat"]]
    m_emit, m_refl, m_refr, m_ior = m[:, 10], m[:, 7], m[:, 8], m[:, 9]

    emissive = m_emit > 0.0
    add_emit = active & emissive
    if shadow_ray and reduce_var:
        add_emit = add_emit & ~diffuse_flag
    add_f = torch.where(add_emit, 1.0, 0.0)
    er = tuple(add_f * th * m[:, k] * m_emit
               for k, th in enumerate((tr, tg, tb)))
    active = active & ~emissive

    # hit point + spawn origin (+1e-4 n, pathtrace.cu:338/interactions.h:104)
    spx = (ox + t * dx) + 1e-4 * nx
    spy = (oy + t * dy) + 1e-4 * ny
    spz = (oz + t * dz) + 1e-4 * nz

    # throughput *= albedo (pathtrace.cu:343-355)
    af = torch.where(active & (not alb_skip), 1.0, 0.0)
    tr, tg, tb = (th * (1.0 + af * (a - 1.0))
                  for th, a in zip((tr, tg, tb), s["alb"]))

    mat_is_diffuse = (m_refl < 1e-6) & (m_refr < 1e-6)

    out = {"er": er}
    zero = torch.zeros_like(t)
    if shadow_ray:
        nee = active & mat_is_diffuse
        ltx, lty, ltz = light_pos
        tcx, tcy, tcz = ltx - spx, lty - spy, ltz - spz
        tcn = recip_sqrt(tcx * tcx + tcy * tcy + tcz * tcz)
        tcx, tcy, tcz = tcx * tcn, tcy * tcn, tcz * tcn
        seed, r_th = next_rand_masked(seed, nee)
        theta = TWO_PI * r_th
        pxx = torch.cos(theta)
        pyy = torch.sin(theta)
        opposite = tcz < -1.0 + 1.1920929e-07
        s2 = torch.clamp_min((1.0 + tcz) * 2.0, 1e-30)
        s_ = sqrt(s2)
        invs = recip_sqrt(s2)
        qw = torch.where(opposite, 0.0, 0.5 * s_)
        qx = torch.where(opposite, 0.0, -tcy * invs)
        qy = torch.where(opposite, -1.0, tcx * invs)
        cpz = qx * pyy - qy * pxx
        sdx = pxx + 2.0 * (qw * 0.0 + qy * cpz)
        sdy = pyy + 2.0 * (qw * 0.0 - qx * cpz)
        sdz = 0.0 + 2.0 * (qw * cpz + 0.0)
        seed, r_rad = next_rand_masked(seed, nee)
        dxs = (ltx + sdx * (r_rad * lrad)) - spx
        dys = (lty + sdy * (r_rad * lrad)) - spy
        dzs = (ltz + sdz * (r_rad * lrad)) - spz
        sdist2 = dxs * dxs + dys * dys + dzs * dzs
        sdn = recip_sqrt(sdist2)
        sdx, sdy, sdz = dxs * sdn, dys * sdn, dzs * sdn
        lambert = torch.clamp_min(sdx * nx + sdy * ny + sdz * nz, 0.0)
        # a true division: `float / tensor` is reciprocal-times in torch
        scale = torch.full_like(sdist2, sint).div(sdist2) * lambert
        neef = torch.where(nee, 1.0, 0.0)
        out["sd"] = (sdx, sdy, sdz)
        out["c"] = (tr * scale * neef, tg * scale * neef, tb * scale * neef)
        out["nee"] = nee
    else:
        out["sd"] = (zero, zero, zero)
        out["c"] = (zero, zero, zero)
        out["nee"] = torch.zeros_like(active)

    # scatterRay (interactions.h:94-136)
    is_refr = m_refr != 0.0
    seed, r1 = next_rand_masked(seed, active)
    proj = dx * nx + dy * ny + dz * nz
    eta = torch.where(proj > 0.0, m_ior, 1.0 / m_ior)
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * _pow5(1.0 - torch.abs(proj))
    do_refract = is_refr & (schlick < r1)
    k = 1.0 - eta * eta * (1.0 - proj * proj)
    fr = eta * proj + sqrt(torch.clamp_min(k, 0.0))
    tir = k < 0.0
    rf = tuple(torch.where(tir, 0.0, eta * dc - fr * nc)
               for dc, nc in ((dx, nx), (dy, ny), (dz, nz)))
    two_d_n = 2.0 * proj
    rl = (dx - two_d_n * nx, dy - two_d_n * ny, dz - two_d_n * nz)
    do_reflect = (is_refr & ~do_refract) | (~is_refr & (r1 < m_refl))
    is_diffuse = ~is_refr & ~(r1 < m_refl)
    seed, r_up = next_rand_masked(seed, active & is_diffuse)
    seed, r_ar = next_rand_masked(seed, active & is_diffuse)
    up = sqrt(r_up)
    over = sqrt(1.0 - up * up)
    around = r_ar * TWO_PI
    # directionNotNormal (interactions.h:49-56)
    use_x = torch.abs(nx) < SQRT_ONE_THIRD
    use_y = ~use_x & (torch.abs(ny) < SQRT_ONE_THIRD)
    dnnx = torch.where(use_x, 1.0, 0.0)
    dnny = torch.where(use_y, 1.0, 0.0)
    dnnz = torch.where(~use_x & ~use_y, 1.0, 0.0)
    p1x = ny * dnnz - nz * dnny
    p1y = nz * dnnx - nx * dnnz
    p1z = nx * dnny - ny * dnnx
    p1n = recip_sqrt(p1x * p1x + p1y * p1y + p1z * p1z)
    p1x, p1y, p1z = p1x * p1n, p1y * p1n, p1z * p1n
    p2x = ny * p1z - nz * p1y
    p2y = nz * p1x - nx * p1z
    p2z = nx * p1y - ny * p1x
    p2n = recip_sqrt(p2x * p2x + p2y * p2y + p2z * p2z)
    p2x, p2y, p2z = p2x * p2n, p2y * p2n, p2z * p2n
    ca = torch.cos(around) * over
    sa = torch.sin(around) * over
    df = (up * nx + ca * p1x + sa * p2x,
          up * ny + ca * p1y + sa * p2y,
          up * nz + ca * p1z + sa * p2z)
    nd = tuple(torch.where(do_refract, a, torch.where(do_reflect, b, c))
               for a, b, c in zip(rf, rl, df))
    rff = torch.where(active & do_reflect, 1.0, 0.0)
    ntr = tuple(th * (1.0 + rff * (m[:, 3 + k] - 1.0))
                for k, th in enumerate((tr, tg, tb)))
    actf = torch.where(active, 1.0, 0.0)
    out["d"] = tuple(actf * a + (1.0 - actf) * b
                     for a, b in zip(nd, (dx, dy, dz)))
    out["sp"] = tuple(actf * a + (1.0 - actf) * b
                      for a, b in zip((spx, spy, spz), (ox, oy, oz)))
    out["tr"] = tuple(torch.where(active, a, b)
                      for a, b in zip(ntr, (tr, tg, tb)))
    out["dif"] = diffuse_flag | (active & is_diffuse)
    out["act"] = active
    return out
