// Per-lane shading shared by kernels B1 (path.cu), E (shade.cu) and H
// (bounce.cu): the masked LCG draw, the NEE disk sample toward the light,
// scatterRay, and the whole shading of one lane's planes (shade_lane).
//
// The per-thread form of the JAX package's shade body
// (ptdn_tpu/ops/pallas/shade.py:shade_tiles) and of the plain version
// ptdn_tpu_torch/ops/bsdf.py:shade, operation for operation, so that both
// kernels equal it bit for bit. A draw is taken only where the
// reference's control flow reaches it, so each lane consumes the
// reference's exact variate sequence (interactions.h:10-30).
#pragma once

#include "ptdn.cuh"

namespace ptdn {

constexpr float kTwoPi = 6.2831853071795864769f;
constexpr float kSqrtOneThird = 0.5773502691896257645f;

// x ** 5 as XLA's integer_pow evaluates it: x * ((x*x)*(x*x))
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// One LCG draw: the seed advances only where `mask`; the value is the
// next draw's either way (ops/rng.py:next_rand_masked).
__device__ __forceinline__ float lcg_masked(uint32_t& seed, bool mask) {
  const uint32_t next = 1664525u * seed + 1013904223u;
  if (mask) seed = next;
  return (float)(int)(next & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

struct ShadowSample {
  float dx, dy, dz;  // unit direction from the spawn point to the sample
  float dist2;       // squared distance to the sample
};

// computeShadowRay's uniform-in-radius disk sample (pathtrace.cu:284-297):
// the point (cos theta, sin theta, 0) * r * lrad rotated by
// glm::rotation((0,0,1), toward the spawn point) (quaternion.inl:248-283)
// about the light center. Draws theta, then r, where `nee`.
__device__ inline ShadowSample shadow_sample(uint32_t& seed, bool nee,
                                             float lx, float ly, float lz,
                                             float lrad, float spx, float spy,
                                             float spz) {
  float tcx = lx - spx, tcy = ly - spy, tcz = lz - spz;
  const float tcn = 1.0f / sqrtf(tcx * tcx + tcy * tcy + tcz * tcz);
  tcx = tcx * tcn;
  tcy = tcy * tcn;
  tcz = tcz * tcn;
  const float theta = kTwoPi * lcg_masked(seed, nee);
  const float pxx = cosf(theta);
  const float pyy = sinf(theta);
  const bool opposite = tcz < -1.0f + 1.1920929e-07f;
  const float s_ = sqrtf(jmax((1.f + tcz) * 2.f, 1e-30f));
  const float invs = 1.0f / s_;
  const float qw = opposite ? 0.f : 0.5f * s_;
  const float qx = opposite ? 0.f : -tcy * invs;
  const float qy = opposite ? -1.f : tcx * invs;
  const float cpz = qx * pyy - qy * pxx;
  const float sdx0 = pxx + 2.f * (qw * 0.f + qy * cpz);
  const float sdy0 = pyy + 2.f * (qw * 0.f - qx * cpz);
  const float sdz0 = 0.f + 2.f * (qw * cpz + 0.f);
  const float r_rad = lcg_masked(seed, nee);
  const float dxs = (lx + sdx0 * (r_rad * lrad)) - spx;
  const float dys = (ly + sdy0 * (r_rad * lrad)) - spy;
  const float dzs = (lz + sdz0 * (r_rad * lrad)) - spz;
  const float dist2 = dxs * dxs + dys * dys + dzs * dzs;
  const float sdn = 1.0f / sqrtf(dist2);
  return ShadowSample{dxs * sdn, dys * sdn, dzs * sdn, dist2};
}

struct Scattered {
  float dx, dy, dz;  // the new direction
  bool reflect;      // mirror reflection: throughput *= specular color
  bool diffuse;      // the hemisphere branch (the sticky diffuse flag)
};

// scatterRay (interactions.h:94-136): a refractive material refracts
// (glm::refract, zero on total internal reflection) when Schlick's
// reflectance is below the draw r1 and reflects otherwise; any other
// material reflects when r1 < refl and else takes a cosine hemisphere
// direction (interactions.h:37-67) with two more draws. Draws r1 where
// `active`, the hemisphere pair where `active` too.
__device__ inline Scattered scatter_ray(uint32_t& seed, bool active, float dx,
                                        float dy, float dz, float nx, float ny,
                                        float nz, float m_refl, float m_refr,
                                        float m_ior) {
  const bool is_refr = m_refr != 0.f;
  const float r1 = lcg_masked(seed, active);
  const float proj = dx * nx + dy * ny + dz * nz;
  const float eta = (proj > 0.f) ? m_ior : 1.0f / m_ior;
  float r0 = (1.f - eta) / (1.f + eta);
  r0 = r0 * r0;
  const float schlick = r0 + (1.f - r0) * pow5(1.f - fabsf(proj));
  const bool do_refract = is_refr && (schlick < r1);
  Scattered o;
  o.reflect = (is_refr && !do_refract) || (!is_refr && (r1 < m_refl));
  o.diffuse = !is_refr && !(r1 < m_refl);
  if (do_refract) {
    const float k = 1.f - eta * eta * (1.f - proj * proj);
    const float fr = eta * proj + sqrtf(jmax(k, 0.f));
    const bool tir = k < 0.f;
    o.dx = tir ? 0.f : eta * dx - fr * nx;
    o.dy = tir ? 0.f : eta * dy - fr * ny;
    o.dz = tir ? 0.f : eta * dz - fr * nz;
  } else if (o.reflect) {
    const float two_d_n = 2.f * proj;
    o.dx = dx - two_d_n * nx;
    o.dy = dy - two_d_n * ny;
    o.dz = dz - two_d_n * nz;
  } else {
    const float r_up = lcg_masked(seed, active);
    const float r_ar = lcg_masked(seed, active);
    const float up = sqrtf(r_up);
    const float over = sqrtf(1.f - up * up);
    const float around = r_ar * kTwoPi;
    // directionNotNormal (interactions.h:49-56)
    const bool use_x = fabsf(nx) < kSqrtOneThird;
    const bool use_y = !use_x && (fabsf(ny) < kSqrtOneThird);
    const float dnnx = use_x ? 1.f : 0.f;
    const float dnny = use_y ? 1.f : 0.f;
    const float dnnz = (!use_x && !use_y) ? 1.f : 0.f;
    float p1x = ny * dnnz - nz * dnny;
    float p1y = nz * dnnx - nx * dnnz;
    float p1z = nx * dnny - ny * dnnx;
    const float p1n = 1.0f / sqrtf(p1x * p1x + p1y * p1y + p1z * p1z);
    p1x = p1x * p1n;
    p1y = p1y * p1n;
    p1z = p1z * p1n;
    float p2x = ny * p1z - nz * p1y;
    float p2y = nz * p1x - nx * p1z;
    float p2z = nx * p1y - ny * p1x;
    const float p2n = 1.0f / sqrtf(p2x * p2x + p2y * p2y + p2z * p2z);
    p2x = p2x * p2n;
    p2y = p2y * p2n;
    p2z = p2z * p2n;
    const float ca = cosf(around) * over;
    const float sa = sinf(around) * over;
    o.dx = up * nx + ca * p1x + sa * p2x;
    o.dy = up * ny + ca * p1y + sa * p2y;
    o.dz = up * nz + ca * p1z + sa * p2z;
  }
  return o;
}

// The plane layouts of a bounce's shading (ops/pallas/shade.py:35-43):
// 22 input planes, 21 output planes, masks as 0.0 / 1.0.
enum ShadeIn {
  I_OX, I_OY, I_OZ, I_DX, I_DY, I_DZ, I_T, I_NX, I_NY, I_NZ,
  I_AR, I_AG, I_AB, I_TR, I_TG, I_TB, I_RR, I_RG, I_RB,
  I_MAT, I_ACT, I_DIF, kShadeIn
};
enum ShadeOut {
  O_DX, O_DY, O_DZ, O_SPX, O_SPY, O_SPZ, O_TR, O_TG, O_TB,
  O_RR, O_RG, O_RB, O_DIF, O_ACT, O_SDX, O_SDY, O_SDZ,
  O_CR, O_CG, O_CB, O_NEE, kShadeOut
};

struct ShadeParams {
  const float* mats;  // (M, 16): scene.mat_attr
  int shadow_ray;
  int reduce_var;
  int alb_skip;
  float light_x, light_y, light_z;
  float lrad;
  float sint;
};

// Native mode's lights (compat=False, more than one emissive geom): per
// light its translation, its color x emittance and its geom, a row of
// kLightRow floats (x, y, z, r, g, b, geom, 0), k rows in light order
// (ops/cuda/shade.py:light_table)
constexpr int kLightRow = 8;
struct LightTable {
  const float* rows;
  int k;
};

// One lane's shading of a bounce (shade.py:shade_tiles): `in` points at
// the lane's value of input plane 0, plane k lies at in[k * n]; `seed` is
// the lane's TEA seed. Emissive termination, albedo modulation, the NEE
// disk sample and scatterRay; every output is computed, dead lanes
// included, as the plain version (ops/bsdf.py:shade) computes it.
//
// With Table (kernel E's light-table entry, native mode's uniform light
// selection, ptdn_tpu/engine/wavefront.py:1321-1345) the NEE lane first
// draws the light, li = min(int(r * k), k - 1), samples the disk about
// light li's translation, and weights its contribution by li's color x
// emittance and by k in the JAX oracle's order, (t * e) * ((k * I) *
// lambert); li goes to *li_out. Without it the code is the single
// light's (shade_lane).
template <bool Table>
__device__ inline void shade_lane_of(const float* in, size_t n,
                                     uint32_t seed, const ShadeParams& a,
                                     float (&out)[kShadeOut],
                                     const LightTable& lights,
                                     float* li_out) {
  const float ox = in[I_OX * n], oy = in[I_OY * n], oz = in[I_OZ * n];
  const float dx = in[I_DX * n], dy = in[I_DY * n], dz = in[I_DZ * n];
  const float t = in[I_T * n];
  const float nx = in[I_NX * n], ny = in[I_NY * n], nz = in[I_NZ * n];
  float tr = in[I_TR * n], tg = in[I_TG * n], tb = in[I_TB * n];
  const int mat = (int)in[I_MAT * n];
  bool active = in[I_ACT * n] > 0.5f;
  const bool dif = in[I_DIF * n] > 0.5f;
  const float* m = a.mats + 16 * mat;
  const float m_emit = m[10], m_refl = m[7], m_refr = m[8], m_ior = m[9];

  // emissive hit terminates; skipped for NEE'd diffuse paths
  const bool emissive = m_emit > 0.f;
  bool add_emit = active && emissive;
  if (a.shadow_ray && a.reduce_var) add_emit = add_emit && !dif;
  const float add_f = add_emit ? 1.f : 0.f;
  const float rr = in[I_RR * n] + add_f * tr * m[0] * m_emit;
  const float rg = in[I_RG * n] + add_f * tg * m[1] * m_emit;
  const float rb = in[I_RB * n] + add_f * tb * m[2] * m_emit;
  active = active && !emissive;

  // hit point + spawn origin (+1e-4 n, pathtrace.cu:338)
  const float spx = (ox + t * dx) + 1e-4f * nx;
  const float spy = (oy + t * dy) + 1e-4f * ny;
  const float spz = (oz + t * dz) + 1e-4f * nz;

  // throughput *= albedo (pathtrace.cu:343-355)
  const float af = (active && !a.alb_skip) ? 1.f : 0.f;
  tr = tr * (1.f + af * (in[I_AR * n] - 1.f));
  tg = tg * (1.f + af * (in[I_AG * n] - 1.f));
  tb = tb * (1.f + af * (in[I_AB * n] - 1.f));

  // NEE disk sample toward the light (pathtrace.cu:357-366)
  float sdx = 0.f, sdy = 0.f, sdz = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
  bool nee = false;
  if (a.shadow_ray) {
    nee = active && (m_refl < 1e-6f) && (m_refr < 1e-6f);
    if constexpr (Table) {
      const float r_sel = lcg_masked(seed, nee);
      const int li = min((int)(r_sel * (float)lights.k), lights.k - 1);
      const float* l = lights.rows + kLightRow * li;
      const ShadowSample ss = shadow_sample(seed, nee, l[0], l[1], l[2],
                                            a.lrad, spx, spy, spz);
      const float lambert = jmax(0.f, ss.dx * nx + ss.dy * ny + ss.dz * nz);
      const float scale = (float)lights.k * (a.sint / ss.dist2) * lambert;
      const float neef = nee ? 1.f : 0.f;
      sdx = ss.dx;
      sdy = ss.dy;
      sdz = ss.dz;
      cr = tr * l[3] * scale * neef;
      cg = tg * l[4] * scale * neef;
      cb = tb * l[5] * scale * neef;
      *li_out = (float)li;
    } else {
      const ShadowSample ss = shadow_sample(seed, nee, a.light_x, a.light_y,
                                            a.light_z, a.lrad, spx, spy,
                                            spz);
      const float lambert = jmax(0.f, ss.dx * nx + ss.dy * ny + ss.dz * nz);
      const float scale = a.sint / ss.dist2 * lambert;
      const float neef = nee ? 1.f : 0.f;
      sdx = ss.dx;
      sdy = ss.dy;
      sdz = ss.dz;
      cr = tr * scale * neef;
      cg = tg * scale * neef;
      cb = tb * scale * neef;
    }
  }

  // scatterRay (interactions.h:94-136)
  const Scattered sc = scatter_ray(seed, active, dx, dy, dz, nx, ny, nz,
                                   m_refl, m_refr, m_ior);
  const float rff = (active && sc.reflect) ? 1.f : 0.f;
  const float actf = active ? 1.f : 0.f;
  out[O_DX] = actf * sc.dx + (1.f - actf) * dx;
  out[O_DY] = actf * sc.dy + (1.f - actf) * dy;
  out[O_DZ] = actf * sc.dz + (1.f - actf) * dz;
  out[O_SPX] = actf * spx + (1.f - actf) * ox;
  out[O_SPY] = actf * spy + (1.f - actf) * oy;
  out[O_SPZ] = actf * spz + (1.f - actf) * oz;
  out[O_TR] = active ? tr * (1.f + rff * (m[3] - 1.f)) : tr;
  out[O_TG] = active ? tg * (1.f + rff * (m[4] - 1.f)) : tg;
  out[O_TB] = active ? tb * (1.f + rff * (m[5] - 1.f)) : tb;
  out[O_RR] = rr;
  out[O_RG] = rg;
  out[O_RB] = rb;
  out[O_DIF] = (dif || (active && sc.diffuse)) ? 1.f : 0.f;
  out[O_ACT] = actf;
  out[O_SDX] = sdx;
  out[O_SDY] = sdy;
  out[O_SDZ] = sdz;
  out[O_CR] = cr;
  out[O_CG] = cg;
  out[O_CB] = cb;
  out[O_NEE] = nee ? 1.f : 0.f;
}

// The single light's lane, kernels E (shade.cu) and H (bounce.cuh): a
// function of its own with its own signature, so that the table entry
// leaves their code as it was
__device__ inline void shade_lane(const float* in, size_t n, uint32_t seed,
                                  const ShadeParams& a,
                                  float (&out)[kShadeOut]) {
  shade_lane_of<false>(in, n, seed, a, out, LightTable{}, nullptr);
}

}  // namespace ptdn
