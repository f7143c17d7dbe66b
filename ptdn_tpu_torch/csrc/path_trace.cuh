// Kernel B1 (path_trace): the whole bounce loop of a frame, one thread per
// pixel. This header holds its body, which two builds share:
//
// * csrc/scene/path_trace.cu, built once per scene with the scene's baked
//   rows, geom types and materials as constants (SceneRows; the fast
//   build, for every scene within its limits);
// * csrc/path_trace_table.cu, built once into the kernel library, which
//   reads the same forms and coefficients from a table in device memory
//   (TableRows), for the scenes past the per-scene build's limits.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/path.py:
// path_trace_fused_pallas (_kernel, inlining shade.py:shade_tiles and
// scene_intersect.py's closest-hit, visibility and texel-index code).
// One thread per pixel keeps its path in registers through every depth:
// TEA reseed on (pixel + lane0, frame + depth), shade (shade.cuh: emissive
// termination with reduce-var and the sticky diffuse flag, albedo, NEE
// disk sample, scatter), NEE visibility toward light geom 0, next
// closest hit and next albedo from the material table (1.0 on textured
// lanes). Per depth it writes the emissive and the lit NEE contribution
// to a (6*depth, N) plane stack and, per depth below the last, the flat
// texel index of the next albedo to a (depth-1, N) int plane (-1 where
// untextured). The TPU kernel compacted those indices per 4096-lane tile
// because TPU gathers are count-bound; a GPU gathers one word per thread
// at no such cost, so the indices stay plain per-lane. B2
// (csrc/path.cu) rebuilds the radiance from them.
//
// The analytic tests take the whole-path kernel's baked row dots, which
// the TPU kernel gets by baking the scene matrices into its code
// (scene_intersect.py:_row_dot, static=True): each baked row resolved on
// the host into the one expression its nonzero terms leave
// (ops/intersect.py:baked_row_form: a constant, a lone product, one fma,
// or two or three terms with or without a bias) with its coefficients.
// A row policy (ptdn.cuh:MatRows has the interface, plus mat_attr here)
// brings the forms and the material table; both policies evaluate a row
// with form_row, so the two builds compute the same bits.
#pragma once

#include "shade.cuh"

namespace ptdn {

struct PathArgs {
  const float* o;              // (N, 3) primary ray origins
  const float* d;              // (N, 3) primary ray directions
  const float* t;              // (N,) primary hit distance
  const float* nrm;            // (N, 3) primary hit normal
  const float* alb;            // (N, 3) primary albedo (textures resolved)
  const int* mat;              // (N,) primary material id
  const unsigned char* act;    // (N,) primary hit flag
  float* contrib;              // (6 * depth, N)
  int* texidx;                 // (depth - 1, N)
  int n;
  int depth;
  unsigned int frame;
  unsigned int lane0;
  int light_geom;
  int shadow_ray;
  int reduce_var;
  int do_vis;
  int alb_skip1;
  int show_tex;
  float light_x, light_y, light_z;
  float lrad;
  float sint;
  float emit_r, emit_g, emit_b;
};

// The forms of a baked row (ops/intersect.py:baked_row_form)
enum {
  kConst, kMulX, kMulY, kMulZ, kFmaX, kFmaY, kFmaZ, kTwo, kTwoB, kThree,
  kThreeB
};

}  // namespace ptdn

namespace {

__device__ __forceinline__ float pick(int slot, float x, float y, float z) {
  return slot == 0 ? x : (slot == 1 ? y : z);
}

// A baked row by its form (ops/intersect.py:form_value, in the same
// order): only the form's own operations, which equal the three-term
// plan fma(c2, v[s2], fma(c0, v[s0], c1 * v[s1])) + c3 bit for bit. With
// the scene's constants the code and coefficients are known when the
// kernel is built, and this folds to the form's own instructions.
__device__ __forceinline__ float form_row(int code, const float* c, float x,
                                          float y, float z) {
  switch (code & 15) {
    case ptdn::kConst: return c[3];
    case ptdn::kMulX: return c[0] * x;
    case ptdn::kMulY: return c[0] * y;
    case ptdn::kMulZ: return c[0] * z;
    case ptdn::kFmaX: return fmaf(c[0], x, c[3]);
    case ptdn::kFmaY: return fmaf(c[0], y, c[3]);
    case ptdn::kFmaZ: return fmaf(c[0], z, c[3]);
    default: {
      const int f = code & 15;
      float acc = fmaf(c[0], pick((code >> 4) & 3, x, y, z),
                       c[1] * pick((code >> 6) & 3, x, y, z));
      if (f >= ptdn::kThree)
        acc = fmaf(c[2], pick((code >> 8) & 3, x, y, z), acc);
      return (f == ptdn::kTwoB || f == ptdn::kThreeB) ? acc + c[3] : acc;
    }
  }
}

// o - the baked row of form `code`: a lone product fuses into o - row, as
// XLA contracts c - a*b into fma(-a, b, c).
__device__ __forceinline__ float form_sub_row(int code, const float* c,
                                              float o, float x, float y,
                                              float z) {
  switch (code) {
    case ptdn::kMulX: return fmaf(-c[0], x, o);
    case ptdn::kMulY: return fmaf(-c[0], y, o);
    case ptdn::kMulZ: return fmaf(-c[0], z, o);
    default: return o - form_row(code, c, x, y, z);
  }
}

// The bounce loop of pixel i under the row policy Rows.
template <class Rows>
__device__ __forceinline__ void path_trace_lane(const ptdn::SceneDev& s,
                                                const ptdn::PathArgs& a,
                                                int i) {
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  float ox = a.o[3 * i], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
  float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
  float t = a.t[i];
  float nx = a.nrm[3 * i], ny = a.nrm[3 * i + 1], nz = a.nrm[3 * i + 2];
  float ar = a.alb[3 * i], ag = a.alb[3 * i + 1], ab = a.alb[3 * i + 2];
  int mat = a.mat[i];
  bool active = a.act[i] != 0;
  bool diffuse_flag = false;
  float tr = 1.f, tg = 1.f, tb = 1.f;

  for (int dd = 1; dd <= a.depth; ++dd) {
    float* cp = a.contrib + 6 * (size_t)(dd - 1) * n + i;
    if (!active) {
      // a dead lane contributes nothing at this or any later depth
      for (int k = 0; k < 6 * (a.depth - dd + 1); ++k) cp[k * n] = 0.f;
      for (int k = dd - 1; k < a.depth - 1; ++k) a.texidx[k * n + i] = -1;
      return;
    }
    uint32_t seed = ptdn::tea16((uint32_t)i + a.lane0, a.frame + (uint32_t)dd);
    const float m_emit = Rows::mat_attr(s, mat, 10),
                m_refl = Rows::mat_attr(s, mat, 7),
                m_refr = Rows::mat_attr(s, mat, 8),
                m_ior = Rows::mat_attr(s, mat, 9);

    // emissive hit terminates; skipped for NEE'd diffuse paths
    const bool emissive = m_emit > 0.f;
    bool add_emit = emissive;
    if (a.shadow_ray && a.reduce_var) add_emit = add_emit && !diffuse_flag;
    const float add_f = add_emit ? 1.f : 0.f;
    cp[0] = add_f * tr * Rows::mat_attr(s, mat, 0) * m_emit;
    cp[n] = add_f * tg * Rows::mat_attr(s, mat, 1) * m_emit;
    cp[2 * n] = add_f * tb * Rows::mat_attr(s, mat, 2) * m_emit;
    active = !emissive;

    // hit point + spawn origin (+1e-4 n, pathtrace.cu:338)
    const float spx = (ox + t * dx) + 1e-4f * nx;
    const float spy = (oy + t * dy) + 1e-4f * ny;
    const float spz = (oz + t * dz) + 1e-4f * nz;

    // throughput *= albedo (pathtrace.cu:343-355)
    const float af = (active && !(dd == 1 && a.alb_skip1)) ? 1.f : 0.f;
    tr = tr * (1.f + af * (ar - 1.f));
    tg = tg * (1.f + af * (ag - 1.f));
    tb = tb * (1.f + af * (ab - 1.f));

    // NEE disk sample toward light geom 0 (pathtrace.cu:284-297, 357-385)
    const bool mat_is_diffuse = (m_refl < 1e-6f) && (m_refr < 1e-6f);
    const bool nee = a.shadow_ray && active && mat_is_diffuse;
    float lit_r = 0.f, lit_g = 0.f, lit_b = 0.f;
    if (nee) {
      const ptdn::ShadowSample ss = ptdn::shadow_sample(
          seed, true, a.light_x, a.light_y, a.light_z, a.lrad, spx, spy, spz);
      const float lambert =
          ptdn::jmax(0.f, ss.dx * nx + ss.dy * ny + ss.dz * nz);
      const float scale = a.sint / ss.dist2 * lambert;
      if (a.do_vis &&
          ptdn::light_visible<Rows>(s, a.light_geom, spx, spy, spz, ss.dx,
                                    ss.dy, ss.dz)) {
        lit_r = tr * scale * 1.f * a.emit_r;
        lit_g = tg * scale * 1.f * a.emit_g;
        lit_b = tb * scale * 1.f * a.emit_b;
      }
    }
    cp[3 * n] = lit_r;
    cp[4 * n] = lit_g;
    cp[5 * n] = lit_b;
    if (dd == a.depth) break;
    if (!active) {
      a.texidx[(dd - 1) * n + i] = -1;
      continue;
    }

    // scatterRay (interactions.h:94-136)
    const ptdn::Scattered sc = ptdn::scatter_ray(seed, true, dx, dy, dz, nx,
                                                 ny, nz, m_refl, m_refr,
                                                 m_ior);
    if (sc.reflect) {
      tr = tr * (1.f + 1.f * (Rows::mat_attr(s, mat, 3) - 1.f));
      tg = tg * (1.f + 1.f * (Rows::mat_attr(s, mat, 4) - 1.f));
      tb = tb * (1.f + 1.f * (Rows::mat_attr(s, mat, 5) - 1.f));
    }
    diffuse_flag = diffuse_flag || sc.diffuse;

    // the blend act * new + (1 - act) * old of the plain version, kept
    // for its signed-zero result (1/d feeds the slab tests)
    ox = spx + 0.f * ox;
    oy = spy + 0.f * oy;
    oz = spz + 0.f * oz;
    dx = sc.dx + 0.f * dx;
    dy = sc.dy + 0.f * dy;
    dz = sc.dz + 0.f * dz;

    // next closest hit and next albedo
    const ptdn::Hit h = ptdn::closest_hit<Rows>(s, ox, oy, oz, dx, dy, dz,
                                                true);
    active = h.geom >= 0;
    int tidx = -1;
    if (active) {
      ar = Rows::mat_attr(s, h.mat, 0);
      ag = Rows::mat_attr(s, h.mat, 1);
      ab = Rows::mat_attr(s, h.mat, 2);
      if (a.show_tex)
        tidx = ptdn::tex_index_of(s, (int)Rows::mat_attr(s, h.mat, 11), h.u,
                                  h.v);
      if (tidx >= 0) ar = ag = ab = 1.f;
    }
    a.texidx[(dd - 1) * n + i] = tidx;
    t = h.t;
    nx = h.nx;
    ny = h.ny;
    nz = h.nz;
    mat = h.mat;
  }
}

}  // namespace
