// Kernels B1 (path_trace) and B2 (deferred_radiance): the whole bounce
// loop of a frame, and the rebuild of its radiance.
//
// B1 replaces the TPU kernel ptdn_tpu/ops/pallas/path.py:
// path_trace_fused_pallas (_kernel, inlining shade.py:shade_tiles and
// scene_intersect.py's closest-hit, visibility and texel-index code).
// One thread per pixel keeps its path in registers through every depth:
// TEA reseed on (pixel + lane0, frame + depth), shade (shade.cuh: emissive
// termination with reduce-var and the sticky diffuse flag, albedo, NEE
// disk sample, scatter), NEE visibility toward light geom 0, next
// closest hit and next albedo from the material table (1.0 on textured
// lanes). The analytic tests take the whole-path kernel's baked row dots
// (ptdn.cuh:planned), as the TPU kernel bakes the scene matrices.
// Per depth it writes the emissive and the lit NEE contribution
// to a (6*depth, N) plane stack and, per depth below the last, the flat
// texel index of the next albedo to a (depth-1, N) int plane (-1 where
// untextured). The TPU kernel compacted those indices per 4096-lane tile
// because TPU gathers are count-bound; a GPU gathers one word per thread
// at no such cost, so the indices stay plain per-lane.
//
// B2 replaces uncompact_tiles_pallas (path.py:239) together with the
// gather ladder of engine/wavefront.py:packed_texel_gather and
// deferred_radiance: one thread per pixel fetches its texels for depths
// >= 2 and rebuilds the radiance with deferred_radiance's running
// product, in its order (wavefront.py:441-454).
//
// What bounds them: B1 is arithmetic and divergence (per depth ~2 x 10
// analytic geom tests and up to 2 x 38 triangles per lane on cornell,
// with lanes of a warp on different materials); its traffic is ~100 B
// in and 24 B per depth out per pixel. B2 moves ~(6*4 + 4) B per depth
// per pixel and is bound by device memory bandwidth.
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

}  // namespace ptdn

namespace {

__global__ void path_trace_kernel(ptdn::SceneDev s, ptdn::PathArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
    const float* m = s.mat_attr + 16 * mat;
    const float m_emit = m[10], m_refl = m[7], m_refr = m[8], m_ior = m[9];

    // emissive hit terminates; skipped for NEE'd diffuse paths
    const bool emissive = m_emit > 0.f;
    bool add_emit = emissive;
    if (a.shadow_ray && a.reduce_var) add_emit = add_emit && !diffuse_flag;
    const float add_f = add_emit ? 1.f : 0.f;
    cp[0] = add_f * tr * m[0] * m_emit;
    cp[n] = add_f * tg * m[1] * m_emit;
    cp[2 * n] = add_f * tb * m[2] * m_emit;
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
          ptdn::light_visible<true>(s, a.light_geom, spx, spy, spz, ss.dx,
                                    ss.dy, ss.dz, ptdn::all_chunks(s))) {
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
      tr = tr * (1.f + 1.f * (m[3] - 1.f));
      tg = tg * (1.f + 1.f * (m[4] - 1.f));
      tb = tb * (1.f + 1.f * (m[5] - 1.f));
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
    const ptdn::Hit h = ptdn::closest_hit<true>(
        s, ox, oy, oz, dx, dy, dz, true, ptdn::all_chunks(s));
    active = h.geom >= 0;
    int tidx = -1;
    if (active) {
      const float* mn = s.mat_attr + 16 * h.mat;
      ar = mn[0];
      ag = mn[1];
      ab = mn[2];
      if (a.show_tex) tidx = ptdn::tex_index(s, h.mat, h.u, h.v);
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

__global__ void deferred_radiance_kernel(const float* __restrict__ contrib,
                                         const int* __restrict__ texidx,
                                         const uint32_t* __restrict__ tex,
                                         int n_, int depth,
                                         float* __restrict__ rad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_) return;
  const size_t n = (size_t)n_;
  float cum[3] = {1.f, 1.f, 1.f};
  float r[3] = {0.f, 0.f, 0.f};
  for (int dd = 1; dd <= depth; ++dd) {
    const float* cp = contrib + 6 * (size_t)(dd - 1) * n + i;
    for (int c = 0; c < 3; ++c) r[c] = r[c] + cp[c * n] * cum[c];
    // depth-1 albedo is the exact primary albedo; ratios start at 2
    if (dd >= 2) {
      const int idx = texidx[(dd - 2) * n + i];
      if (idx >= 0) {
        const uint32_t texel = tex[idx];
        for (int c = 0; c < 3; ++c)
          cum[c] = cum[c] * ptdn::texel_channel(texel, c);
      }
    }
    for (int c = 0; c < 3; ++c) r[c] = r[c] + cp[(3 + c) * n] * cum[c];
  }
  rad[3 * i] = r[0];
  rad[3 * i + 1] = r[1];
  rad[3 * i + 2] = r[2];
}

}  // namespace

extern "C" int ptdn_path_trace(const ptdn::SceneDev* s, const ptdn::PathArgs* a,
                               void* stream) {
  if (a->n > 0) {
    const int block = 128;
    path_trace_kernel<<<(a->n + block - 1) / block, block, 0,
                        (cudaStream_t)stream>>>(*s, *a);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptdn_deferred_radiance(const float* contrib, const int* texidx,
                                      const uint32_t* tex, int n, int depth,
                                      float* rad, void* stream) {
  if (n > 0) {
    const int block = 256;
    deferred_radiance_kernel<<<(n + block - 1) / block, block, 0,
                               (cudaStream_t)stream>>>(contrib, texidx, tex,
                                                       n, depth, rad);
  }
  return (int)cudaGetLastError();
}
