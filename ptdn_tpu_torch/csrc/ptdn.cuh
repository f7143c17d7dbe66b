// Shared device math for the path tracer's CUDA kernels: the reference's
// TEA seed hash, the analytic cube/sphere tests, the
// Moller-Trumbore triangle scan over 128-triangle chunks, the
// attribute refine, the fully resolved closest hit and the NEE shadow-ray
// visibility. The kernels use them (B1 its own bounce loop on them, with
// the per-lane walks mesh_best and light_visible, which serve B1 alone;
// F, H, A, J, I and M their analytic tests, Moller test and refine
// around chunk_scan.cuh's block-level scan), so the primary hit and
// every bounce run the same code.
//
// Each function is the per-thread form of the JAX package's fused TPU
// code (ptdn_tpu/ops/pallas/scene_intersect.py: _one_geom, _row_dot,
// _mesh_best, joint_mesh_tiles, _mesh_attr_refine, closest_hit_tiles,
// light_visibility_tiles, tex_index_tiles; ptdn_tpu/ops/pallas/shade.py:
// _tea) and of the plain PyTorch version in
// ptdn_tpu_torch/ops/intersect.py, with the
// operations in the same order. The build passes no fast-math flag and
// --fmad=false: divisions and square roots are IEEE, a multiply and an add
// are fused exactly where the plain version (ops/fp.py) fuses them, and
// rsqrtf is used exactly where the JAX package's default FAST_NORM knob
// uses rsqrt.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ptdn {

constexpr float kFltMax = 3.402823466e38f;
constexpr float kFltEpsilon = 1.1920929e-07f;
constexpr float kBackoff = 1e-4f;
constexpr int kSphere = 0;
constexpr int kCube = 1;
constexpr int kMesh = 2;
constexpr int kChunk = 128;

// Scene tensors (DeviceScene fields) and counts, filled by the Python
// wrapper (ops/cuda/_lib.py:SceneDev) and passed to kernels by value.
struct SceneDev {
  const float* tf;          // (G, 4, 4) geom_transform
  const float* inv;         // (G, 4, 4) geom_inverse
  const float* invt;        // (G, 4, 4) geom_inv_transpose
  const int* geom;          // (G, 2) type (SPHERE / CUBE / MESH), material
  const float* tri_moller;  // (Tp, 12) v0, e1, e2, pad
  const float* chunk_min;   // (5C, 3) rows [0, C): chunk AABBs
  const float* chunk_max;
  const float* tri_attr;    // (Tp, 32) v0 v1 v2 n0 n1 n2 uv0 uv1 uv2 geom mat
  const float* mat_attr;    // (M, 16) color, spec color, ex, refl, refr, ior, emit, texid
  const int* tex_wh;        // (K, 2) texture (w, h)
  const uint32_t* tex_flat; // (K*Hm*Wm,) r | g << 8 | b << 16
  const int* row_code;      // (G, 16) B1's table build: per geom a head
                            // word, then its 15 baked row forms
  const float* row_coef;    // (G, 17, 4): per geom its world box's lo and
                            // hi, then its 15 rows' coefficients
  int n_geoms;
  int n_tris;
  int n_chunks;
  int tex_h;                // Hm, Wm: the padded atlas size
  int tex_w;
};

// NaN-propagating min/max, as jnp.minimum / torch.minimum
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}

// ---- random streams (interactions.h:10-30) ----
__device__ __forceinline__ uint32_t tea16(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0u;
  for (int k = 0; k < 16; ++k) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// a0*b0 + a1*b1 + a2*b2 contracted as XLA does on the CPU, where the
// reference renders come from: fma(a2, b2, fma(a0, b0, a1*b1))
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

// The rows of an analytic geom's matrices that its test dots with
// (x, y, z, 1) or (x, y, z): per geom five kinds of three rows each,
// the inverse with and without its translation, the transform with and
// without it, and the inverse transpose.
enum { kInvBias, kInv, kTfBias, kTf, kInvT, kKinds };

// The row dots of the analytic tests are a policy: MatRows takes the
// full dot products of the scene matrices (closest_hit_tiles without
// static_mats), for A, F, H, I, J and M; kernel B1 brings its own, the
// whole-path kernel's baked rows, as constants of a per-scene build
// (csrc/scene/path_trace.cu:SceneRows) or from a table
// (csrc/path_trace_table.cu:TableRows).
// A policy has
//   kGeoms: the scene's geom count if the kernel is built for one scene,
//     else 0;
//   kCompat: compat mode's mesh normals (resolve_hit): a build's
//     constant, so that a compat build compiles to the code it had before
//     native mode existed;
//   type(s, g), mat(s, g): geom g's type and material;
//   row(s, g, kind, r, x, y, z): row r of `kind` at (x, y, z);
//   sub_row(s, g, kind, r, o, x, y, z): o - that row (a biased kind).
struct MatRows {
  static constexpr int kGeoms = 0;   // the scene's count, s.n_geoms
  static constexpr bool kCompat = true;
  __device__ static __forceinline__ int type(const SceneDev& s, int g) {
    return s.geom[2 * g];
  }
  __device__ static __forceinline__ int mat(const SceneDev& s, int g) {
    return s.geom[2 * g + 1];
  }
  __device__ static __forceinline__ float row(const SceneDev& s, int g,
                                              int kind, int r, float x,
                                              float y, float z) {
    const float* m = (kind <= kInv ? s.inv : (kind <= kTf ? s.tf : s.invt))
                     + 16 * g + 4 * r;
    const float e = dot3(m[0], m[1], m[2], x, y, z);
    return (kind == kInvBias || kind == kTfBias) ? e + m[3] : e;
  }
  __device__ static __forceinline__ float sub_row(const SceneDev& s, int g,
                                                  int kind, int r, float o,
                                                  float x, float y,
                                                  float z) {
    return o - row(s, g, kind, r, x, y, z);
  }
};

// MatRows in native mode (compat=False): true barycentric normals
struct MatRowsNative : MatRows {
  static constexpr bool kCompat = false;
};

// The full dot product of a 4x4 matrix row with (x, y, z, 1), outside the
// analytic tests (csrc/reproject.cu)
__device__ __forceinline__ float row4(const float* m, int r, float x, float y,
                                      float z) {
  return dot3(m[4 * r], m[4 * r + 1], m[4 * r + 2], x, y, z) + m[4 * r + 3];
}

struct Analytic {
  float t;      // FLT_MAX when no analytic geom is hit
  int geom;     // -1 when none
  float nx, ny, nz;
};

// One analytic geom's test (_one_geom) and its strict-< update of the
// closest hit b, with the row dots of the policy Rows.
template <class Rows>
__device__ __forceinline__ void analytic_geom(const SceneDev& s, int gi,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              bool want_normals,
                                              Analytic& b) {
  const int gt = Rows::type(s, gi);
  if (gt == kMesh) return;
  const float qox = Rows::row(s, gi, kInvBias, 0, ox, oy, oz);
  const float qoy = Rows::row(s, gi, kInvBias, 1, ox, oy, oz);
  const float qoz = Rows::row(s, gi, kInvBias, 2, ox, oy, oz);
  float qdx = Rows::row(s, gi, kInv, 0, dx, dy, dz);
  float qdy = Rows::row(s, gi, kInv, 1, dx, dy, dz);
  float qdz = Rows::row(s, gi, kInv, 2, dx, dy, dz);
  const float qn = rsqrtf(dot3(qdx, qdy, qdz, qdx, qdy, qdz));
  qdx = qdx * qn;
  qdy = qdy * qn;
  qdz = qdz * qn;
  float t_obj, nox = 0.f, noy = 0.f, noz = 0.f;
  bool hit, inside;
  if (gt == kCube) {
    // slab test (intersections.h:50-92), one reciprocal per axis
    const float qo[3] = {qox, qoy, qoz};
    const float qd[3] = {qdx, qdy, qdz};
    float tmin = -1e38f, tmax = 1e38f;
    float tminn[3] = {0.f, 0.f, 0.f}, tmaxn[3] = {0.f, 0.f, 0.f};
    for (int ax = 0; ax < 3; ++ax) {
      const float rq = 1.0f / qd[ax];
      const float t1 = (-0.5f - qo[ax]) * rq;
      const float t2 = (0.5f - qo[ax]) * rq;
      const float ta = jmin(t1, t2);
      const float tb = jmax(t1, t2);
      const float ns = (t2 < t1) ? 1.f : -1.f;
      if ((ta > 0.f) && (ta > tmin)) {
        tmin = ta;
        for (int k = 0; k < 3; ++k) tminn[k] = (k == ax) ? ns : 0.f;
      }
      if (tb < tmax) {
        tmax = tb;
        for (int k = 0; k < 3; ++k) tmaxn[k] = (k == ax) ? ns : 0.f;
      }
    }
    hit = (tmax >= tmin) && (tmax > 0.f);
    inside = tmin <= 0.f;
    t_obj = inside ? tmax : tmin;
    nox = inside ? tmaxn[0] : tminn[0];
    noy = inside ? tmaxn[1] : tminn[1];
    noz = inside ? tmaxn[2] : tminn[2];
  } else {
    // sphere of radius 0.5 (intersections.h:104-146)
    const float vdot = dot3(qox, qoy, qoz, qdx, qdy, qdz);
    const float radicand =
        fmaf(vdot, vdot, -(dot3(qox, qoy, qoz, qox, qoy, qoz) - 0.25f));
    const float sq = sqrtf(jmax(radicand, 0.f));
    const float t1 = -vdot + sq;
    const float t2 = -vdot - sq;
    const bool both_neg = (t1 < 0.f) && (t2 < 0.f);
    const bool both_pos = (t1 > 0.f) && (t2 > 0.f);
    inside = !both_pos;
    t_obj = both_pos ? jmin(t1, t2) : jmax(t1, t2);
    hit = (radicand >= 0.f) && !both_neg;
  }
  // object-space hit point with the 1e-4 backoff, world distance
  const float pox = fmaf(t_obj - kBackoff, qdx, qox);
  const float poy = fmaf(t_obj - kBackoff, qdy, qoy);
  const float poz = fmaf(t_obj - kBackoff, qdz, qoz);
  const float ex = Rows::sub_row(s, gi, kTfBias, 0, ox, pox, poy, poz);
  const float ey = Rows::sub_row(s, gi, kTfBias, 1, oy, pox, poy, poz);
  const float ez = Rows::sub_row(s, gi, kTfBias, 2, oz, pox, poy, poz);
  const float t_world = sqrtf(dot3(ex, ey, ez, ex, ey, ez));
  if (!(hit && (t_world > 0.f) && (t_world < b.t))) return;
  b.t = t_world;
  b.geom = gi;
  if (!want_normals) return;
  float nwx, nwy, nwz;
  if (gt == kCube) {
    // normal via transform (reference quirk, intersections.h:88)
    nwx = Rows::row(s, gi, kTf, 0, nox, noy, noz);
    nwy = Rows::row(s, gi, kTf, 1, nox, noy, noz);
    nwz = Rows::row(s, gi, kTf, 2, nox, noy, noz);
  } else {
    const float flip = inside ? -1.f : 1.f;
    nwx = Rows::row(s, gi, kInvT, 0, pox, poy, poz) * flip;
    nwy = Rows::row(s, gi, kInvT, 1, pox, poy, poz) * flip;
    nwz = Rows::row(s, gi, kInvT, 2, pox, poy, poz) * flip;
  }
  const float nn = rsqrtf(dot3(nwx, nwy, nwz, nwx, nwy, nwz));
  b.nx = nwx * nn;
  b.ny = nwy * nn;
  b.nz = nwz * nn;
}

// Closest analytic hit over the scene's cubes and spheres in scene
// order, strict < (first geom wins a tie): _analytic_part. A policy that
// knows the scene's geoms when the kernel is built (Rows::kGeoms > 0)
// has the loop unrolled over them, so that each geom's type and each
// row's form and coefficients fold into the code, as the TPU kernel's
// baked matrices do. A policy with Rows::kGeoms < 0 walks the geoms
// itself (Rows::walk, in scene order, B1's table build: a path per geom
// and a per-geom cull, csrc/path_trace_table.cu).
template <class Rows>
__device__ inline Analytic analytic_best(const SceneDev& s, float ox, float oy,
                                  float oz, float dx, float dy, float dz,
                                  bool want_normals) {
  Analytic b{kFltMax, -1, 0.f, 0.f, 0.f};
  if constexpr (Rows::kGeoms > 0) {
#pragma unroll
    for (int gi = 0; gi < Rows::kGeoms; ++gi)
      analytic_geom<Rows>(s, gi, ox, oy, oz, dx, dy, dz, want_normals, b);
  } else if constexpr (Rows::kGeoms < 0) {
    Rows::walk(s, ox, oy, oz, dx, dy, dz, want_normals, b);
  } else {
    for (int gi = 0; gi < s.n_geoms; ++gi)
      analytic_geom<Rows>(s, gi, ox, oy, oz, dx, dy, dz, want_normals, b);
  }
  return b;
}

// Slab test of the AABB [lo, hi]: does the ray o + t d (ix, iy, iz =
// 1 / d) cross it at tmin < t_lim?
__device__ __forceinline__ bool slab_crossed(const float* lo, const float* hi,
                                             float ox, float oy, float oz,
                                             float ix, float iy, float iz,
                                             float t_lim) {
  const float t0x = (lo[0] - ox) * ix, t1x = (hi[0] - ox) * ix;
  const float t0y = (lo[1] - oy) * iy, t1y = (hi[1] - oy) * iy;
  const float t0z = (lo[2] - oz) * iz, t1z = (hi[2] - oz) * iz;
  const float tmin =
      jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmin(t0z, t1z));
  const float tmax =
      jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmax(t0z, t1z));
  return (tmax >= 0.f) && (tmin <= tmax) && (tmin < t_lim);
}

// The slab test of chunk c's AABB
__device__ __forceinline__ bool chunk_crossed(const SceneDev& s, int c,
                                              float ox, float oy, float oz,
                                              float ix, float iy, float iz,
                                              float t_lim) {
  return slab_crossed(s.chunk_min + 3 * c, s.chunk_max + 3 * c, ox, oy, oz,
                      ix, iy, iz, t_lim);
}

// A triangle's tri_moller row: v0, e1, e2
struct MollerTri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ MollerTri moller_tri(const float* tri) {
  return MollerTri{tri[0], tri[1], tri[2], tri[3], tri[4],
                   tri[5], tri[6], tri[7], tri[8]};
}

// Backface-culled Moller-Trumbore of the chunk scan; true on a hit with
// t > 0, t written.
__device__ __forceinline__ bool moller(const MollerTri& m, float ox,
                                       float oy, float oz, float dx,
                                       float dy, float dz, float& t) {
  const float px = fmaf(dy, m.e2z, -(dz * m.e2y));
  const float py = fmaf(dz, m.e2x, -(dx * m.e2z));
  const float pz = fmaf(dx, m.e2y, -(dy * m.e2x));
  const float a = dot3(m.e1x, m.e1y, m.e1z, px, py, pz);
  const float f = 1.0f / a;
  const float sx = ox - m.v0x, sy = oy - m.v0y, sz = oz - m.v0z;
  const float u = f * dot3(sx, sy, sz, px, py, pz);
  const float qx = fmaf(sy, m.e1z, -(sz * m.e1y));
  const float qy = fmaf(sz, m.e1x, -(sx * m.e1z));
  const float qz = fmaf(sx, m.e1y, -(sy * m.e1x));
  const float v = f * dot3(dx, dy, dz, qx, qy, qz);
  t = f * dot3(m.e2x, m.e2y, m.e2z, qx, qy, qz);
  return (a >= kFltEpsilon) && (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
         (u + v <= 1.f) && (t > 0.f);
}

// The same test of the tri_moller row at `tri`
__device__ __forceinline__ bool moller(const float* tri, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float& t) {
  return moller(moller_tri(tri), ox, oy, oz, dx, dy, dz, t);
}

// Closest triangle: chunks in leaf order, triangles in ascending index,
// strict < against the running best seeded with the analytic winner's t
// (so the lowest index wins a tie). A chunk whose AABB the ray does not
// cross before its running best is skipped. Returns the triangle index,
// -1 if none beats bt. One thread walks its own ray's chunks: B1's walk
// (closest_hit); the other kernels scan a block's rays at once
// (chunk_scan.cuh), to the same bits.
__device__ inline int mesh_best(const SceneDev& s, float ox, float oy, float oz,
                         float dx, float dy, float dz, float& bt) {
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  int bi = -1;
  for (int c = 0; c < s.n_chunks; ++c) {
    if (!chunk_crossed(s, c, ox, oy, oz, ix, iy, iz, bt)) continue;
    const int end = min((c + 1) * kChunk, s.n_tris);
    for (int k = c * kChunk; k < end; ++k) {
      float t;
      if (moller(s.tri_moller + 12 * k, ox, oy, oz, dx, dy, dz, t) &&
          t < bt) {
        bt = t;
        bi = k;
      }
    }
  }
  return bi;
}

struct Hit {
  float t;      // -1 on a miss
  int geom;     // -1 on a miss
  float nx, ny, nz;
  float u, v;
  int mat;
};

// The closest hit from the analytic winner `a` and the mesh scan's
// winning triangle bi (-1 for none): the exact glm-parity refine of that
// triangle (_mesh_attr_refine) and the merge (mesh wins only strictly
// closer). The normal's weights are the policy's: compat mode's swapped
// ones (Rows::kCompat) or the true barycentric ones.
template <class Rows>
__device__ inline Hit resolve_hit(const SceneDev& s, const Analytic& a, int bi,
                                  float ox, float oy, float oz, float dx,
                                  float dy, float dz) {
  const bool a_valid = a.geom >= 0;
  Hit h{a_valid ? a.t : -1.f, a.geom, a.nx, a.ny, a.nz, 0.f, 0.f, 0};
  if (bi >= 0) {
    const float* r = s.tri_attr + 32 * bi;
    const float e1x = r[3] - r[0], e1y = r[4] - r[1], e1z = r[5] - r[2];
    const float e2x = r[6] - r[0], e2y = r[7] - r[1], e2z = r[8] - r[2];
    const float px = fmaf(dy, e2z, -(dz * e2y));
    const float py = fmaf(dz, e2x, -(dx * e2z));
    const float pz = fmaf(dx, e2y, -(dy * e2x));
    const float det = dot3(e1x, e1y, e1z, px, py, pz);
    const bool front = det >= kFltEpsilon;
    const float f = 1.0f / (front ? det : 1.f);
    const float sx = ox - r[0], sy = oy - r[1], sz = oz - r[2];
    const float u = f * dot3(sx, sy, sz, px, py, pz);
    const float qx = fmaf(sy, e1z, -(sz * e1y));
    const float qy = fmaf(sz, e1x, -(sx * e1z));
    const float qz = fmaf(sx, e1y, -(sy * e1x));
    const float v = f * dot3(dx, dy, dz, qx, qy, qz);
    const float t = f * dot3(e2x, e2y, e2z, qx, qy, qz);
    const bool mh = front && (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                    (u + v <= 1.f) && (t >= 0.f) && (t > 0.f);
    if (mh && (!a_valid || t < a.t)) {
      // Triangle::Intersect interpolation (sceneStructs.h:160-172): in
      // compat mode the reference's swapped normal weights n0*u + n1*v +
      // n2*w, in native mode n0*w + n1*u + n2*v
      // (ptdn_tpu/ops/pallas/scene_intersect.py:1274-1287)
      const float w = 1.0f - u - v;
      float nx, ny, nz;
      if constexpr (Rows::kCompat) {
        nx = dot3(r[9], r[12], r[15], u, v, w);
        ny = dot3(r[10], r[13], r[16], u, v, w);
        nz = dot3(r[11], r[14], r[17], u, v, w);
      } else {
        nx = dot3(r[9], r[12], r[15], w, u, v);
        ny = dot3(r[10], r[13], r[16], w, u, v);
        nz = dot3(r[11], r[14], r[17], w, u, v);
      }
      const float nn = sqrtf(dot3(nx, ny, nz, nx, ny, nz));
      h.t = t;
      h.geom = (int)r[24];
      h.nx = nx / nn;
      h.ny = ny / nn;
      h.nz = nz / nn;
      h.u = dot3(r[18], r[20], r[22], w, u, v);
      h.v = dot3(r[19], r[21], r[23], w, u, v);
    }
  }
  if (h.geom >= 0) h.mat = Rows::mat(s, h.geom);
  return h;
}

// Fully resolved closest hit (closest_hit_tiles): analytic + mesh, then
// resolve_hit, B1's per lane. A lane that is not `alive` takes no mesh
// hit (the TPU kernel starts its window at -FLT_MAX); Rows as in
// analytic_best.
template <class Rows>
__device__ inline Hit closest_hit(const SceneDev& s, float ox, float oy, float oz,
                          float dx, float dy, float dz, bool alive) {
  const Analytic a = analytic_best<Rows>(s, ox, oy, oz, dx, dy, dz, true);
  int bi = -1;
  if (s.n_tris > 0 && alive) {
    float bt = a.geom >= 0 ? a.t : kFltMax;
    bi = mesh_best(s, ox, oy, oz, dx, dy, dz, bt);
  }
  return resolve_hit<Rows>(s, a, bi, ox, oy, oz, dx, dy, dz);
}

// NEE visibility (light_visibility_tiles): the closest analytic hit is
// the light geom and no triangle occludes it (any hit with t < that
// distance), B1's per lane.
template <class Rows>
__device__ inline bool light_visible(const SceneDev& s, int light_geom, float ox,
                              float oy, float oz, float dx, float dy,
                              float dz) {
  const Analytic a = analytic_best<Rows>(s, ox, oy, oz, dx, dy, dz, false);
  if (a.geom != light_geom) return false;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  for (int c = 0; c < s.n_chunks; ++c) {
    if (!chunk_crossed(s, c, ox, oy, oz, ix, iy, iz, a.t)) continue;
    const int end = min((c + 1) * kChunk, s.n_tris);
    for (int k = c * kChunk; k < end; ++k) {
      float t;
      if (moller(s.tri_moller + 12 * k, ox, oy, oz, dx, dy, dz, t) &&
          t < a.t)
        return false;
    }
  }
  return true;
}

// Texel index of Texture::getColor (sceneStructs.h:208-221): nearest
// texel with the V flip into the flat packed atlas; -1 if untextured
// (texid < 0).
__device__ __forceinline__ int tex_index_of(const SceneDev& s, int texid,
                                            float u, float v) {
  if (texid < 0) return -1;
  const float w = (float)s.tex_wh[2 * texid];
  const float h = (float)s.tex_wh[2 * texid + 1];
  int x = __float2int_rz(jmin(w * u, w - 1.0f));
  int y = __float2int_rz(jmin(h * (1.0f - v), h - 1.0f));
  x = min(max(x, 0), s.tex_w - 1);
  y = min(max(y, 0), s.tex_h - 1);
  return texid * (s.tex_h * s.tex_w) + y * s.tex_w + x;
}

// The same for a hit on material `mat`
__device__ __forceinline__ int tex_index(const SceneDev& s, int mat, float u,
                                         float v) {
  return tex_index_of(s, (int)s.mat_attr[16 * mat + 11], u, v);
}

// Channel c (0 r, 1 g, 2 b) of a packed texel in [0, 1] (utilities.h:24)
__device__ __forceinline__ float texel_channel(uint32_t texel, int c) {
  return (float)((texel >> (8 * c)) & 0xFFu) * 0.003921568627f;
}

}  // namespace ptdn
