// Kernels A, J, I and M: the fully resolved closest hit of a batch of
// rays, the same with each ray's texel index, the NEE visibility of a
// batch of shadow rays, and the unmerged analytic and mesh bests.
//
// A replaces the TPU kernel ptdn_tpu/ops/pallas/scene_intersect.py:
// scene_intersect_full_pallas (_kernel_full). One thread per ray runs
// the analytic geoms in scene order, the 128-triangle chunks in leaf
// order behind a per-ray AABB cull, the exact refine of the winning
// triangle and the merge (ptdn.cuh:closest_hit).
//
// J replaces scene_intersect_full_tex_pallas (_kernel_full_tex): A's hit
// plus the flat texel index of the hit's material at its uv, -1 where the
// material is untextured (tex_index_tiles, here ptdn.cuh:tex_index), on
// every ray, hit or not, as the TPU kernel computes it. Dropped: the
// per-row compaction of those indices (cidx, slot, count; compact.py:
// compact_tile), which the TPU needed because its gathers are
// count-bound. A GPU thread of kernel K reads its own texel.
//
// I replaces light_visibility_pallas (_vis_kernel,
// light_visibility_tiles): per ray, the closest analytic hit is the light
// geom and no triangle lies in front of it (ptdn.cuh:light_visible), on
// every ray, with no NEE mask, as the TPU kernel computes it. The TPU
// kernel's loop ends when every lane of its block is occluded; a thread
// here returns at its own first occluder.
//
// M replaces scene_intersect_pallas (_kernel): A without the refine and
// the merge. Per ray the closest analytic hit (t, or -1 where none, geom,
// normal) and the closest triangle whose t beats it (t, or -1, index),
// unmerged, as the TPU kernel hands them to the engine. `cull` false
// scans every chunk for every ray (the same answer, more work), as the
// TPU kernel's switch does.
//
// All four take the full dot products of the scene matrices, as the
// TPU per-bounce kernels do (no baked rows: that is B1's form). A ray's
// component c lies at o[k * o_rs + c * o_cs], so the rays may be an
// (N, 3) tensor or three planes of a plane stack.
//
// What bounds them: arithmetic and divergence, not bytes. A ray reads
// 24 B and writes at most 36 B; the scene (cornell: 10 geoms, 38
// triangles, ~10 KB) stays in L1/L2 and is read by every thread of a warp
// at the same address, which the cache broadcasts. The TPU kernels tested
// 8 triangles against a 128-lane row at once and culled per 1024-ray
// block; here each thread culls each chunk for its own ray and keeps its
// running best in registers.
#include "ptdn.cuh"

namespace ptdn {

struct RayArgs {
  const float* o;  // ray k's component c at o[k * o_rs + c * o_cs]
  const float* d;
  int o_rs, o_cs, d_rs, d_cs;
  int n;
};

struct IsectArgs {
  float* t;    // (N,)
  float* nrm;  // (N, 3)
  float* uv;   // (N, 2)
  int* geom;   // (N,)
  int* mat;    // (N,)
  int* tidx;   // (N,) texel index, written by J only
};

struct BestArgs {
  float* t_a;    // (N,) closest analytic t, -1 where none
  int* geom_a;   // (N,) its geom, -1 where none
  float* nrm_a;  // (N, 3) its normal, 0 where none
  float* t_m;    // (N,) closest triangle's t where it beats t_a, else -1
  int* tri_m;    // (N,) that triangle's index, else -1
};

}  // namespace ptdn

namespace {

template <bool Tex>
__device__ __forceinline__ void closest_hit_ray(const ptdn::SceneDev& s,
                                                const ptdn::RayArgs& r,
                                                const ptdn::IsectArgs& a,
                                                int i) {
  const float* o = r.o + (size_t)i * r.o_rs;
  const float* d = r.d + (size_t)i * r.d_rs;
  const ptdn::Hit h = ptdn::closest_hit<ptdn::MatRows>(
      s, o[0], o[r.o_cs], o[2 * r.o_cs], d[0], d[r.d_cs], d[2 * r.d_cs],
      true);
  a.t[i] = h.t;
  a.nrm[3 * i] = h.nx;
  a.nrm[3 * i + 1] = h.ny;
  a.nrm[3 * i + 2] = h.nz;
  a.uv[2 * i] = h.u;
  a.uv[2 * i + 1] = h.v;
  a.geom[i] = h.geom;
  a.mat[i] = h.mat;
  if (Tex) a.tidx[i] = ptdn::tex_index(s, h.mat, h.u, h.v);
}

__global__ void scene_intersect_full_kernel(ptdn::SceneDev s, ptdn::RayArgs r,
                                            ptdn::IsectArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r.n) closest_hit_ray<false>(s, r, a, i);
}

__global__ void scene_intersect_full_tex_kernel(ptdn::SceneDev s,
                                                ptdn::RayArgs r,
                                                ptdn::IsectArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r.n) closest_hit_ray<true>(s, r, a, i);
}

__global__ void light_visibility_kernel(ptdn::SceneDev s, ptdn::RayArgs r,
                                        int light_geom,
                                        unsigned char* __restrict__ lit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  const float* o = r.o + (size_t)i * r.o_rs;
  const float* d = r.d + (size_t)i * r.d_rs;
  lit[i] = ptdn::light_visible<ptdn::MatRows>(
               s, light_geom, o[0], o[r.o_cs], o[2 * r.o_cs], d[0],
               d[r.d_cs], d[2 * r.d_cs])
               ? 1
               : 0;
}

__global__ void scene_intersect_kernel(ptdn::SceneDev s, ptdn::RayArgs r,
                                       ptdn::BestArgs a, int cull) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  const float* o = r.o + (size_t)i * r.o_rs;
  const float* d = r.d + (size_t)i * r.d_rs;
  const float ox = o[0], oy = o[r.o_cs], oz = o[2 * r.o_cs];
  const float dx = d[0], dy = d[r.d_cs], dz = d[2 * r.d_cs];
  const ptdn::Analytic an =
      ptdn::analytic_best<ptdn::MatRows>(s, ox, oy, oz, dx, dy, dz, true);
  a.t_a[i] = an.geom >= 0 ? an.t : -1.f;
  a.geom_a[i] = an.geom;
  a.nrm_a[3 * i] = an.nx;
  a.nrm_a[3 * i + 1] = an.ny;
  a.nrm_a[3 * i + 2] = an.nz;
  float bt = an.geom >= 0 ? an.t : ptdn::kFltMax;
  const int bi = s.n_tris > 0
                     ? ptdn::mesh_best(s, ox, oy, oz, dx, dy, dz, bt, cull != 0)
                     : -1;
  a.t_m[i] = bi >= 0 ? bt : -1.f;
  a.tri_m[i] = bi;
}

constexpr int kBlock = 128;

int grid(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int ptdn_scene_intersect_full(const ptdn::SceneDev* s,
                                         const ptdn::RayArgs* r,
                                         const ptdn::IsectArgs* a,
                                         void* stream) {
  if (r->n > 0)
    scene_intersect_full_kernel<<<grid(r->n), kBlock, 0,
                                  (cudaStream_t)stream>>>(*s, *r, *a);
  return (int)cudaGetLastError();
}

extern "C" int ptdn_scene_intersect_full_tex(const ptdn::SceneDev* s,
                                             const ptdn::RayArgs* r,
                                             const ptdn::IsectArgs* a,
                                             void* stream) {
  if (r->n > 0)
    scene_intersect_full_tex_kernel<<<grid(r->n), kBlock, 0,
                                      (cudaStream_t)stream>>>(*s, *r, *a);
  return (int)cudaGetLastError();
}

extern "C" int ptdn_light_visibility(const ptdn::SceneDev* s,
                                     const ptdn::RayArgs* r, int light_geom,
                                     unsigned char* lit, void* stream) {
  if (r->n > 0)
    light_visibility_kernel<<<grid(r->n), kBlock, 0, (cudaStream_t)stream>>>(
        *s, *r, light_geom, lit);
  return (int)cudaGetLastError();
}

extern "C" int ptdn_scene_intersect(const ptdn::SceneDev* s,
                                    const ptdn::RayArgs* r,
                                    const ptdn::BestArgs* a, int cull,
                                    void* stream) {
  if (r->n > 0)
    scene_intersect_kernel<<<grid(r->n), kBlock, 0, (cudaStream_t)stream>>>(
        *s, *r, *a, cull);
  return (int)cudaGetLastError();
}
