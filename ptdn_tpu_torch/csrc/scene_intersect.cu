// Kernels A, J, I and M: the fully resolved closest hit of a batch of
// rays, the same with each ray's texel index, the NEE visibility of a
// batch of shadow rays, and the unmerged analytic and mesh bests.
//
// A replaces the TPU kernel ptdn_tpu/ops/pallas/scene_intersect.py:
// scene_intersect_full_pallas (_kernel_full). J replaces
// scene_intersect_full_tex_pallas (_kernel_full_tex): A's hit plus the
// flat texel index of the hit's material at its uv, -1 where the
// material is untextured (tex_index_tiles, here ptdn.cuh:tex_index), on
// every ray, hit or not, as the TPU kernel computes it. Dropped: the
// per-row compaction of those indices (cidx, slot, count; compact.py:
// compact_tile), which the TPU needed because its gathers are
// count-bound. A GPU thread of kernel K reads its own texel.
//
// I replaces light_visibility_pallas (_vis_kernel,
// light_visibility_tiles): per ray, the closest analytic hit is the light
// geom and no triangle lies in front of it, on every ray, with no NEE
// mask, as the TPU kernel computes it. The TPU kernel's loop ends when
// every lane of its block is occluded; here a ray leaves the scan at the
// chunk of its first occluder, and the block stops where no ray wants a
// chunk.
//
// M replaces scene_intersect_pallas (_kernel): A without the refine and
// the merge. Per ray the closest analytic hit (t, or -1 where none, geom,
// normal) and the closest triangle whose t beats it (t, or -1, index),
// unmerged, as the TPU kernel hands them to the engine. `cull` false
// scans every chunk for every ray (the same answer, more work), as the
// TPU kernel's switch does.
//
// A, J and I run on the block-level chunk scan (chunk_scan.cuh): a block
// of 128 rays, a thread each, runs the analytic geoms in scene order per
// ray, then walks the scene's 128-triangle chunks once, in ascending
// order, each crossed chunk staged in shared memory and tested by a
// thread per triangle against the block's rays that cross it, each ray
// behind its own AABB cull over every chunk. A and J carry the
// closest-hit query alone (closest_hit.cuh: the cull against the running
// best, then the exact refine of the winning triangle and the merge,
// ptdn.cuh:resolve_hit), I the any-hit query alone (light_visibility.cuh:
// the cull and the test against the light's distance, for the rays whose
// closest analytic hit is the light): one list slot, one key, one cull
// and one ballot a ray. The results are ptdn.cuh's per-lane walks'
// (mesh_best, light_visible), bit for bit (chunk_scan.cuh says why). M
// keeps the per-lane walk (ptdn.cuh:mesh_best): one thread per ray scans
// the chunks behind its own cull.
//
// All four take the full dot products of the scene matrices, as the
// TPU per-bounce kernels do (no baked rows: that is B1's form); A, J and
// I are built once per scene as well, with the matrices as constants
// (scene/scene_intersect.cu), this file's build serving the scenes past
// that build's limits. A ray's component c lies at o[k * o_rs + c * o_cs],
// so the rays may be an (N, 3) tensor or three planes of a plane stack.
//
// What bounds them: the lane-triangle tests (~52 float operations each,
// with a reciprocal) and, on cornell (one chunk of 38 triangles, nine
// analytic geoms), the analytic tests; not bytes: a ray reads 24 B and
// writes at most 36 B, and the scene stays in L1/L2. The deviation from
// the TPU design: the TPU kernels tested 8 triangles against a 128-lane
// row at once and culled per 1024-ray block (a block's rays all test a
// chunk that any of them crosses); here every ray is culled on its own,
// and in A, J and I the block's vote skips the chunks no ray of the block
// crosses while a thread per triangle meets the compacted list of the
// rays that cross its chunk.
#include "light_visibility.cuh"

namespace ptdn {

struct BestArgs {
  float* t_a;    // (N,) closest analytic t, -1 where none
  int* geom_a;   // (N,) its geom, -1 where none
  float* nrm_a;  // (N, 3) its normal, 0 where none
  float* t_m;    // (N,) closest triangle's t where it beats t_a, else -1
  int* tri_m;    // (N,) that triangle's index, else -1
};

}  // namespace ptdn

namespace {

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
  return ptdn::launch_closest_hit<false, ptdn::MatRows>(s, r, a, stream);
}

extern "C" int ptdn_scene_intersect_full_tex(const ptdn::SceneDev* s,
                                             const ptdn::RayArgs* r,
                                             const ptdn::IsectArgs* a,
                                             void* stream) {
  return ptdn::launch_closest_hit<true, ptdn::MatRows>(s, r, a, stream);
}

extern "C" int ptdn_light_visibility(const ptdn::SceneDev* s,
                                     const ptdn::RayArgs* r, int light_geom,
                                     unsigned char* lit, void* stream) {
  return ptdn::launch_light_visibility<ptdn::MatRows>(s, r, light_geom, lit,
                                                      stream);
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
