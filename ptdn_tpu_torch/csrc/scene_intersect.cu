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
// TPU kernel's switch does: the scan's query option Cull, which skips
// the AABB test.
//
// A, J, I and M run on the block-level chunk scan (chunk_scan.cuh): a block
// of 128 rays, a thread each, runs the analytic geoms in scene order per
// ray, then walks the scene's 128-triangle chunks once, in ascending
// order, each crossed chunk staged in shared memory and tested by a
// thread per triangle against the block's rays that cross it, each ray
// behind its own AABB cull over every chunk. A and J carry the
// closest-hit query alone (closest_hit.cuh: the cull against the running
// best, then the exact refine of the winning triangle and the merge,
// ptdn.cuh:resolve_hit), M the same query with neither the refine nor
// the merge (its key's t and index are its outputs), I the any-hit
// query alone (light_visibility.cuh:
// the cull and the test against the light's distance, for the rays whose
// closest analytic hit is the light): one list slot, one key, one cull
// and one ballot a ray. The results are ptdn.cuh's per-lane walks'
// (mesh_best, light_visible), bit for bit (chunk_scan.cuh says why). The
// trace bench's random rays leave cornell's centre in every direction,
// so a warp's lanes disagree about the one chunk: a per-lane walk
// (ptdn.cuh:mesh_best) paid for the union of its lanes' chunks on every
// lane.
//
// All four take the full dot products of the scene matrices, as the
// TPU per-bounce kernels do (no baked rows: that is B1's form); all four
// are built once per scene as well, with the matrices as constants
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
// and the block's vote skips the chunks no ray of the block crosses
// while a thread per triangle meets the compacted list of the rays that
// cross its chunk.
#include "light_visibility.cuh"

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
  return ptdn::launch_scene_intersect<ptdn::MatRows>(s, r, a, cull, stream);
}
