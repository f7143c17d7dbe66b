// Kernel I (light_visibility), templated on the row policy of its
// analytic tests: built once into the kernel library with MatRows
// (scene_intersect.cu), and once per scene with the scene's matrices as
// constants (scene/scene_intersect.cu, SceneMats). The design is in
// scene_intersect.cu's note.
#pragma once

#include "closest_hit.cuh"

namespace ptdn {

// The NEE visibility of the block's lanes, one shadow ray each: the
// analytic geoms (ptdn.cuh:analytic_best, as light_visible), then one
// any-hit chunk scan of the block over every chunk, each ray behind its
// own AABB cull at the light's distance, for the rays whose closest
// analytic hit is the light. Every thread of the block runs it.
template <class Rows>
__global__ void __launch_bounds__(kScanBlock, kScanBlocksPerSM)
    light_visibility_kernel(SceneDev s, RayArgs r, int light_geom,
                            unsigned char* __restrict__ lit) {
  __shared__ ScanSmem<false, true> sm;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < r.n;
  bool to_light = false;
  ScanQuery q = no_query();
  if (lane) {
    const float* o = r.o + (size_t)i * r.o_rs;
    const float* d = r.d + (size_t)i * r.d_rs;
    const float ox = o[0], oy = o[r.o_cs], oz = o[2 * r.o_cs];
    const float dx = d[0], dy = d[r.d_cs], dz = d[2 * r.d_cs];
    const Analytic a =
        analytic_best<Rows>(s, ox, oy, oz, dx, dy, dz, false);
    to_light = a.geom == light_geom;
    q = ScanQuery{scan_ray(ox, oy, oz, dx, dy, dz), a.t, -1, 0,
                  s.n_chunks - 1, to_light && s.n_tris > 0};
  }
  chunk_scan(s, sm, q);
  if (lane) lit[i] = to_light && q.best < 0 ? 1 : 0;
}

// The launch, on `stream`: one thread per ray, kScanBlock rays a block
template <class Rows>
int launch_light_visibility(const SceneDev* s, const RayArgs* r,
                            int light_geom, unsigned char* lit,
                            void* stream) {
  if (r->n > 0)
    light_visibility_kernel<Rows>
        <<<(r->n + kScanBlock - 1) / kScanBlock, kScanBlock, 0,
           (cudaStream_t)stream>>>(*s, *r, light_geom, lit);
  return (int)cudaGetLastError();
}

}  // namespace ptdn
