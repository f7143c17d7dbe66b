// Kernel A: fully resolved closest hit for a batch of rays.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/scene_intersect.py:
// scene_intersect_full_pallas (_kernel_full). One thread per ray runs
// the analytic geoms in scene order, the 128-triangle chunks in leaf
// order behind a per-ray AABB cull, the exact refine of the winning
// triangle and the merge (ptdn.cuh:closest_hit).
//
// What bounds it: arithmetic and divergence, not bytes. A ray reads 24 B
// and writes 32 B; the scene (cornell: 10 geoms, 38 triangles, ~10 KB)
// stays in L1/L2 and is read by every thread of a warp at the same
// address, which the cache broadcasts. The TPU kernel tested 8 triangles
// against a 128-lane row at once and culled per 1024-ray block; here
// each thread culls each chunk for its own ray and keeps its running
// best in registers.
#include "ptdn.cuh"

namespace {

__global__ void scene_intersect_full_kernel(ptdn::SceneDev s,
                                            const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            int n, float* __restrict__ t_out,
                                            float* __restrict__ n_out,
                                            float* __restrict__ uv_out,
                                            int* __restrict__ geom_out,
                                            int* __restrict__ mat_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ptdn::Hit h = ptdn::closest_hit<false>(
      s, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
      d[3 * i + 2], true, ptdn::all_chunks(s));
  t_out[i] = h.t;
  n_out[3 * i] = h.nx;
  n_out[3 * i + 1] = h.ny;
  n_out[3 * i + 2] = h.nz;
  uv_out[2 * i] = h.u;
  uv_out[2 * i + 1] = h.v;
  geom_out[i] = h.geom;
  mat_out[i] = h.mat;
}

}  // namespace

extern "C" int ptdn_scene_intersect_full(const ptdn::SceneDev* s,
                                         const float* o, const float* d,
                                         int n, float* t_out, float* n_out,
                                         float* uv_out, int* geom_out,
                                         int* mat_out, void* stream) {
  if (n > 0) {
    const int block = 128;
    scene_intersect_full_kernel<<<(n + block - 1) / block, block, 0,
                                  (cudaStream_t)stream>>>(
        *s, o, d, n, t_out, n_out, uv_out, geom_out, mat_out);
  }
  return (int)cudaGetLastError();
}
