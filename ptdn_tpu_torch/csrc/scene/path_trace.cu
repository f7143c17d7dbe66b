// Kernel B1 (path_trace) built for one scene: the bounce loop of
// csrc/path_trace.cuh with the scene's baked rows as constants.
//
// It is compiled once per scene (ops/cuda/_lib.py:build_scene, cached by
// the scene's hash) with a generated header, scene.h
// (ops/cuda/scene_intersect.py:path_scene_header), that holds the scene's
// geom types and materials, each baked row's form and coefficients, and
// the material table. The geom loop unrolls over the scene's geoms
// (ptdn.cuh:analytic_best), the switch on each row's form folds away, and
// an axis-aligned wall's row is one FMUL or FFMA with its coefficient in
// the instruction. The material table lives in constant memory. Scenes
// past the header's limits take the table build of the same body
// (csrc/path_trace_table.cu).
//
// What bounds it: arithmetic and divergence (per depth ~2 x 10 analytic
// geom tests and up to 2 x 38 triangles per lane on cornell, with lanes
// of a warp on different materials); its traffic is ~100 B in and 24 B
// per depth out per pixel. It is built for 8 blocks of 128 threads an SM
// (at most 64 registers; ptxas spills 40 B on cornell, and it is still
// faster there than at 7 or 6 blocks without a spill, on the H100).
#include "../path_trace.cuh"
#include "scene.h"

namespace {

// The row policy of the per-scene build: the scene's geoms, baked rows
// and materials from scene.h.
struct SceneRows {
  static constexpr int kGeoms = scene::kGeoms;
  __device__ static __forceinline__ int type(const ptdn::SceneDev&, int g) {
    return scene::kType[g];
  }
  __device__ static __forceinline__ int mat(const ptdn::SceneDev&, int g) {
    return scene::kMat[g];
  }
  __device__ static __forceinline__ float row(const ptdn::SceneDev&, int g,
                                              int kind, int r, float x,
                                              float y, float z) {
    const int i = (g * ptdn::kKinds + kind) * 3 + r;
    return form_row(scene::kCode[i], scene::kCoef[i], x, y, z);
  }
  __device__ static __forceinline__ float sub_row(const ptdn::SceneDev&,
                                                  int g, int kind, int r,
                                                  float o, float x, float y,
                                                  float z) {
    const int i = (g * ptdn::kKinds + kind) * 3 + r;
    return form_sub_row(scene::kCode[i], scene::kCoef[i], o, x, y, z);
  }
  // field k of material m's mat_attr row
  __device__ static __forceinline__ float mat_attr(const ptdn::SceneDev&,
                                                   int m, int k) {
    return scene::kMatAttr[16 * m + k];
  }
};

__global__ void __launch_bounds__(128, 8)
    path_trace_kernel(ptdn::SceneDev s, ptdn::PathArgs a) {
  path_trace_lane<SceneRows>(s, a, blockIdx.x * blockDim.x + threadIdx.x);
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
