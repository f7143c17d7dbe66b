// Kernel B1's table build (path_trace_table): the bounce loop of
// csrc/path_trace.cuh with the baked rows, geom types and materials read
// from device memory, for the scenes the per-scene build
// (csrc/scene/path_trace.cu) does not take: more than B1_MAX_GEOMS geoms,
// more than B1_MAX_MATS materials, or a matrix or material constant that
// is not finite (ops/cuda/scene_intersect.py:path_scene_header). The JAX
// path kernel has no such limits, so neither has this build.
//
// Replaces, like the per-scene build, the TPU kernel
// ptdn_tpu/ops/pallas/path.py:path_trace_fused_pallas. The table holds
// per geom the same forms and coefficients (c0..c3) of its 5 kinds x 3
// baked rows that path_scene_header writes as constants
// (scene_intersect.py:baked_rows), the (G, 2) geom type and material
// table and the (M, 16) material table; every read goes through __ldg,
// and the geom loop runs to s.n_geoms. It evaluates each row with the
// same form_row as the per-scene build, so the two compute the same bits.
// The full dot products of MatRows would not: they left 0.17% of pixels
// off the JAX kernel, the baked forms none.
//
// What bounds it: as the per-scene build, arithmetic and divergence, plus
// a dependent table load and a run-time switch per row (a design with the
// table in constant memory ran 2.69 ms against the per-scene build's 1.17
// on cornell 800x800, NVIDIA H100 80GB HBM3, 700 W); it serves only the
// scenes past the per-scene build's limits.
#include "path_trace.cuh"

namespace {

// The row policy of the table build: SceneDev's geom table, its row table
// (row_code, row_coef: (G * 15,) forms and (G * 15, 4) coefficients in
// the order kind-major of baked_rows) and its material table.
struct TableRows {
  static constexpr int kGeoms = 0;   // the scene's count, s.n_geoms
  __device__ static __forceinline__ int type(const ptdn::SceneDev& s,
                                             int g) {
    return __ldg(s.geom + 2 * g);
  }
  __device__ static __forceinline__ int mat(const ptdn::SceneDev& s, int g) {
    return __ldg(s.geom + 2 * g + 1);
  }
  __device__ static __forceinline__ float row(const ptdn::SceneDev& s, int g,
                                              int kind, int r, float x,
                                              float y, float z) {
    const int i = (g * ptdn::kKinds + kind) * 3 + r;
    const float4 q = __ldg(reinterpret_cast<const float4*>(s.row_coef) + i);
    const float c[4] = {q.x, q.y, q.z, q.w};
    return form_row(__ldg(s.row_code + i), c, x, y, z);
  }
  __device__ static __forceinline__ float sub_row(const ptdn::SceneDev& s,
                                                  int g, int kind, int r,
                                                  float o, float x, float y,
                                                  float z) {
    const int i = (g * ptdn::kKinds + kind) * 3 + r;
    const float4 q = __ldg(reinterpret_cast<const float4*>(s.row_coef) + i);
    const float c[4] = {q.x, q.y, q.z, q.w};
    return form_sub_row(__ldg(s.row_code + i), c, o, x, y, z);
  }
  // field k of material m's mat_attr row
  __device__ static __forceinline__ float mat_attr(const ptdn::SceneDev& s,
                                                   int m, int k) {
    return __ldg(s.mat_attr + 16 * m + k);
  }
};

__global__ void __launch_bounds__(128, 8)
    path_trace_table_kernel(ptdn::SceneDev s, ptdn::PathArgs a) {
  path_trace_lane<TableRows>(s, a, blockIdx.x * blockDim.x + threadIdx.x);
}

}  // namespace

extern "C" int ptdn_path_trace_table(const ptdn::SceneDev* s,
                                     const ptdn::PathArgs* a, void* stream) {
  if (a->n > 0) {
    const int block = 128;
    path_trace_table_kernel<<<(a->n + block - 1) / block, block, 0,
                              (cudaStream_t)stream>>>(*s, *a);
  }
  return (int)cudaGetLastError();
}
