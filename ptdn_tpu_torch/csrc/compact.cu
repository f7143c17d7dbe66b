// Kernel K (sparse_gather): the texel fetch of the unsorted per-bounce
// engines: per lane the packed texel table[idx[i]] where idx[i] >= 0,
// unpacked, or else the lane's material color.
//
// Replaces the TPU kernels ptdn_tpu/ops/pallas/compact.py:
// compact_rows_pallas (per-row stream compaction of the valid indices
// into the first `cap` slots of each 128-lane row) and
// uncompact_rows_pallas (the route of the gathered values back to their
// lanes), with the XLA take between them (gather_compacted,
// sparse_gather). A thread also unpacks its texel and selects against its
// material color, the rest of the JAX engine's albedo fetch
// (engine/wavefront.py: albedo_from with sparse_cap, albedo_from_comp),
// and writes three albedo planes.
//
// What bounds it: bytes. A lane reads its index and material and writes
// three words; the gathered texels are a few percent of the lanes and the
// material table stays in L1. At 800x800 that is 5.1 MB in and 7.7 MB
// out: a few microseconds at 3.35 TB/s, so a launch costs little more
// than its fixed cost.
//
// Dropped from the TPU design: the compaction, its slot routing, the
// gather-width tiers with their device-wide max and the dense fallback.
// TPU gathers are count-bound, so the TPU kernels paid to shrink the
// number of gathered indices; a GPU thread reads its own texel, and the
// values are the same whichever tier the TPU took.
#include "ptdn.cuh"

namespace ptdn {

struct GatherArgs {
  const int* table;       // (T,) packed texels
  const int* idx;         // (N,) flat texel index, -1: no read
  const int* mat;         // (N,) material ids
  const float* mat_attr;  // (M, 16) material table
  float* alb;             // (3, N) albedo planes
  int n;
};

}  // namespace ptdn

namespace {

__global__ void sparse_gather_kernel(ptdn::GatherArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int k = a.idx[i];
  const int v = k >= 0 ? a.table[k] : 0;
  const float* m = a.mat_attr + 16 * a.mat[i];
  const size_t n = (size_t)a.n;
  for (int c = 0; c < 3; ++c)
    a.alb[c * n + i] = k >= 0 ? ptdn::texel_channel((uint32_t)v, c) : m[c];
}

}  // namespace

extern "C" int ptdn_sparse_gather(const ptdn::GatherArgs* a, void* stream) {
  if (a->n > 0) {
    const int block = 256;
    sparse_gather_kernel<<<(a->n + block - 1) / block, block, 0,
                           (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
