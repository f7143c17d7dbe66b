// Kernel N (gather_u32): out[i] = table[idx[i]] for a flat uint32 table.
//
// Replaces the TPU kernel benchmarks/pallas_texgather.py:
// gather_u32_pallas (its body gather_table_groups and _kernel), a probe
// of texel-table gather throughput that no renderer path calls; its
// script is ptdn_tpu_torch/probes/texgather.py.
//
// One thread per index reads its word through the read-only cache
// (__ldg). What bounds it: bytes, the index read and the word written
// (8 B per index) and the table sectors the indices touch: sorted
// indices share their sectors, random ones pull a 32-byte sector per
// index from L2 or device memory.
//
// Dropped from the TPU design: the table's (G, 8, 128) group padding,
// the per-1024-index-tile scan of the group range [gmin, gmax] with its
// 8-way sublane select and lane gather, and the MAX_GROUPS = 256 VMEM
// gate that kept larger tables (room's two 1024^2 textures) on XLA's
// gather. They exist because a TPU has only vreg-local dynamic gathers;
// a GPU thread reads any word of device memory. Nor is N held to a
// multiple of 1024.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_u32_kernel(const uint32_t* __restrict__ table,
                                  const int* __restrict__ idx, int n,
                                  uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __ldg(table + __ldg(idx + i));
}

}  // namespace

extern "C" int ptdn_gather_u32(const uint32_t* table, const int* idx, int n,
                               uint32_t* out, void* stream) {
  if (n > 0) {
    const int block = 256;
    gather_u32_kernel<<<(n + block - 1) / block, block, 0,
                        (cudaStream_t)stream>>>(table, idx, n, out);
  }
  return (int)cudaGetLastError();
}
