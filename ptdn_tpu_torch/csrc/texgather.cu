// Kernel N (gather_u32): out[i] = table[idx[i]] for a flat uint32 table.
//
// Replaces the TPU kernel benchmarks/pallas_texgather.py:
// gather_u32_pallas (its body gather_table_groups and _kernel), a probe
// of texel-table gather throughput that no renderer path calls; its
// script is ptdn_tpu_torch/probes/texgather.py.
//
// Each thread handles 4 consecutive indices: one 16-byte index load,
// four independent table reads through the read-only cache (__ldg), all
// in flight at once, then one 16-byte store. One index a thread left one
// dependent chain of 4-byte load, load, store per thread: latency with
// few bytes in flight. The indices before the first 16-byte boundary of
// idx (a slice such as idx[1:]) and the last n % 4 after the vectors
// take a scalar head and tail. The output lies at the same offset modulo
// 16 bytes as the indices (the wrapper allocates it so), so one boundary
// serves both. Blocks of 256 threads.
//
// What bounds it: bytes, the index read and the word written (8 B per
// index) and the table sectors the indices touch: sorted indices share
// their sectors, random ones pull a 32-byte sector per index from L2 or
// device memory. At the probe's 640,000 indices that is near an empty
// launch's time.
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

constexpr int kBlock = 256;

// Threads [0, n_vec) take 4 indices each from idx + head; the next head
// threads the scalar head [0, head), the rest the tail after the vectors.
__global__ void gather_u32_kernel(const uint32_t* __restrict__ table,
                                  const int* __restrict__ idx, int n,
                                  int head, int n_vec,
                                  uint32_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_vec) {
    const int base = head + 4 * t;
    const int4 ix = __ldg(reinterpret_cast<const int4*>(idx + base));
    uint4 w;
    w.x = __ldg(table + ix.x);
    w.y = __ldg(table + ix.y);
    w.z = __ldg(table + ix.z);
    w.w = __ldg(table + ix.w);
    *reinterpret_cast<uint4*>(out + base) = w;
    return;
  }
  int j = t - n_vec;
  if (j >= head) j += 4 * n_vec;    // past the head: the tail
  if (j < n) out[j] = __ldg(table + __ldg(idx + j));
}

}  // namespace

// idx and out must lie at the same offset modulo 16 bytes.
extern "C" int ptdn_gather_u32(const uint32_t* table, const int* idx, int n,
                               uint32_t* out, void* stream) {
  const uintptr_t ai = (uintptr_t)idx, ao = (uintptr_t)out;
  if ((ai ^ ao) & 15) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // indices before idx's first 16-byte boundary
  const int lead = (int)(((16 - (ai & 15)) & 15) / 4);
  const int head = lead < n ? lead : n;
  const int n_vec = (n - head) / 4;
  const int threads = n_vec + (n - 4 * n_vec);   // vectors, head, tail
  gather_u32_kernel<<<(threads + kBlock - 1) / kBlock, kBlock, 0,
                      (cudaStream_t)stream>>>(table, idx, n, head, n_vec,
                                              out);
  return (int)cudaGetLastError();
}
