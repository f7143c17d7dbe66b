// Kernel G (inrow_permute): a 128-lane permutation within each row of K
// float32 planes, out[k, r, j] = planes[k, r, order[r, j]].
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/inrow.py:
// inrow_permute_pallas, the first half of the fresh-group permute of the
// sorted wavefront (engine/wavefront.py:permute_planes with regroup > 1):
// an in-row argsort of the coherence key brings lanes of similar key
// together, so the global sort can then move groups of G lanes.
//
// What bounds it: bytes. It is pure data movement: each plane is read
// once and written once, and the order once, (2K + 1) * 4 B per lane:
// 136 MB for 26 planes at 800x800, 41 us at 3.35 TB/s. One thread per
// output element; a warp writes 32 consecutive lanes of one row and
// gathers them from the same 512-byte row, so both sides coalesce.
//
// Dropped from the TPU design: only the tiling. The TPU kernel permuted
// inside a vector register (tpu.dynamic_gather over 8 x 128 lanes); here
// each thread reads its source through the cache, and a row's 512 bytes
// are four 128-byte lines.
#include <cuda_runtime.h>

namespace {

__global__ void inrow_permute_kernel(const float* __restrict__ planes,
                                     const int* __restrict__ order, int nb,
                                     long long total,
                                     float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long row = e >> 7;        // k * nb + r
  const int j = (int)(e & 127);
  const int r = (int)(row % nb);
  out[e] = planes[(row << 7) + order[r * 128 + j]];
}

}  // namespace

extern "C" int ptdn_inrow_permute(const float* planes, const int* order,
                                  int k, int nb, float* out, void* stream) {
  const long long total = (long long)k * nb * 128;
  if (total > 0) {
    const int block = 256;
    inrow_permute_kernel<<<(unsigned int)((total + block - 1) / block), block,
                           0, (cudaStream_t)stream>>>(planes, order, nb,
                                                      total, out);
  }
  return (int)cudaGetLastError();
}
