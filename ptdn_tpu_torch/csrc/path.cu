// Kernel B2 (deferred_radiance): the rebuild of a frame's radiance from
// the per-depth contributions and texel indices of kernel B1
// (csrc/scene/path_trace.cu).
//
// B2 replaces uncompact_tiles_pallas (path.py:239) together with the
// gather ladder of engine/wavefront.py:packed_texel_gather and
// deferred_radiance: one thread per pixel fetches its texels for depths
// >= 2 and rebuilds the radiance with deferred_radiance's running
// product, in its order (wavefront.py:441-454).
//
// What bounds it: it moves ~(6*4 + 4) B per depth per pixel and is bound
// by device memory bandwidth.
#include "ptdn.cuh"

namespace {

__global__ void deferred_radiance_kernel(const float* __restrict__ contrib,
                                         const int* __restrict__ texidx,
                                         const uint32_t* __restrict__ tex,
                                         int n_, int depth,
                                         float* __restrict__ rad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_) return;
  const size_t n = (size_t)n_;
  float cum[3] = {1.f, 1.f, 1.f};
  float r[3] = {0.f, 0.f, 0.f};
  for (int dd = 1; dd <= depth; ++dd) {
    const float* cp = contrib + 6 * (size_t)(dd - 1) * n + i;
    for (int c = 0; c < 3; ++c) r[c] = r[c] + cp[c * n] * cum[c];
    // depth-1 albedo is the exact primary albedo; ratios start at 2
    if (dd >= 2) {
      const int idx = texidx[(dd - 2) * n + i];
      if (idx >= 0) {
        const uint32_t texel = tex[idx];
        for (int c = 0; c < 3; ++c)
          cum[c] = cum[c] * ptdn::texel_channel(texel, c);
      }
    }
    for (int c = 0; c < 3; ++c) r[c] = r[c] + cp[(3 + c) * n] * cum[c];
  }
  rad[3 * i] = r[0];
  rad[3 * i + 1] = r[1];
  rad[3 * i + 2] = r[2];
}

}  // namespace

extern "C" int ptdn_deferred_radiance(const float* contrib, const int* texidx,
                                      const uint32_t* tex, int n, int depth,
                                      float* rad, void* stream) {
  if (n > 0) {
    const int block = 256;
    deferred_radiance_kernel<<<(n + block - 1) / block, block, 0,
                               (cudaStream_t)stream>>>(contrib, texidx, tex,
                                                       n, depth, rad);
  }
  return (int)cudaGetLastError();
}
