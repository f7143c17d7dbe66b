// Kernel R: native mode's spatial variance and its short-history
// fallback (SVGF paper, section 4.2).
//
// Replaces XLA code of the JAX package, outside any Pallas kernel:
// ptdn_tpu/denoise/variance.py:spatial_variance (the luminance moments
// over a 7x7 window with the a-trous normal and position edge-stopping
// weights, max(mu2 - mu1^2, 0)) and variance_with_spatial_fallback
// (that estimate where the history is shorter than 4 frames, the
// temporal variance elsewhere). On the TPU it is one fused XLA pass; in
// plain PyTorch it is ~25 operations on each of 49 taps, about 1,200
// launches a frame.
//
// One thread a pixel. A pixel whose history is at least 4 frames copies
// its temporal variance and does nothing else; any other pixel (every
// pixel without a history: temporal accumulation off) runs the 49 taps
// in the JAX order (dy outer, dx inner), each tap's position, normal and
// color read from device memory (the L1 cache serves a block's
// overlapping windows), and writes the estimate. The per-pixel select
// gives, on every pixel, what the JAX package's lax.cond(any(need), ...)
// gives, without the host read a port of the `any` would cost. Taps
// outside the image weigh zero, as the plain version's zero padding
// makes them, and are skipped. The edge weights are D's distances
// (atrous.cuh:sqrt_dist of the fused dot product) and the oracle's
// min(1, exp(-d / (sigma + 1e-6))), a true division, so the kernel equals
// its plain version (ptdn_tpu_torch/denoise/variance.py) wherever expf
// and torch.exp agree.
//
// What bounds it: by the card's peaks, operations where every pixel runs
// the taps (49 x ~45 float operations, two exps and two square roots a
// tap), ~0.02 ms at 800x800; bytes (48 B a pixel) where none does.
// Simple by design: a shared-memory tile with a 3-pixel ring would cut
// the L1 traffic of the taps.
#include "atrous.cuh"

namespace ptdn {

struct SpatialVarianceArgs {
  const float* color;   // (H, W, 3) the color whose moments are estimated
  const float* pos;     // (H, W, 3) G-buffer position
  const float* nrm;     // (H, W, 3) G-buffer normal
  const int* hist;      // (H, W) history length, or null: every pixel
  const float* var;     // (H, W) temporal variance (with hist)
  float* out;           // (H, W)
  int w, h;
  float sigma_n, sigma_x;
};

constexpr int kHistThreshold = 4;
constexpr int kRadius = 3;

__device__ __forceinline__ float luminance3(const float* c) {
  return dot3(0.2126f, 0.7152f, 0.0722f, c[0], c[1], c[2]);
}

// |a - b| of two 3-vectors as denoise/reproject.py:_norm3 rounds it
__device__ __forceinline__ float dist3(const float* a, const float* b) {
  const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return sqrt_dist(dot3(dx, dy, dz, dx, dy, dz));
}

}  // namespace ptdn

namespace {

__global__ void spatial_variance_kernel(ptdn::SpatialVarianceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  if (a.hist != nullptr && a.hist[i] >= ptdn::kHistThreshold) {
    a.out[i] = a.var[i];
    return;
  }
  const int y = i / a.w, x = i % a.w;
  const float den_n = a.sigma_n + 1e-6f;
  const float den_x = a.sigma_x + 1e-6f;
  const float* p0 = a.pos + 3 * i;
  const float* n0 = a.nrm + 3 * i;
  float m1 = 0.f, m2 = 0.f, ws = 0.f;
  for (int dy = -ptdn::kRadius; dy <= ptdn::kRadius; ++dy) {
    const int qy = y + dy;
    if (qy < 0 || qy >= a.h) continue;
    for (int dx = -ptdn::kRadius; dx <= ptdn::kRadius; ++dx) {
      const int qx = x + dx;
      if (qx < 0 || qx >= a.w) continue;
      const int q = qy * a.w + qx;
      const float lq = ptdn::luminance3(a.color + 3 * q);
      const float wn =
          ptdn::jmin(expf(-ptdn::dist3(n0, a.nrm + 3 * q) / den_n), 1.f);
      const float wx =
          ptdn::jmin(expf(-ptdn::dist3(p0, a.pos + 3 * q) / den_x), 1.f);
      const float w = wn * wx;
      m1 = m1 + w * lq;
      m2 = m2 + w * lq * lq;
      ws = ws + w;
    }
  }
  const float inv = 1.0f / ptdn::jmax(ws, 1e-20f);
  const float mu1 = m1 * inv;
  const float mu2 = m2 * inv;
  a.out[i] = ptdn::jmax(mu2 - mu1 * mu1, 0.f);
}

}  // namespace

extern "C" int ptdn_spatial_variance(const ptdn::SpatialVarianceArgs* a,
                                     void* stream) {
  const int n = a->w * a->h;
  if (n > 0) {
    const int block = 256;
    spatial_variance_kernel<<<(n + block - 1) / block, block, 0,
                              (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
