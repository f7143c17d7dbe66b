// Kernel D: one edge-stopping a-trous level of SVGF.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/atrous.py:
// atrous_level_pallas (_kernel). One thread per pixel runs
// atrous.cuh:atrous_pixel (the variance pre-blur, the 25 edge-stopping
// taps at step 1 << level, the squared-weight variance), then the albedo
// remodulation on the last level when asked. It reads the level's input
// buffers and writes separate output buffers (read-old/write-new, the
// race-free form of denoise.cu:153-161).
// The TPU kernel DMA'd row strips with halos into VMEM and shifted whole
// planes; a thread here reads its taps through L1/L2, so no strip, halo
// or packing is needed.
//
// What bounds it: at levels 1-2 the taps of neighbouring threads overlap
// and the level is compute bound (25 exps and ~400 flops per pixel); at
// levels 3-5 the taps of a warp span 8-32 px strides and the level moves
// toward the cache's bandwidth. Compulsory traffic is ~60 B per pixel.
#include "atrous.cuh"

namespace ptdn {

struct AtrousArgs {
  const float* color;    // (H, W, 3) level input
  const float* var;      // (H, W) level input variance
  const float* pos;      // (H, W, 3) G-buffer position
  const float* nrm;      // (H, W, 3) G-buffer normal
  const float* albedo;   // (H, W, 3) albedo * ialbedo, or null
  float* color_out;      // (H, W, 3)
  float* var_out;        // (H, W)
  int w;
  int h;
  int level;
  int blur_variance;
  float sigma_l;
  float sigma_n;
  float sigma_x;
};

}  // namespace ptdn

namespace {

// The level's input straight from device memory
struct GlobalIn {
  const float* color_;
  const float* var_;
  int w;
  __device__ __forceinline__ float color(int y, int x, int c) const {
    return color_[3 * (y * w + x) + c];
  }
  __device__ __forceinline__ float var(int y, int x) const {
    return var_[y * w + x];
  }
};

__global__ void atrous_level_kernel(ptdn::AtrousArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  const int y = i / a.w, x = i - y * a.w;
  float out[4];
  ptdn::atrous_pixel(GlobalIn{a.color, a.var, a.w}, a.pos, a.nrm, a.w, a.h,
                     y, x, a.level, a.blur_variance != 0,
                     ptdn::AtrousSigmas{a.sigma_l, a.sigma_n, a.sigma_x},
                     out);
  if (a.albedo != nullptr) {
    out[0] = out[0] * a.albedo[3 * i];
    out[1] = out[1] * a.albedo[3 * i + 1];
    out[2] = out[2] * a.albedo[3 * i + 2];
  }
  a.color_out[3 * i] = out[0];
  a.color_out[3 * i + 1] = out[1];
  a.color_out[3 * i + 2] = out[2];
  a.var_out[i] = out[3];
}

}  // namespace

extern "C" int ptdn_atrous_level(const ptdn::AtrousArgs* a, void* stream) {
  const int n = a->w * a->h;
  if (n > 0) {
    const int block = 256;
    atrous_level_kernel<<<(n + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
