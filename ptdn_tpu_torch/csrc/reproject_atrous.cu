// Kernel L: SVGF back-projection fused with the a-trous level 1.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/reproject_atrous.py:
// back_projection_atrous1_pallas (_kernel): what kernel C (stencil mode)
// followed by kernel D at level 1 (not the last level, no albedo)
// compute, in one launch, without writing the accumulated color and
// variance to device memory and reading them back.
//
// The TPU kernel walked 64-row strips of the whole width in order,
// reprojecting each strip with an 8-row halo into VMEM. Here one block
// owns a 32x32 output tile. It reprojects the tile and a 4-pixel halo
// on every side (the level-1 taps reach 2 * step = 4 pixels; the
// variance pre-blur reaches 1) with reproject.cuh:reproject_pixel, and
// keeps each pixel's accumulated color and variance in shared memory
// (16 B a pixel, 25.6 KB a block). It writes the moments and history
// length of its own tile pixels only. After one barrier each thread runs
// atrous.cuh:atrous_pixel at level 1 with color and variance from the
// shared tile, position and normal from device memory. Halo pixels
// outside the image are never read: the a-trous taps' in-bounds test
// excludes them, as in D.
// Both halves are C's and D's own code, so L's outputs equal C's then
// D's bit for bit.
//
// What bounds it: bytes. Per pixel ~60 B of current frame and ~40 B of
// previous frame in, 28 B of level-1 color and variance, moments and
// history out, about 108 B; the halo recomputes (40 / 32)^2 = 1.56x of
// C's arithmetic, which the block's threads spend instead of the 16 B a
// pixel that C's accumulated color and variance cost to write and D to
// read, and one launch.
#include "atrous.cuh"
#include "reproject.cuh"

namespace ptdn {

struct ReprojAtrousArgs {
  ReprojArgs r;          // var and acc unused; mom and hist written
  float* color_out;      // (H, W, 3) level-1 color
  float* var_out;        // (H, W) level-1 variance
  int blur_variance;
  float sigma_l;
  float sigma_n;
  float sigma_x;
};

}  // namespace ptdn

namespace {

constexpr int kTile = 32;               // output tile, kTile x kTile
constexpr int kHalo = 4;                // 2 * step at level 1
constexpr int kSide = kTile + 2 * kHalo;
constexpr int kRows = 8;                // thread block kTile x kRows

// The level's input color and variance from the block's shared tile,
// whose pixel (0, 0) is image pixel (y0, x0); the G-buffer from device
// memory
struct TileIn {
  const float4* tile;
  const float* pos_;
  const float* nrm_;
  int y0, x0, w;
  __device__ __forceinline__ float4 cv(int y, int x, int, int) const {
    return tile[(y - y0) * kSide + (x - x0)];
  }
  __device__ __forceinline__ float4 pos(int y, int x, int, int) const {
    const int i = y * w + x;
    return make_float4(pos_[3 * i], pos_[3 * i + 1], pos_[3 * i + 2], 0.f);
  }
  __device__ __forceinline__ float4 nrm(int y, int x, int, int) const {
    const int i = y * w + x;
    return make_float4(nrm_[3 * i], nrm_[3 * i + 1], nrm_[3 * i + 2], 0.f);
  }
  __device__ __forceinline__ float blur_var(int y, int x) const {
    return cv(y, x, 0, 0).w;
  }
};

__global__ void __launch_bounds__(kTile* kRows)
    back_projection_atrous1_kernel(ptdn::ReprojAtrousArgs a) {
  __shared__ float4 tile[kSide * kSide];
  const int w = a.r.w, h = a.r.h;
  const int ty = blockIdx.y * kTile, tx = blockIdx.x * kTile;
  const int y0 = ty - kHalo, x0 = tx - kHalo;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  for (int s = tid; s < kSide * kSide; s += kTile * kRows) {
    const int sy = s / kSide, sx = s - sy * kSide;
    const int y = y0 + sy, x = x0 + sx;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const ptdn::Accum r = ptdn::reproject_pixel<false>(a.r, y, x);
    tile[s] = make_float4(r.acc[0], r.acc[1], r.acc[2], r.var);
    if (y >= ty && y < ty + kTile && x >= tx && x < tx + kTile) {
      const int i = y * w + x;
      a.r.mom[2 * i] = r.mom[0];
      a.r.mom[2 * i + 1] = r.mom[1];
      a.r.hist[i] = r.hist;
    }
  }
  __syncthreads();

  const TileIn in{tile, a.r.pos, a.r.nrm, y0, x0, w};
  const ptdn::AtrousSigmas sg{a.sigma_l, a.sigma_n, a.sigma_x};
  const int x = tx + threadIdx.x;
  for (int k = 0; k < kTile / kRows; ++k) {
    const int y = ty + threadIdx.y + k * kRows;
    if (y >= h || x >= w) continue;
    float out[4];
    ptdn::atrous_pixel(in, w, h, y, x, 1, a.blur_variance != 0, sg, out);
    const int i = y * w + x;
    a.color_out[3 * i] = out[0];
    a.color_out[3 * i + 1] = out[1];
    a.color_out[3 * i + 2] = out[2];
    a.var_out[i] = out[3];
  }
}

}  // namespace

extern "C" int ptdn_back_projection_atrous1(const ptdn::ReprojAtrousArgs* a,
                                            void* stream) {
  if (a->r.w > 0 && a->r.h > 0) {
    const dim3 grid((a->r.w + kTile - 1) / kTile, (a->r.h + kTile - 1) / kTile);
    back_projection_atrous1_kernel<<<grid, dim3(kTile, kRows), 0,
                                     (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
