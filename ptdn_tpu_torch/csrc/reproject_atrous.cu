// Kernel L: SVGF back-projection fused with the a-trous level 1.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/reproject_atrous.py:
// back_projection_atrous1_pallas (_kernel): what kernel C (stencil mode)
// followed by kernel D at level 1 (not the last level, no albedo)
// compute, in one launch, without writing the accumulated color and
// variance to device memory and reading them back.
//
// The TPU kernel walked 64-row strips of the whole width in order,
// reprojecting each strip with an 8-row halo into VMEM and filtering it
// with whole-plane shifts; its strips, halo rows and shifts do not carry
// over (blocks run in no order here, and a block holds far less than a
// strip). One block of 512 threads, a thread a pixel, owns a kTileW x
// kTileH = 32 x 16 output tile and stages, in shared memory, the tile
// and a kHalo = 4 pixel ring on every side (the level-1 taps reach 2 *
// step = 4 pixels, the variance pre-blur 1): for each pixel of that
// 40 x 24 region its
// accumulated color and variance from reproject.cuh:reproject_pixel, C's
// code, and its position and normal, two 16-byte loads from the packed
// G-buffer planes the frame builds for D (ops/cuda/atrous.py:
// pack_static_planes), 48 B a pixel, 46 KB a block. It writes the
// moments and history length of its own tile's pixels only. After one
// barrier each thread filters one pixel with atrous.cuh:atrous_pixel at
// level 1, D's code, every tap and every pre-blur neighbour read from
// the staged tile (atrous.cuh:StagedTaps, laid out row-major: a warp's
// 32 lanes are 32 adjacent pixels of a row, so each tap's reads are 32
// consecutive float4s). Staged pixels outside the image are never read:
// the taps' in-bounds test excludes them, as in D. Both halves are C's
// and D's own code on the same values, so L's outputs equal C's then D's
// bit for bit. (ops/cuda/reproject_atrous.py:l_block_pixels mirrors the
// mapping.)
//
// What bounds it: by the card's peaks, bytes: per pixel ~60 B of current
// frame and ~40 B of previous frame in, 28 B of level-1 color and
// variance, moments and history out, about 108 B (0.021 ms at 800x800).
// In practice D's arithmetic and C's on (40 x 24) / (32 x 16) = 1.875x
// the pixels, the ring recomputed by the neighbouring blocks too: the
// price of not writing C's 16 B a pixel and reading it back, and of one
// launch fewer. Of the tiles tried on the H100 (32 x 16, 32 x 32, 32 x
// 40 and 64 x 32, with 256 to 1024 threads, PERF.md) this one ran
// fastest: a larger tile recomputes less but fits fewer threads an SM
// (64 x 32: one block), whose reprojections and filters then overlap
// less. Sharing the ring within a cluster of 4 or 8 blocks through
// distributed shared memory instead of recomputing it ran 22-31% slower
// (the cluster waits on its slowest block twice).
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
  const float* stat;     // (H, W, 8) G-buffer position, pad, normal, pad
};

}  // namespace ptdn

namespace {

constexpr int kTileW = 32;              // output tile, kTileW x kTileH
constexpr int kTileH = 16;
constexpr int kHalo = 4;                // 2 * step at level 1
constexpr int kSide = kTileW + 2 * kHalo;         // staged pixels a row
constexpr int kStaged = kSide * (kTileH + 2 * kHalo);
constexpr int kThreads = kTileW * kTileH;   // a thread per tile pixel

// The taps from the block's staged tile, row-major with kSide pixels a
// row; its pixel (0, 0) is image pixel (y0, x0)
struct TileIn : ptdn::StagedTaps {
  int y0, x0;
  __device__ __forceinline__ float blur_var(int qy, int qx) const {
    return cv_[(qy - y0) * kSide + (qx - x0)].w;
  }
};

// 3 blocks an SM (at most 40 registers, 76 B spilled): 2% faster on the
// H100 than 2 (64 registers, none spilled), 25% faster than 4 (32)
__global__ void __launch_bounds__(kThreads, 3)
    back_projection_atrous1_kernel(ptdn::ReprojAtrousArgs a) {
  __shared__ float4 s_cv[kStaged];
  __shared__ float4 s_pos[kStaged];
  __shared__ float4 s_nrm[kStaged];
  const int w = a.r.w, h = a.r.h;
  const int ty = blockIdx.y * kTileH, tx = blockIdx.x * kTileW;
  const int y0 = ty - kHalo, x0 = tx - kHalo;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  const float4* stat = reinterpret_cast<const float4*>(a.stat);
  for (int s = tid; s < kStaged; s += kThreads) {
    const int sy = s / kSide, sx = s - sy * kSide;
    const int y = y0 + sy, x = x0 + sx;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const int i = y * w + x;
    s_pos[s] = stat[2 * i];
    s_nrm[s] = stat[2 * i + 1];
    const ptdn::Accum r = ptdn::reproject_pixel<false>(a.r, y, x);
    s_cv[s] = make_float4(r.acc[0], r.acc[1], r.acc[2], r.var);
    if (y >= ty && y < ty + kTileH && x >= tx && x < tx + kTileW) {
      a.r.mom[2 * i] = r.mom[0];
      a.r.mom[2 * i + 1] = r.mom[1];
      a.r.hist[i] = r.hist;
    }
  }
  __syncthreads();

  const int y = ty + threadIdx.y, x = tx + threadIdx.x;
  if (y >= h || x >= w) return;
  const TileIn in{{s_cv, s_pos, s_nrm, 2 * kSide, 2,
                   (y - y0) * kSide + (x - x0)},
                  y0, x0};
  float out[4];
  ptdn::atrous_pixel(in, w, h, y, x, 1, a.blur_variance != 0,
                     ptdn::AtrousSigmas{a.sigma_l, a.sigma_n, a.sigma_x},
                     out);
  const int i = y * w + x;
  a.color_out[3 * i] = out[0];
  a.color_out[3 * i + 1] = out[1];
  a.color_out[3 * i + 2] = out[2];
  a.var_out[i] = out[3];
}

}  // namespace

extern "C" int ptdn_back_projection_atrous1(const ptdn::ReprojAtrousArgs* a,
                                            void* stream) {
  if (a->r.w > 0 && a->r.h > 0) {
    const dim3 grid((a->r.w + kTileW - 1) / kTileW,
                    (a->r.h + kTileH - 1) / kTileH);
    back_projection_atrous1_kernel<<<grid, dim3(kTileW, kTileH), 0,
                                     (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
