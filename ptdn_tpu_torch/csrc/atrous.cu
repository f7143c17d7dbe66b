// Kernel D: one edge-stopping a-trous level of SVGF.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/atrous.py:
// atrous_level_pallas (_kernel). Each thread runs atrous.cuh:atrous_pixel
// (the variance pre-blur, the 25 edge-stopping taps at step 1 << level,
// the squared-weight variance) for one pixel, then the albedo
// remodulation on the last level when asked. It reads the level's input
// buffers and writes separate output buffers (read-old/write-new, the
// race-free form of denoise.cu:153-161).
//
// Layout: as the TPU kernel packs its G-buffer planes
// (pack_static_planes), D reads position and normal from one (H, W, 8)
// buffer, x y z pad x y z pad, packed once per camera move, two 16-byte
// loads a pixel, and the level's color and variance from one (H, W, 4)
// buffer, one 16-byte load, which it also writes for the next level. A
// level may instead read or write the separate (H, W, 3) color and
// (H, W) variance of the SVGF state (the level after the
// back-projection, the level that feeds the color history, the last
// level): `var` or `var_out` is then not null.
//
// Tiling: the taps of pixel (y, x) at step s = 1 << level lie on the
// sub-lattice of stride s through it, where they are a dense 5x5
// neighbourhood. A block filters an 8-row tile of P = min(4, s) lattices
// of adjacent column phases: lane q of warp r takes lattice row r,
// column q / P of phase q % P, so a warp's lanes hold runs of P adjacent
// pixels and its pre-blur loads and its stores touch 32 / P lines, not
// 32 (with every lane on one lattice, the blur and the split output
// made a level dearer the larger its step). The block first stages the
// tile and a 2-pixel halo of each lattice, at most 576 pixels of 48 B
// (27.6 KB), in shared memory with 16-byte loads, laid out
// [row][column][phase] so that a warp's tap reads are consecutive, and
// every tap is read from there; one thread per pixel reading its taps
// from L1/L2 made ~260 load instructions a pixel and crossed L2 for the
// same line several times. The staged bytes stay within twice the
// compulsory ones (ops/cuda/atrous.py:atrous_tiling mirrors the
// mapping). The pre-blur reads its 9 neighbours, off the sub-lattice,
// through L1. The TPU kernel's row strips, halo DMAs and whole-plane
// shifts do not carry over.
//
// Shard mode (the TPU kernel's row0, full_h and halo rows,
// ptdn_tpu/ops/pallas/atrous.py:275-283): the launch filters the h rows
// of a shard whose first row is image row row0 of a full_h-row image.
// The level's input carries `halo` real neighbour rows above and below
// (parallel/halo.py, zeros past the image), the G-buffer `static_halo`;
// tap rows are read through those offsets and masked by their global
// row, so every pixel is the unsharded level's bit for bit. The lattice
// phases stay on the shard's own rows (atrous_tiling of h). Unsharded:
// row0 = 0, full_h = h, no halo rows.
//
// What bounds it: the compulsory traffic is ~56 B a pixel (0.011 ms at
// 800x800), but the arithmetic weighs more: 25 taps of two IEEE square
// roots, an exp and ~30 flops, some 3,000 instructions of unrolled code
// with a branch around each tap and each square root's slow path, which
// with the blur off and packed buffers sets D's time on the H100 at
// every step; the blur, the split layout of the last level and, on small
// lattices, idle lanes (a 25-pixel lattice in 8-column tiles) add to it
// at the larger steps (PERF.md).
#include "atrous.cuh"

namespace ptdn {

struct AtrousArgs {
  const float* cv;       // (H, W, 4) level input, or (H, W, 3) color if var
  const float* var;      // (H, W) level input variance, or null (packed)
  const float* stat;     // (H, W, 8) G-buffer position, pad, normal, pad
  const float* albedo;   // (H, W, 3) albedo * ialbedo, or null
  float* cv_out;         // (H, W, 4), or (H, W, 3) color if var_out
  float* var_out;        // (H, W), or null (packed)
  int w;
  int h;
  int level;
  int blur_variance;
  int phases;            // adjacent column phases a block takes
  int tiles_x;           // tiles across and down a lattice (atrous_tiling)
  int tiles_y;
  float sigma_l;
  float sigma_n;
  float sigma_x;
  int row0;              // image row of the launch's row 0
  int full_h;            // image rows
  int halo;              // rows of cv and var above row 0 (and below h)
  int static_halo;       // rows of stat above row 0 (and below h)
};

}  // namespace ptdn

namespace {

constexpr int kRows = 8;         // warps a block, lattice rows of a tile
constexpr int kHalo = 2;         // the taps' reach on the lattice
// staged pixels of a tile: (kRows + 4) rows x (32 / phases + 4) columns
// of each phase, at most (with 4 phases)
constexpr int kMaxStaged = (kRows + 2 * kHalo) * (8 + 2 * kHalo) * 4;

// The level's input color and variance of image pixel i
__device__ __forceinline__ float4 load_cv(const ptdn::AtrousArgs& a, int i) {
  if (a.var == nullptr) return reinterpret_cast<const float4*>(a.cv)[i];
  return make_float4(a.cv[3 * i], a.cv[3 * i + 1], a.cv[3 * i + 2],
                     a.var[i]);
}

// The taps from the block's staged tile, laid out [row][column][phase];
// the pre-blur's neighbours, off the sub-lattice, from device memory
struct TileIn : ptdn::StagedTaps {
  const float* cv_in;   // the level's input in device memory (AtrousArgs)
  const float* var_in;
  int w;
  int off;              // buffer row of image row 0: halo - row0
  __device__ __forceinline__ float blur_var(int qy, int qx) const {
    const int q = (qy + off) * w + qx;
    return var_in == nullptr ? cv_in[4 * q + 3] : var_in[q];
  }
};

// 5 blocks an SM (at most 51 registers): faster on the H100 than 4 (57
// registers, no bound) or 6
__global__ void __launch_bounds__(kRows * 32, 5)
    atrous_level_kernel(ptdn::AtrousArgs a) {
  __shared__ float4 s_cv[kMaxStaged];
  __shared__ float4 s_pos[kMaxStaged];
  __shared__ float4 s_nrm[kMaxStaged];
  const int level = a.level, step = 1 << level, np = a.phases;
  const int cols = 32 / np;                   // lattice columns of a tile
  // block -> row phase py, first column phase px, tile (ty, tx)
  const int tiles = a.tiles_x * a.tiles_y, groups = step / np;
  const int g = blockIdx.x / tiles, t = blockIdx.x - g * tiles;
  const int py = g / groups, px = (g - py * groups) * np;
  const int ty = t / a.tiles_x, tx = t - ty * a.tiles_x;
  // image pixel of staged row 0, column 0, phase 0
  const int oy = py + (ty * kRows - kHalo) * step;
  const int ox = px + (tx * cols - kHalo) * step;
  const int sc = cols + 2 * kHalo;            // staged columns a phase
  const int srow = sc * np;

  const float4* stat = reinterpret_cast<const float4*>(a.stat);
  for (int k = threadIdx.x; k < (kRows + 2 * kHalo) * srow;
       k += kRows * 32) {
    const int r = k / srow, c = (k - r * srow) / np, p = k % np;
    const int y = oy + r * step, x = ox + c * step + p;
    const int gy = a.row0 + y;
    if (y < -a.halo || y >= a.h + a.halo || gy < 0 || gy >= a.full_h ||
        x < 0 || x >= a.w)
      continue;
    s_cv[k] = load_cv(a, (y + a.halo) * a.w + x);
    const int i = (y + a.static_halo) * a.w + x;
    s_pos[k] = stat[2 * i];
    s_nrm[k] = stat[2 * i + 1];
  }
  __syncthreads();

  const int r = threadIdx.x >> 5, q = threadIdx.x & 31;
  const int l = q / np, p = q - l * np;
  const int y = oy + (r + kHalo) * step, x = ox + (l + kHalo) * step + p;
  if (y >= a.h || x >= a.w) return;
  const TileIn in{{s_cv, s_pos, s_nrm, srow, np,
                   (r + kHalo) * srow + (l + kHalo) * np + p},
                  a.cv, a.var, a.w, a.halo - a.row0};
  float out[4];
  ptdn::atrous_pixel(in, a.w, a.full_h, a.row0 + y, x, level,
                     a.blur_variance != 0,
                     ptdn::AtrousSigmas{a.sigma_l, a.sigma_n, a.sigma_x},
                     out);
  const int i = y * a.w + x;
  if (a.albedo != nullptr) {
    out[0] = out[0] * a.albedo[3 * i];
    out[1] = out[1] * a.albedo[3 * i + 1];
    out[2] = out[2] * a.albedo[3 * i + 2];
  }
  if (a.var_out == nullptr) {
    reinterpret_cast<float4*>(a.cv_out)[i] =
        make_float4(out[0], out[1], out[2], out[3]);
  } else {
    a.cv_out[3 * i] = out[0];
    a.cv_out[3 * i + 1] = out[1];
    a.cv_out[3 * i + 2] = out[2];
    a.var_out[i] = out[3];
  }
}

}  // namespace

// `blocks` is atrous_tiling's count for the args' image and level.
extern "C" int ptdn_atrous_level(const ptdn::AtrousArgs* a, int blocks,
                                 void* stream) {
  if (a->phases != 1 && a->phases != 2 && a->phases != 4)
    return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    atrous_level_kernel<<<blocks, kRows * 32, 0, (cudaStream_t)stream>>>(
        *a);
  }
  return (int)cudaGetLastError();
}
