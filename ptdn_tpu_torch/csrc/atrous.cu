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
// Shard mode (the TPU kernel's row0, full_h, halo_top and halo_bottom,
// ptdn_tpu/ops/pallas/atrous.py:275-304; atrous_shard_kernel): the
// launch filters the h rows of a shard whose first row is image row row0
// of a full_h-row image. As the TPU kernel's operands, the shard's own
// level input (the previous level's packed output, read in place) and
// the `halo` real neighbour rows above and below it (packed (halo, W,
// 4) buffers, parallel/halo.py, zeros past the image) are separate
// inputs: staging picks a row's buffer by its row, so no level copies
// its input into an extended one. The G-buffer carries `static_halo`
// rows on each side (extended once per camera move). Tap rows are masked
// by their global row, so every pixel is the unsharded level's bit for
// bit. The lattice phases stay on the shard's own rows. At level 5 a
// 100-row shard's lattice holds 3-4 rows, so with atrous_level_kernel's
// tiles 4-5 of a block's 8 warps idled: a block takes two adjacent row
// phases there, as it takes up to 4 column phases, so that its warps
// hold real rows. Each thread runs atrous_pixel, the
// unsharded level's code. A level of a short shard under-fills the card
// (a 100-row shard at level 1 is 350 blocks, half a wave of the H100's
// 660 slots); spreading a pixel's 24 outer taps over 2, 4 or 8 lanes,
// the sums still taken in tap order from shuffled weights, was 1.8-2.7x
// slower than a thread a pixel (PERF.md §6). atrous_level_kernel takes
// the whole image alone and knows no rows past it; both kernels write
// their pixels through store_pixel.
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
};

// Shard mode's arguments: `a` the shard's rows (cv packed, h rows; stat
// h + 2 static_halo; the outputs h), its halo rows and where it lies
struct AtrousShardArgs {
  AtrousArgs a;          // its phases and tiles set by ptdn_atrous_shard
  const float* top;      // (halo, W, 4) the image rows above row 0
  const float* bottom;   // (halo, W, 4) the image rows below row h - 1
  int row0;              // image row of the shard's row 0
  int full_h;            // image rows
  int halo;              // rows of top and bottom
  int static_halo;       // rows of stat above row 0 (and below h)
};

}  // namespace ptdn

namespace {

constexpr int kRows = 8;         // warps a block, lattice rows of a tile
constexpr int kHalo = 2;         // the taps' reach on the lattice
// shard mode: row phases a block takes at most
// (ops/cuda/atrous.py:MAX_ROW_PHASES)
constexpr int kMaxRowPhases = 2;
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
  __device__ __forceinline__ float blur_var(int qy, int qx) const {
    const int q = qy * w + qx;
    return var_in == nullptr ? cv_in[4 * q + 3] : var_in[q];
  }
};

// The level's output of image pixel i: remodulated by the albedo where
// given, written packed or split
__device__ __forceinline__ void store_pixel(const ptdn::AtrousArgs& a,
                                            int i, float out[4]) {
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
    if (y < 0 || y >= a.h || x < 0 || x >= a.w) continue;
    const int i = y * a.w + x;
    s_cv[k] = load_cv(a, i);
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
                  a.cv, a.var, a.w};
  float out[4];
  ptdn::atrous_pixel(in, a.w, a.h, y, x, level, a.blur_variance != 0,
                     ptdn::AtrousSigmas{a.sigma_l, a.sigma_n, a.sigma_x},
                     out);
  store_pixel(a, y * a.w + x, out);
}

// The shard's packed level input at shard row y (-halo <= y < h + halo):
// its own rows, or a halo row
struct ShardRows {
  const float4* cv;     // the shard's h rows
  const float4* top;
  const float4* bottom;
  int w, h, halo;
  __device__ __forceinline__ const float4* row(int y) const {
    return y < 0 ? top + (y + halo) * w
                 : (y >= h ? bottom + (y - h) * w : cv + y * w);
  }
};

// The taps from the staged tile; the pre-blur's neighbours, at image row
// qy (one of y - 1, y, y + 1), from the shard's buffers: the three rows
// are picked once a pixel, so the blur's reads take no branch
struct ShardIn : ptdn::StagedTaps {
  const float4* near[3];   // the shard's rows of image rows y - 1, y, y + 1
  int y;                   // the pixel's image row
  __device__ __forceinline__ float blur_var(int qy, int qx) const {
    return near[qy - y + 1][qx].w;
  }
};

// Shard mode. A block takes RP adjacent row phases (ptdn_atrous_shard:
// kMaxRowPhases where a lattice holds kRows / kMaxRowPhases or fewer of
// the shard's rows, else 1) and
// `phases` adjacent column phases, of those lattices a tile of kRows /
// RP rows a row phase and 32 / phases columns: warp r the row phase r /
// (kRows / RP), its lattice row r % (kRows / RP), lane q as
// atrous_level_kernel's. Staged [row phase][row][column][phase]
// (ops/cuda/atrous.py:atrous_shard_tiling and atrous_shard_pixels mirror
// the mapping). Each thread runs atrous_pixel, the unsharded level's
// code. 4 blocks an SM (at most 64 registers): 5 spilled.
template <int RP>
__global__ void __launch_bounds__(kRows * 32, 4)
    atrous_shard_kernel(ptdn::AtrousShardArgs s) {
  constexpr int kTr = kRows / RP;               // lattice rows a row phase
  constexpr int kStaged = RP * (kTr + 2 * kHalo) * (8 + 2 * kHalo) * 4;
  __shared__ float4 s_cv[kStaged];
  __shared__ float4 s_pos[kStaged];
  __shared__ float4 s_nrm[kStaged];
  const ptdn::AtrousArgs& a = s.a;
  const int level = a.level, step = 1 << level, np = a.phases;
  const int cols = 32 / np;                   // lattice columns of a tile
  const int tiles = a.tiles_x * a.tiles_y, groups = step / np;
  const int g = blockIdx.x / tiles, t = blockIdx.x - g * tiles;
  const int gy = g / groups;
  const int py = gy * RP, px = (g - gy * groups) * np;
  const int ty = t / a.tiles_x, tx = t - ty * a.tiles_x;
  // shard pixel of staged row 0, column 0, phase 0 of row phase py
  const int oy = py + (ty * kTr - kHalo) * step;
  const int ox = px + (tx * cols - kHalo) * step;
  const int sc = cols + 2 * kHalo;            // staged columns a phase
  const int srow = sc * np;
  const int sphase = (kTr + 2 * kHalo) * srow;  // staged pixels a row phase

  const ShardRows rows{reinterpret_cast<const float4*>(a.cv),
                       reinterpret_cast<const float4*>(s.top),
                       reinterpret_cast<const float4*>(s.bottom),
                       a.w,
                       a.h,
                       s.halo};
  const float4* stat = reinterpret_cast<const float4*>(a.stat);
  for (int k = threadIdx.x; k < RP * sphase; k += kRows * 32) {
    const int j = RP == 1 ? 0 : k / sphase, kk = k - j * sphase;
    const int r = kk / srow, c = (kk - r * srow) / np, p = kk % np;
    const int y = oy + j + r * step, x = ox + c * step + p;
    const int gy_ = s.row0 + y;
    if (y < -s.halo || y >= a.h + s.halo || gy_ < 0 || gy_ >= s.full_h ||
        x < 0 || x >= a.w)
      continue;
    s_cv[k] = rows.row(y)[x];
    const int i = (y + s.static_halo) * a.w + x;
    s_pos[k] = stat[2 * i];
    s_nrm[k] = stat[2 * i + 1];
  }
  __syncthreads();

  const int r = threadIdx.x >> 5, q = threadIdx.x & 31;
  const int j = r / kTr, lr = r - j * kTr;
  const int l = q / np, p = q - l * np;
  const int y = oy + j + (lr + kHalo) * step, x = ox + (l + kHalo) * step + p;
  if (y >= a.h || x >= a.w) return;
  const ShardIn in{{s_cv, s_pos, s_nrm, srow, np,
                    j * sphase + (lr + kHalo) * srow + (l + kHalo) * np + p},
                   {rows.row(y - 1), rows.row(y), rows.row(y + 1)},
                   s.row0 + y};
  float out[4];
  ptdn::atrous_pixel(in, a.w, s.full_h, s.row0 + y, x, level,
                     a.blur_variance != 0,
                     ptdn::AtrousSigmas{a.sigma_l, a.sigma_n, a.sigma_x},
                     out);
  store_pixel(a, y * a.w + x, out);
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

// The shard's launch geometry (ops/cuda/atrous.py:atrous_shard_tiling
// mirrors it): the column phases as atrous_tiling's, and kMaxRowPhases
// row phases a block where a lattice holds kRows / kMaxRowPhases or fewer
// of the shard's rows (and the step has that many), else one. The
// shard's own rows are packed.
extern "C" int ptdn_atrous_shard(const ptdn::AtrousShardArgs* in,
                                 void* stream) {
  ptdn::AtrousShardArgs s = *in;
  ptdn::AtrousArgs& a = s.a;
  if (a.var != nullptr) return (int)cudaErrorInvalidValue;
  const int step = 1 << a.level;
  a.phases = min(4, step);
  const int rows = (a.h + step - 1) / step;   // a lattice's rows, at most
  const int rp =
      (rows <= kRows / kMaxRowPhases && step >= kMaxRowPhases) ? kMaxRowPhases
                                                               : 1;
  const int tr = kRows / rp, cols = 32 / a.phases;
  a.tiles_y = (rows + tr - 1) / tr;
  a.tiles_x = ((a.w + step - 1) / step + cols - 1) / cols;
  const long long blocks =
      (long long)(step / rp) * (step / a.phases) * a.tiles_y * a.tiles_x;
  if (a.h > 0 && a.w > 0) {
    if (rp == 1)
      atrous_shard_kernel<1><<<(unsigned)blocks, kRows * 32, 0,
                               (cudaStream_t)stream>>>(s);
    else
      atrous_shard_kernel<kMaxRowPhases><<<(unsigned)blocks, kRows * 32, 0,
                                           (cudaStream_t)stream>>>(s);
  }
  return (int)cudaGetLastError();
}
