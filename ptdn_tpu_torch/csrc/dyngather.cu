// Kernel O (take_chain): a chain of `reps` take_along_axis gathers of an
// (S, L) int32 array x along one axis:
//   acc = take_along_axis(x, idx, axis)
//   acc = take_along_axis(x, (idx + acc) mod x.shape[axis], axis)   (reps-1 x)
// with a floor modulo.
//
// Replaces the TPU kernel benchmarks/micro_dyngather.py:kern (launched by
// its probe, :29), which maps which take_along_axis shapes Mosaic lowers
// inside a TPU kernel (tpu.dynamic_gather) and times them; no renderer
// path calls it. Its script is ptdn_tpu_torch/probes/dyngather.py.
//
// What bounds it on this card: neither the bytes (x and idx read, the
// result written, 12 B an element: 1.5 MB at the probe's 131,072
// elements, under a microsecond) nor the operations, but where the
// dependent loads go. Each element's chain makes `reps` loads, each
// depending on the last, within one line of x: its row (axis 1) or its
// column (axis 0). From device memory, a warp's 32 lanes on axis 0 read
// 32 random rows, 32 separate sectors a load, and the chains run at the
// L2's sector rate. So the staged kernel copies the lines a block's
// elements read into shared memory first, with coalesced 16-byte loads
// where the rows allow, and walks every chain there: x leaves device
// memory once a block, not `reps` times a lane.
//
// A tile is `lines` whole lines: on axis 1 consecutive rows, staged as
// they lie; on axis 0 a stripe of `lines` consecutive columns, staged
// row-major as (S, lines) (16 columns: 32 would spread a warp's random
// reads over all 32 banks, but stages twice the bytes a block, and ran
// slower on both timed chains on axis 0). Each block takes `per`
// consecutive elements of one tile (in x's order within it), four a
// thread, their four chains interleaved; a tile of more elements than
// that (a long row of a short array) is staged by each of its blocks.
// A floor modulo by a power of two is a mask. The wrapper
// (ops/cuda/dyngather.py:tile_plan) picks lines and per by shape; a line
// longer than a block's shared memory (above 58,112 int32, 227 KB) takes
// the global-load kernel, a thread an element, its chain from L2.
//
// A TPU gathers only within a vector register (8 sublanes x 128 lanes),
// which is what the probe maps; a CUDA thread reads any element, so no
// shape is refused, and the staged lines are this card's form of the
// TPU's in-register gathers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;   // threads per block
constexpr int kIlp = 4;       // chains a thread walks at once

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

// (k + acc) mod m, the int32 sum wrapping as the reference's and torch's
// do; mask = m - 1 where m is a power of two, else -1
__device__ __forceinline__ int next_index(int k, int acc, int m, int mask) {
  const int s = (int)((unsigned)k + (unsigned)acc);
  return mask >= 0 ? (s & mask) : floor_mod(s, m);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Copy rows [0, rows) of `cols` int32 each, row r at src + r * stride,
// into dst as (rows, cols); 16-byte pieces where every row start is
// aligned and cols is a multiple of 4
__device__ __forceinline__ void stage(int* dst, const int* src, int rows,
                                      int cols, int stride) {
  if (cols % 4 == 0 && stride % 4 == 0 && aligned16(src)) {
    const int quads = cols / 4;
    for (int k = threadIdx.x; k < rows * quads; k += kBlock) {
      const int r = k / quads, q = k - r * quads;
      reinterpret_cast<int4*>(dst)[k] =
          __ldg(reinterpret_cast<const int4*>(src + (size_t)r * stride) + q);
    }
  } else {
    for (int k = threadIdx.x; k < rows * cols; k += kBlock) {
      const int r = k / cols;
      dst[k] = __ldg(src + (size_t)r * stride + (k - r * cols));
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    take_chain_staged_kernel(const int* __restrict__ x,
                             const int* __restrict__ idx, int s_rows,
                             int l_cols, int axis, int reps, int lines,
                             int per, int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* line = reinterpret_cast<int*>(smem4);
  const int n_lines = axis == 0 ? l_cols : s_rows;
  const int m = axis == 0 ? s_rows : l_cols;   // a line's length
  const int mask = (m & (m - 1)) == 0 ? m - 1 : -1;
  const int tiles = (n_lines + lines - 1) / lines;
  const int parts = (lines * m + per - 1) / per;   // blocks a full tile
  const int tile = blockIdx.x / parts, part = blockIdx.x - tile * parts;
  if (tile >= tiles) return;
  const int l0 = tile * lines, w = min(lines, n_lines - l0);
  const int total = w * m;   // the tile's elements
  const int lo = part * per;
  if (lo >= total) return;   // block-uniform
  const int hi = min(lo + per, total);
  // axis 1: rows [l0, l0 + w) as they lie; axis 0: the stripe of
  // columns [l0, l0 + w) of every row, as (S, w)
  if (axis == 1)
    stage(line, x + (size_t)l0 * l_cols, 1, total, 0);
  else
    stage(line, x + l0, s_rows, w, l_cols);
  __syncthreads();
  for (int e0 = lo + threadIdx.x; e0 < hi; e0 += kIlp * kBlock) {
    // element e of the tile: axis 1 (row l0 + e / m, column e % m), at
    // line offset (e / m) * m; axis 0 (row e / w, column l0 + e % w),
    // reading line[j * w + e % w]
    int k[kIlp], acc[kIlp], base[kIlp], step[kIlp];
    size_t g[kIlp];
#pragma unroll
    for (int q = 0; q < kIlp; ++q) {
      const int e = min(e0 + q * kBlock, hi - 1);
      const int a = e / (axis == 0 ? w : m), b = e - a * (axis == 0 ? w : m);
      g[q] = axis == 0 ? (size_t)a * l_cols + l0 + b
                       : (size_t)(l0 + a) * l_cols + b;
      base[q] = axis == 0 ? b : a * m;
      step[q] = axis == 0 ? w : 1;
      k[q] = __ldg(idx + g[q]);
      acc[q] = line[base[q] + k[q] * step[q]];
    }
    for (int r = 1; r < reps; ++r) {
#pragma unroll
      for (int q = 0; q < kIlp; ++q)
        acc[q] = line[base[q] + next_index(k[q], acc[q], m, mask) * step[q]];
    }
#pragma unroll
    for (int q = 0; q < kIlp; ++q)
      if (e0 + q * kBlock < hi) out[g[q]] = acc[q];
  }
}

// A thread an element, its chain's loads from device memory (L2): the
// lines too long to stage
__global__ void take_chain_kernel(const int* __restrict__ x,
                                  const int* __restrict__ idx, int s_rows,
                                  int l_cols, int axis, int reps,
                                  int* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= s_rows * l_cols) return;
  const int row = e / l_cols, col = e % l_cols;
  const int m = axis == 0 ? s_rows : l_cols;
  const int mask = (m & (m - 1)) == 0 ? m - 1 : -1;
  const int k = __ldg(idx + e);
  int acc = axis == 0 ? __ldg(x + k * l_cols + col) : __ldg(x + row * l_cols + k);
  for (int r = 1; r < reps; ++r) {
    const int j = next_index(k, acc, m, mask);
    acc = axis == 0 ? __ldg(x + j * l_cols + col) : __ldg(x + row * l_cols + j);
  }
  out[e] = acc;
}

}  // namespace

// lines > 0: the staged kernel, tiles of `lines` lines, `per` elements a
// block; lines == 0: the global-load kernel
extern "C" int ptdn_take_chain(const int* x, const int* idx, int s_rows,
                               int l_cols, int axis, int reps, int lines,
                               int per, int* out, void* stream) {
  const int total = s_rows * l_cols;
  if (total <= 0) return (int)cudaGetLastError();
  if (lines > 0) {
    const int n_lines = axis == 0 ? l_cols : s_rows;
    const int m = axis == 0 ? s_rows : l_cols;
    const int tiles = (n_lines + lines - 1) / lines;
    const int parts = (lines * m + per - 1) / per;
    const size_t smem = (size_t)lines * m * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          take_chain_staged_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    take_chain_staged_kernel<<<tiles * parts, kBlock, smem,
                               (cudaStream_t)stream>>>(
        x, idx, s_rows, l_cols, axis, reps, lines, per, out);
  } else {
    const int block = 256;
    take_chain_kernel<<<(total + block - 1) / block, block, 0,
                        (cudaStream_t)stream>>>(x, idx, s_rows, l_cols, axis,
                                                reps, out);
  }
  return (int)cudaGetLastError();
}
