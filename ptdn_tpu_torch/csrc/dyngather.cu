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
// One thread per element walks its own chain of `reps` dependent loads
// along its row (axis 1) or column (axis 0). What bounds it: the latency
// of the dependent loads; the bytes (x and idx read, the result written,
// 12 B an element) take well under a microsecond at the probe's 131,072
// elements, and x (512 KB) stays in L2. A TPU gathers only within a
// vector register (8 sublanes x 128 lanes), which is what the probe maps;
// a GPU thread reads any element, so no shape is refused.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__global__ void take_chain_kernel(const int* __restrict__ x,
                                  const int* __restrict__ idx, int s_rows,
                                  int l_cols, int axis, int reps,
                                  int* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= s_rows * l_cols) return;
  const int row = e / l_cols, col = e % l_cols;
  const int m = axis == 0 ? s_rows : l_cols;
  const int k = __ldg(idx + e);
  int acc = axis == 0 ? __ldg(x + k * l_cols + col) : __ldg(x + row * l_cols + k);
  for (int r = 1; r < reps; ++r) {
    // the int32 sum wraps, as the reference's and torch's do
    const int j = floor_mod((int)((unsigned)k + (unsigned)acc), m);
    acc = axis == 0 ? __ldg(x + j * l_cols + col) : __ldg(x + row * l_cols + j);
  }
  out[e] = acc;
}

}  // namespace

extern "C" int ptdn_take_chain(const int* x, const int* idx, int s_rows,
                               int l_cols, int axis, int reps, int* out,
                               void* stream) {
  const int total = s_rows * l_cols;
  if (total > 0) {
    const int block = 256;
    take_chain_kernel<<<(total + block - 1) / block, block, 0,
                        (cudaStream_t)stream>>>(x, idx, s_rows, l_cols, axis,
                                                reps, out);
  }
  return (int)cudaGetLastError();
}
