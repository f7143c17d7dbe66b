// Kernel C: SVGF back-projection, in two modes.
//
// Stencil mode replaces the TPU kernel ptdn_tpu/ops/pallas/reproject.py:
// back_projection_stencil_pallas (_kernel): motion of at most one pixel,
// every static-camera frame. Band mode is the far branch of
// back_projection_auto, which the JAX package runs as XLA code
// (ptdn_tpu/denoise/reproject.py:back_projection_banded); it runs on
// every frame of a moving camera, where its plain version is some
// hundreds of small launches, so it has a kernel too. One thread per
// pixel runs reproject.cuh:reproject_pixel. The TPU kernel built the taps
// from nine masked shifted views of the whole strip, and the banded path
// gathered them from a packed slab table, because a TPU has no per-lane
// gather and its gathers are count-bound; a GPU thread loads them
// directly.
//
// What bounds it: bytes. Per pixel ~60 B of current frame in, 9 taps of
// 40 B that neighbouring threads share through L1/L2 (a smooth camera
// motion keeps a warp's taps neighbours), ~28 B out; at 800x800 that is
// ~56 MB of compulsory traffic, about 17 us at the H100's 3.35 TB/s.
//
// Row offset (a shard of a taller image, parallel/sharded.py): `rows`
// (reproject.cuh:ReprojRows) places the launch's rows in the image and
// the previous frame's window, the rows that a still frame's stencil
// reaches (two past the shard) or the whole previous frame for the band
// mode. Unsharded: {0, h, 0}.
#include "reproject.cuh"

namespace {

template <bool Banded>
__device__ __forceinline__ void back_projection_thread(
    ptdn::ReprojArgs a, ptdn::ReprojRows rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  const int iy = i / a.w, ix = i - iy * a.w;
  const ptdn::Accum r = ptdn::reproject_pixel<Banded, true>(a, iy, ix, rows);
  a.acc[3 * i] = r.acc[0];
  a.acc[3 * i + 1] = r.acc[1];
  a.acc[3 * i + 2] = r.acc[2];
  a.mom[2 * i] = r.mom[0];
  a.mom[2 * i + 1] = r.mom[1];
  a.var[i] = r.var;
  a.hist[i] = r.hist;
}

__global__ void back_projection_stencil_kernel(ptdn::ReprojArgs a,
                                               ptdn::ReprojRows rows) {
  back_projection_thread<false>(a, rows);
}

__global__ void back_projection_banded_kernel(ptdn::ReprojArgs a,
                                              ptdn::ReprojRows rows) {
  back_projection_thread<true>(a, rows);
}

constexpr int kBlock = 256;

}  // namespace

extern "C" int ptdn_back_projection_stencil(const ptdn::ReprojArgs* a,
                                            const ptdn::ReprojRows* rows,
                                            void* stream) {
  const int n = a->w * a->h;
  if (n > 0)
    back_projection_stencil_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                                     (cudaStream_t)stream>>>(*a, *rows);
  return (int)cudaGetLastError();
}

extern "C" int ptdn_back_projection_banded(const ptdn::ReprojArgs* a,
                                           const ptdn::ReprojRows* rows,
                                           void* stream) {
  const int n = a->w * a->h;
  if (n > 0)
    back_projection_banded_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                                    (cudaStream_t)stream>>>(*a, *rows);
  return (int)cudaGetLastError();
}
