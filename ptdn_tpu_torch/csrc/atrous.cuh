// One pixel of an edge-stopping a-trous level of SVGF (denoise.cu:77-170),
// shared by kernel D (atrous.cu) and kernel L (reproject_atrous.cu).
//
// The 3x3 Gaussian pre-blur of the variance from its neighbours' input
// variance (border-renormalized), then the 25 taps of the 5x5 B3 spline
// at step 1 << level with the luminance, normal and position weights
// folded into one exp (exact because the reference's min(1, exp(-x))
// clamps are no-ops for x >= 0), variance propagated with squared
// weights. Taps outside the image weigh zero, as the zero padding of
// denoise/atrous.py:36-64 makes them. Every input comes through the
// accessor `in`, for the image pixel (qy, qx) that is tap (j, i) of the
// pixel (j = i = 0 the pixel itself):
//   in.cv(qy, qx, j, i)   color r g b and variance, a float4;
//   in.pos(qy, qx, j, i)  G-buffer position x y z (w unused);
//   in.nrm(qy, qx, j, i)  G-buffer normal x y z (w unused);
//   in.blur_var(qy, qx)   variance of a 3x3 pre-blur neighbour (step 1).
// D and L serve the taps from their blocks' staged tiles (StagedTaps: D
// a tile of a sub-lattice, L a dense tile of the image), D its pre-blur
// from device memory and L from its tile; the arithmetic is this
// function's for both.
#pragma once

#include "ptdn.cuh"

namespace {

__constant__ float kH5[25] = {
    1.f / 256, 1.f / 64, 3.f / 128, 1.f / 64, 1.f / 256,
    1.f / 64,  1.f / 16, 3.f / 32,  1.f / 16, 1.f / 64,
    3.f / 128, 3.f / 32, 9.f / 64,  3.f / 32, 3.f / 128,
    1.f / 64,  1.f / 16, 3.f / 32,  1.f / 16, 1.f / 64,
    1.f / 256, 1.f / 64, 3.f / 128, 1.f / 64, 1.f / 256};
__constant__ float kG3[9] = {1.f / 16, 1.f / 8, 1.f / 16, 1.f / 8, 1.f / 4,
                             1.f / 8,  1.f / 16, 1.f / 8, 1.f / 16};

}  // namespace

namespace ptdn {

// sqrtf(x) with zeros kept out of sqrtf: IEEE sqrtf takes a called slow
// path for +-0 (and subnormals), and flat surfaces make many zero normal
// distances. sqrt(+-0) = +-0, so the result is sqrtf's bit for bit.
__device__ __forceinline__ float sqrt_dist(float x) {
  const float r = sqrtf(x == 0.f ? 1.f : x);
  return x == 0.f ? x : r;
}

struct AtrousSigmas {
  float l, n, x;
};

// The taps of a pixel from a block's tile of color and variance,
// position and normal staged in shared memory, a float4 each: `c` is the
// index of the pixel itself there, and tap (j, i) lies j rows (`row`
// apart) and i columns (`col` apart) away. Each kernel adds blur_var.
struct StagedTaps {
  const float4* cv_;
  const float4* pos_;
  const float4* nrm_;
  int row, col;
  int c;
  __device__ __forceinline__ int at(int j, int i) const {
    return c + j * row + i * col;
  }
  __device__ __forceinline__ float4 cv(int, int, int j, int i) const {
    return cv_[at(j, i)];
  }
  __device__ __forceinline__ float4 pos(int, int, int j, int i) const {
    return pos_[at(j, i)];
  }
  __device__ __forceinline__ float4 nrm(int, int, int j, int i) const {
    return nrm_[at(j, i)];
  }
};

// Pixel (y, x) of level `level`; writes the filtered color to out[0..2]
// and the new variance to out[3] (before any albedo remodulation).
template <class In>
__device__ inline void atrous_pixel(const In& in, int w, int h, int y, int x,
                                    int level, bool blur_variance,
                                    AtrousSigmas sg, float out[4]) {
  const int step = 1 << level;
  const float4 c0 = in.cv(y, x, 0, 0);

  float var_p;
  if (blur_variance) {
    float vsum = 0.f, wsum = 0.f;
    for (int k = 0; k < 9; ++k) {
      const int qy = y + k / 3 - 1, qx = x + k % 3 - 1;
      if (qy < 0 || qy >= h || qx < 0 || qx >= w) continue;
      vsum = vsum + kG3[k] * in.blur_var(qy, qx) * 1.f;
      wsum = wsum + kG3[k] * 1.f;
    }
    var_p = jmax(vsum / wsum, 0.f);
  } else {
    var_p = jmax(c0.w, 0.f);
  }
  const float denom_l = 1.0f / fmaf(sqrtf(var_p), sg.l, 1e-6f);
  const float inv_sn = 1.0f / (sg.n + 1e-6f);
  const float inv_sx = 1.0f / (sg.x + 1e-6f);

  const float lp = dot3(0.2126f, 0.7152f, 0.0722f, c0.x, c0.y, c0.z);
  const float4 p0 = in.pos(y, x, 0, 0);
  const float4 n0 = in.nrm(y, x, 0, 0);

  float csr = 0.f, csg = 0.f, csb = 0.f, vs = 0.f, ws = 0.f, w2s = 0.f;
#pragma unroll
  for (int k = 0; k < 25; ++k) {
    const int j = k / 5 - 2, ii = k % 5 - 2;
    const int qy = y + j * step, qx = x + ii * step;
    if (qy < 0 || qy >= h || qx < 0 || qx >= w) continue;
    const float4 q = in.cv(qy, qx, j, ii);
    float wgt;
    if (j == 0 && ii == 0) {
      wgt = kH5[k] * 1.f;
    } else {
      const float lq = dot3(0.2126f, 0.7152f, 0.0722f, q.x, q.y, q.z);
      const float4 pq = in.pos(qy, qx, j, ii);
      const float dxp = p0.x - pq.x, dyp = p0.y - pq.y, dzp = p0.z - pq.z;
      const float dist_x = sqrt_dist(dot3(dxp, dyp, dzp, dxp, dyp, dzp));
      const float4 nq = in.nrm(qy, qx, j, ii);
      const float dxn = n0.x - nq.x, dyn = n0.y - nq.y, dzn = n0.z - nq.z;
      const float dist_n = sqrt_dist(dot3(dxn, dyn, dzn, dxn, dyn, dzn));
      const float arg =
          fmaf(dist_x, inv_sx, fmaf(fabsf(lp - lq), denom_l, dist_n * inv_sn));
      wgt = kH5[k] * expf(-arg) * 1.f;
    }
    ws = ws + wgt;
    w2s = fmaf(wgt, wgt, w2s);
    csr = fmaf(q.x, wgt, csr);
    csg = fmaf(q.y, wgt, csg);
    csb = fmaf(q.z, wgt, csb);
    vs = fmaf(q.w * wgt, wgt, vs);
  }

  if (ws > 1e-5f) {  // 10e-6 (denoise.cu:159)
    const float inv_w = 1.0f / ws;
    out[0] = csr * inv_w;
    out[1] = csg * inv_w;
    out[2] = csb * inv_w;
    out[3] = vs / (w2s > 0.f ? w2s : 1.f);
  } else {
    out[0] = c0.x;
    out[1] = c0.y;
    out[2] = c0.z;
    out[3] = c0.w;
  }
}

}  // namespace ptdn
