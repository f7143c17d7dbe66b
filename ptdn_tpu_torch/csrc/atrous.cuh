// One pixel of an edge-stopping a-trous level of SVGF (denoise.cu:77-170),
// shared by kernel D (atrous.cu) and kernel L (reproject_atrous.cu).
//
// The 3x3 Gaussian pre-blur of the variance from its neighbours' input
// variance (border-renormalized), then the 25 taps of the 5x5 B3 spline
// at step 1 << level with the luminance, normal and position weights
// folded into one exp (exact because the reference's min(1, exp(-x))
// clamps are no-ops for x >= 0), variance propagated with squared
// weights. Taps outside the image weigh zero, as the zero padding of
// denoise/atrous.py:36-64 makes them. The level's input color and
// variance come through `in` (in.color(qy, qx, c), in.var(qy, qx)), so D
// reads them from device memory and L from its block's shared tile.
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

struct AtrousSigmas {
  float l, n, x;
};

// Pixel (y, x) of level `level`; writes the filtered color to out[0..2]
// and the new variance to out[3] (before any albedo remodulation).
template <class In>
__device__ inline void atrous_pixel(const In& in, const float* pos,
                                    const float* nrm, int w, int h, int y,
                                    int x, int level, bool blur_variance,
                                    AtrousSigmas sg, float out[4]) {
  const int i = y * w + x;
  const int step = 1 << level;

  float var_p;
  if (blur_variance) {
    float vsum = 0.f, wsum = 0.f;
    for (int k = 0; k < 9; ++k) {
      const int qy = y + k / 3 - 1, qx = x + k % 3 - 1;
      if (qy < 0 || qy >= h || qx < 0 || qx >= w) continue;
      vsum = vsum + kG3[k] * in.var(qy, qx) * 1.f;
      wsum = wsum + kG3[k] * 1.f;
    }
    var_p = jmax(vsum / wsum, 0.f);
  } else {
    var_p = jmax(in.var(y, x), 0.f);
  }
  const float denom_l = 1.0f / fmaf(sqrtf(var_p), sg.l, 1e-6f);
  const float inv_sn = 1.0f / (sg.n + 1e-6f);
  const float inv_sx = 1.0f / (sg.x + 1e-6f);

  const float cr = in.color(y, x, 0), cg = in.color(y, x, 1),
              cb = in.color(y, x, 2);
  const float lp = dot3(0.2126f, 0.7152f, 0.0722f, cr, cg, cb);
  const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];

  float csr = 0.f, csg = 0.f, csb = 0.f, vs = 0.f, ws = 0.f, w2s = 0.f;
  for (int k = 0; k < 25; ++k) {
    const int j = k / 5 - 2, ii = k % 5 - 2;
    const int qy = y + j * step, qx = x + ii * step;
    if (qy < 0 || qy >= h || qx < 0 || qx >= w) continue;
    const int q = qy * w + qx;
    const float qr = in.color(qy, qx, 0), qg = in.color(qy, qx, 1),
                qb = in.color(qy, qx, 2);
    float wgt;
    if (j == 0 && ii == 0) {
      wgt = kH5[k] * 1.f;
    } else {
      const float lq = dot3(0.2126f, 0.7152f, 0.0722f, qr, qg, qb);
      const float dxp = px - pos[3 * q], dyp = py - pos[3 * q + 1],
                  dzp = pz - pos[3 * q + 2];
      const float dist_x = sqrtf(dot3(dxp, dyp, dzp, dxp, dyp, dzp));
      const float dxn = nx - nrm[3 * q], dyn = ny - nrm[3 * q + 1],
                  dzn = nz - nrm[3 * q + 2];
      const float dist_n = sqrtf(dot3(dxn, dyn, dzn, dxn, dyn, dzn));
      const float arg =
          fmaf(dist_x, inv_sx, fmaf(fabsf(lp - lq), denom_l, dist_n * inv_sn));
      wgt = kH5[k] * expf(-arg) * 1.f;
    }
    ws = ws + wgt;
    w2s = fmaf(wgt, wgt, w2s);
    csr = fmaf(qr, wgt, csr);
    csg = fmaf(qg, wgt, csg);
    csb = fmaf(qb, wgt, csb);
    vs = fmaf(in.var(qy, qx) * wgt, wgt, vs);
  }

  if (ws > 1e-5f) {  // 10e-6 (denoise.cu:159)
    const float inv_w = 1.0f / ws;
    out[0] = csr * inv_w;
    out[1] = csg * inv_w;
    out[2] = csb * inv_w;
    out[3] = vs / (w2s > 0.f ? w2s : 1.f);
  } else {
    out[0] = cr;
    out[1] = cg;
    out[2] = cb;
    out[3] = in.var(y, x);
  }
}

}  // namespace ptdn
