// Kernel D: one edge-stopping a-trous level of SVGF.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/atrous.py:
// atrous_level_pallas (_kernel). One thread per pixel: the 3x3 Gaussian
// pre-blur of the variance from its neighbours' input variance
// (border-renormalized), then the 25 taps of the 5x5 B3 spline at step
// 1 << level with the luminance, normal and position weights folded into
// one exp (exact because the reference's min(1, exp(-x)) clamps are
// no-ops for x >= 0), variance propagated with squared weights, and the
// albedo remodulation on the last level when asked. It reads the level's
// input buffers and writes separate output buffers (read-old/write-new,
// the race-free form of denoise.cu:153-161). Taps outside the image
// weigh zero, as the zero padding of denoise/atrous.py:36-64 makes them.
// The TPU kernel DMA'd row strips with halos into VMEM and shifted whole
// planes; a thread here reads its taps through L1/L2, so no strip, halo
// or packing is needed.
//
// What bounds it: at levels 1-2 the taps of neighbouring threads overlap
// and the level is compute bound (25 exps and ~400 flops per pixel); at
// levels 3-5 the taps of a warp span 8-32 px strides and the level moves
// toward the cache's bandwidth. Compulsory traffic is ~60 B per pixel.
#include "ptdn.cuh"

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

__constant__ float kH5[25] = {
    1.f / 256, 1.f / 64, 3.f / 128, 1.f / 64, 1.f / 256,
    1.f / 64,  1.f / 16, 3.f / 32,  1.f / 16, 1.f / 64,
    3.f / 128, 3.f / 32, 9.f / 64,  3.f / 32, 3.f / 128,
    1.f / 64,  1.f / 16, 3.f / 32,  1.f / 16, 1.f / 64,
    1.f / 256, 1.f / 64, 3.f / 128, 1.f / 64, 1.f / 256};
__constant__ float kG3[9] = {1.f / 16, 1.f / 8, 1.f / 16, 1.f / 8, 1.f / 4,
                             1.f / 8,  1.f / 16, 1.f / 8, 1.f / 16};

__global__ void atrous_level_kernel(ptdn::AtrousArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  const int y = i / a.w, x = i - y * a.w;
  const int step = 1 << a.level;

  float var_p;
  if (a.blur_variance) {
    float vsum = 0.f, wsum = 0.f;
    for (int k = 0; k < 9; ++k) {
      const int qy = y + k / 3 - 1, qx = x + k % 3 - 1;
      if (qy < 0 || qy >= a.h || qx < 0 || qx >= a.w) continue;
      vsum = vsum + kG3[k] * a.var[qy * a.w + qx] * 1.f;
      wsum = wsum + kG3[k] * 1.f;
    }
    var_p = ptdn::jmax(vsum / wsum, 0.f);
  } else {
    var_p = ptdn::jmax(a.var[i], 0.f);
  }
  const float denom_l = 1.0f / fmaf(sqrtf(var_p), a.sigma_l, 1e-6f);
  const float inv_sn = 1.0f / (a.sigma_n + 1e-6f);
  const float inv_sx = 1.0f / (a.sigma_x + 1e-6f);

  const float cr = a.color[3 * i], cg = a.color[3 * i + 1],
              cb = a.color[3 * i + 2];
  const float lp = ptdn::dot3(0.2126f, 0.7152f, 0.0722f, cr, cg, cb);
  const float px = a.pos[3 * i], py = a.pos[3 * i + 1], pz = a.pos[3 * i + 2];
  const float nx = a.nrm[3 * i], ny = a.nrm[3 * i + 1], nz = a.nrm[3 * i + 2];

  float csr = 0.f, csg = 0.f, csb = 0.f, vs = 0.f, ws = 0.f, w2s = 0.f;
  for (int k = 0; k < 25; ++k) {
    const int j = k / 5 - 2, ii = k % 5 - 2;
    const int qy = y + j * step, qx = x + ii * step;
    if (qy < 0 || qy >= a.h || qx < 0 || qx >= a.w) continue;
    const int q = qy * a.w + qx;
    const float qr = a.color[3 * q], qg = a.color[3 * q + 1],
                qb = a.color[3 * q + 2];
    float wgt;
    if (j == 0 && ii == 0) {
      wgt = kH5[k] * 1.f;
    } else {
      const float lq = ptdn::dot3(0.2126f, 0.7152f, 0.0722f, qr, qg, qb);
      const float dxp = px - a.pos[3 * q], dyp = py - a.pos[3 * q + 1],
                  dzp = pz - a.pos[3 * q + 2];
      const float dist_x = sqrtf(ptdn::dot3(dxp, dyp, dzp, dxp, dyp, dzp));
      const float dxn = nx - a.nrm[3 * q], dyn = ny - a.nrm[3 * q + 1],
                  dzn = nz - a.nrm[3 * q + 2];
      const float dist_n = sqrtf(ptdn::dot3(dxn, dyn, dzn, dxn, dyn, dzn));
      const float arg =
          fmaf(dist_x, inv_sx, fmaf(fabsf(lp - lq), denom_l, dist_n * inv_sn));
      wgt = kH5[k] * expf(-arg) * 1.f;
    }
    ws = ws + wgt;
    w2s = fmaf(wgt, wgt, w2s);
    csr = fmaf(qr, wgt, csr);
    csg = fmaf(qg, wgt, csg);
    csb = fmaf(qb, wgt, csb);
    vs = fmaf(a.var[q] * wgt, wgt, vs);
  }

  float outr, outg, outb, nv;
  if (ws > 1e-5f) {  // 10e-6 (denoise.cu:159)
    const float inv_w = 1.0f / ws;
    outr = csr * inv_w;
    outg = csg * inv_w;
    outb = csb * inv_w;
    nv = vs / (w2s > 0.f ? w2s : 1.f);
  } else {
    outr = cr;
    outg = cg;
    outb = cb;
    nv = a.var[i];
  }
  if (a.albedo != nullptr) {
    outr = outr * a.albedo[3 * i];
    outg = outg * a.albedo[3 * i + 1];
    outb = outb * a.albedo[3 * i + 2];
  }
  a.color_out[3 * i] = outr;
  a.color_out[3 * i + 1] = outg;
  a.color_out[3 * i + 2] = outb;
  a.var_out[i] = nv;
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
