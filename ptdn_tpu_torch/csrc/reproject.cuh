// One pixel of SVGF's back-projection (denoise.cu:185-317), shared by
// kernel C (reproject.cu: the stencil and band modes) and kernel L
// (reproject_atrous.cu, which feeds it to the a-trous level 1 in the
// same block).
//
// The thread reprojects its world position through the previous view
// matrix (denoise.cu:195-217, without tan(fov/2) as the reference),
// reads its 3x3 previous-frame taps straight from device memory with
// bounds checks (outside the image a tap is invalid, as the TPU kernels'
// geom -1 padding makes it), tests each tap (same geom, normal distance
// <= 0.1), and runs _accumulate_from_taps: the all-valid 2x2 bilinear,
// else the 3x3 uniform fallback, the color and moment EWMA with the
// reference's inverted moment alpha, the history length and variance =
// m2 - m1^2.
#pragma once

#include "ptdn.cuh"

namespace ptdn {

struct ReprojArgs {
  const float* color;   // (H, W, 3) raw 1-spp color
  const float* pos;     // (H, W, 3) G-buffer position
  const float* nrm;     // (H, W, 3) G-buffer normal
  const int* geom;      // (H, W)
  const float* ch;      // (H, W, 3) color history
  const float* mh;      // (H, W, 2) moment history
  const int* hl;        // (H, W) history length
  const float* pn;      // (H, W, 3) previous normal
  const int* pg;        // (H, W) previous geom id
  const float* view;    // (4, 4) previous view matrix, row-major
  float color_alpha;
  float moment_alpha;
  int w;
  int h;
  float* var;           // (H, W)
  float* acc;           // (H, W, 3)
  float* mom;           // (H, W, 2)
  int* hist;            // (H, W)
  const int* starts;    // band mode: (n_bands,) slab start of each band
  int band_rows;        // band mode: rows per band
  int slab_h;           // band mode: rows per slab of the padded grid
};

// A shard's rows (parallel/sharded.py): the launch's h pixel rows are
// image rows row0.. of a full_h-row image, and the previous frame's
// planes (ch, mh, hl, pn, pg) hold image rows from prev_row0, every row
// a tap reaches (the caller's window). The projection, the image-edge
// tests, the band and the slab take global rows. Unsharded: {0, h, 0}.
struct ReprojRows {
  int row0;
  int full_h;
  int prev_row0;
};

struct Accum {
  float var;
  float acc[3];
  float mom[2];
  int hist;
};

// A reprojected coordinate as the plain version takes it to an index:
// NaN to 0, clipped to +-2^30 (denoise/reproject.py:_reproj_base)
__device__ __forceinline__ int base_index(float f) {
  if (isnan(f)) return 0;
  return __float2int_rz(fminf(fmaxf(f, -1073741824.f), 1073741824.f));
}

// The back-projection of pixel (iy, ix). Stencil mode (Banded false):
// the caller gates on motion of at most one pixel, and the taps are read
// around the pixel itself at the clipped base offset, as the TPU
// stencil's shifted views do. Band mode: the taps are read at the true
// base, and a pixel whose clipped padded base row gi = clip(fy + 1, 0,
// h + 1) lies outside its band's slab [start, start + slab_h) is
// rejected (ptdn_tpu/denoise/reproject.py:back_projection_banded).
// Rows (kernel C) places the launch's rows by `rows`; without it (kernel
// L) they are the image, and the code is the unplaced one, each value
// read where that code read it.
template <bool Banded, bool Rows>
__device__ inline Accum reproject_pixel(const ReprojArgs& a, int iy, int ix,
                                        const ReprojRows& rows) {
  const int i = iy * a.w + ix;
  // the image's rows, and the pixel's image row
  const auto full_h = [&] { return Rows ? rows.full_h : a.h; };
  const auto gy = [&] { return Rows ? rows.row0 + iy : iy; };
  const float cr = a.color[3 * i], cg = a.color[3 * i + 1],
              cb = a.color[3 * i + 2];
  const float lum = dot3(0.2126f, 0.7152f, 0.0722f, cr, cg, cb);
  const int geo = a.geom[i];
  // the pixel's own history, in the previous frame's window
  const float n_hist =
      (float)a.hl[Rows ? (gy() - rows.prev_row0) * a.w + ix : i];

  bool valid = false;
  float pc[3] = {0.f, 0.f, 0.f}, pm[2] = {0.f, 0.f}, ph = 0.f;
  if (geo != -1 && n_hist > 0.f) {
    const float px = a.pos[3 * i], py = a.pos[3 * i + 1], pz = a.pos[3 * i + 2];
    const float* v = a.view;
    const float vsx = row4(v, 0, px, py, pz);
    const float vsy = row4(v, 1, px, py, pz);
    const float vsz = row4(v, 2, px, py, pz);
    const float prevx = fmaf(-(vsx / vsz) * 0.5f + 0.5f, (float)a.w, -0.5f);
    const float prevy =
        fmaf(-(vsy / vsz) * 0.5f + 0.5f, (float)full_h(), -0.5f);
    const float floorx = floorf(prevx), floory = floorf(prevy);
    const float fracx = prevx - floorx, fracy = prevy - floory;
    bool base_valid =
        (floorx >= 0.f) && (floory >= 0.f) && (floorx < a.w) &&
        (floory < full_h());
    int fx, fy, by, bx;
    bool slab_ok = true;
    if (Banded) {
      fx = base_index(floorx);
      fy = base_index(floory);
      by = fy;
      bx = fx;
      const int gi = min(max(fy + 1, 0), full_h() + 1);
      const int li = gi - a.starts[gy() / a.band_rows];
      slab_ok = (li >= 0) && (li < a.slab_h);
      base_valid = base_valid && slab_ok;
    } else {
      fx = __float2int_rz(floorx);
      fy = __float2int_rz(floory);
      // under the caller's gate (|f - pixel| <= 1) this is f
      by = gy() + min(max(fy - gy(), -1), 1);
      bx = ix + min(max(fx - ix, -1), 1);
    }
    const float cnx = a.nrm[3 * i], cny = a.nrm[3 * i + 1],
                cnz = a.nrm[3 * i + 2];

    // 3x3 taps (dy, dx) in row-major order; validity and values
    bool tv[9];
    for (int k = 0; k < 9; ++k) {
      const int dy = k / 3 - 1, dx = k % 3 - 1;
      const int qy = by + dy, qx = bx + dx;
      tv[k] = false;
      if (!slab_ok) continue;
      if (fx + dx < 0 || fx + dx >= a.w || fy + dy < 0 ||
          fy + dy >= full_h())
        continue;
      if (qx < 0 || qx >= a.w || qy < 0 || qy >= full_h()) continue;
      // the caller's window holds every row a tap reaches
      const int q = (Rows ? qy - rows.prev_row0 : qy) * a.w + qx;
      const int pg = a.pg[q];
      if (pg == -1 || pg != geo) continue;
      const float dnx = a.pn[3 * q] - cnx, dny = a.pn[3 * q + 1] - cny,
                  dnz = a.pn[3 * q + 2] - cnz;
      tv[k] = sqrtf(dot3(dnx, dny, dnz, dnx, dny, dnz)) <= 0.1f;
    }
    auto tap = [&](int k, float* out6) {
      const int qy = by + k / 3 - 1, qx = bx + k % 3 - 1;
      const int q = (Rows ? qy - rows.prev_row0 : qy) * a.w + qx;
      out6[0] = a.ch[3 * q];
      out6[1] = a.ch[3 * q + 1];
      out6[2] = a.ch[3 * q + 2];
      out6[3] = a.mh[2 * q];
      out6[4] = a.mh[2 * q + 1];
      out6[5] = (float)a.hl[q];
    };

    // 2x2 bilinear: taps (dy,dx) = (0,0), (0,1), (1,0), (1,1)
    const int quad[4] = {4, 5, 7, 8};
    const float wq[4] = {(1.f - fracx) * (1.f - fracy), fracx * (1.f - fracy),
                         (1.f - fracx) * fracy, fracx * fracy};
    bool all_valid = base_valid;
    for (int j = 0; j < 4; ++j) all_valid = all_valid && tv[quad[j]];
    float sumw = 0.f;
    if (all_valid) {
      for (int j = 0; j < 4; ++j) {
        float t6[6];
        tap(quad[j], t6);
        for (int c = 0; c < 3; ++c) pc[c] = fmaf(wq[j], t6[c], pc[c]);
        pm[0] = fmaf(wq[j], t6[3], pm[0]);
        pm[1] = fmaf(wq[j], t6[4], pm[1]);
        ph = fmaf(wq[j], t6[5], ph);
        sumw = sumw + wq[j];
      }
    }
    const bool bilinear_ok = all_valid && (sumw >= 0.01f);
    if (bilinear_ok) {
      const float safe = jmax(sumw, 1e-20f);
      for (int c = 0; c < 3; ++c) pc[c] = pc[c] / safe;
      pm[0] = pm[0] / safe;
      pm[1] = pm[1] / safe;
      ph = ph / safe;
      valid = true;
    } else {
      // 3x3 uniform fallback
      float fc[3] = {0.f, 0.f, 0.f}, fm[2] = {0.f, 0.f}, fh = 0.f, cnt = 0.f;
      for (int k = 0; k < 9; ++k) {
        if (!tv[k]) continue;
        float t6[6];
        tap(k, t6);
        for (int c = 0; c < 3; ++c) fc[c] = fc[c] + 1.f * t6[c];
        fm[0] = fm[0] + 1.f * t6[3];
        fm[1] = fm[1] + 1.f * t6[4];
        fh = fh + 1.f * t6[5];
        cnt = cnt + 1.f;
      }
      if (cnt > 0.f) {
        for (int c = 0; c < 3; ++c) pc[c] = fc[c] / cnt;
        pm[0] = fm[0] / cnt;
        pm[1] = fm[1] / cnt;
        ph = fh / cnt;
        valid = true;
      }
    }
  }

  Accum r;
  if (valid) {
    // EWMA (denoise.cu:288-307); the reference applies color_alpha to the
    // CURRENT color and moment_alpha to the PREVIOUS moments
    const float ca = jmax(1.0f / (n_hist + 1.0f), a.color_alpha);
    const float ma = jmax(1.0f / (n_hist + 1.0f), a.moment_alpha);
    r.acc[0] = fmaf(cr, ca, pc[0] * (1.f - ca));
    r.acc[1] = fmaf(cg, ca, pc[1] * (1.f - ca));
    r.acc[2] = fmaf(cb, ca, pc[2] * (1.f - ca));
    const float m1 = fmaf(ma, pm[0], (1.f - ma) * lum);
    const float m2 = fmaf(ma, pm[1], (1.f - ma) * lum * lum);
    r.mom[0] = m1;
    r.mom[1] = m2;
    r.var = jmax(fmaf(-m1, m1, m2), 0.f);
    r.hist = __float2int_rz(ph) + 1;
  } else {
    // total rejection (denoise.cu:311-315)
    r.acc[0] = cr;
    r.acc[1] = cg;
    r.acc[2] = cb;
    r.mom[0] = lum;
    r.mom[1] = lum * lum;
    r.var = 100.f;
    r.hist = 1;
  }
  return r;
}

// The whole image's rows (kernel L)
template <bool Banded>
__device__ inline Accum reproject_pixel(const ReprojArgs& a, int iy, int ix) {
  return reproject_pixel<Banded, false>(a, iy, ix, ReprojRows{});
}

}  // namespace ptdn
