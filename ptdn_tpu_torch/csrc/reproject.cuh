// One pixel of SVGF's back-projection (denoise.cu:185-317), shared by
// kernel C (reproject.cu: the stencil and band modes, on the whole image
// or a shard's rows) and kernel L (reproject_atrous.cu, which feeds it to
// the a-trous level 1 in the same block).
//
// The thread reprojects its world position through the previous view
// matrix (denoise.cu:195-217, without tan(fov/2) as the reference),
// reads its 3x3 previous-frame taps with bounds checks (outside the
// image a tap is invalid, as the TPU kernels' geom -1 padding makes it)
// through an accessor of the previous frame's planes (ImagePrev: the
// whole image's in device memory; a shard's: reproject.cu), tests each
// tap (same geom, normal distance <= 0.1), and runs
// _accumulate_from_taps: the all-valid 2x2 bilinear, else the 3x3
// uniform fallback, the color and moment EWMA with the reference's
// inverted moment alpha, the history length and variance = m2 - m1^2.
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

// The previous frame's pixel coordinates (prevx, prevy) of the world
// position pos[0..2], reprojected through the previous view matrix `v`
// onto the w x full_h image (denoise.cu:195-217, without tan(fov/2) as
// the reference; denoise/reproject.py:_reproj_base). Kernel C's pixels
// and kernel T's (motion.cu) take their bases from it.
__device__ __forceinline__ void prev_coords(const float* v, const float* pos,
                                            int w, int full_h, float& prevx,
                                            float& prevy) {
  const float px = pos[0], py = pos[1], pz = pos[2];
  const float vsx = row4(v, 0, px, py, pz);
  const float vsy = row4(v, 1, px, py, pz);
  const float vsz = row4(v, 2, px, py, pz);
  prevx = fmaf(-(vsx / vsz) * 0.5f + 0.5f, (float)w, -0.5f);
  prevy = fmaf(-(vsy / vsz) * 0.5f + 0.5f, (float)full_h, -0.5f);
}

// A tap's normal distance test, sqrt(d2) <= 0.1f, without the square
// root: the correctly rounded square root is monotonic, so it holds
// exactly where d2 <= the largest float whose square root is <= 0.1f,
// this one (tests/test_torch_parallel.py holds sqrt of it and of the
// next float against 0.1f), NaN and infinity failing both
constexpr float kNormalDist2 = 0x1.47ae16p-7f;

// The previous frame's planes of the whole image, as ReprojArgs holds
// them (kernel L, kernel C unsharded). rows(by) gives the taps' rows by
// - 1, by, by + 1 (by an image row); a tap (dy, dx) of them is read at
// column qx, inside the image.
struct ImagePrev {
  const ReprojArgs& a;
  struct Rows {
    const ReprojArgs& a;
    int by;
    __device__ __forceinline__ int q(int dy, int qx) const {
      return (by + dy) * a.w + qx;
    }
    __device__ __forceinline__ int geom(int dy, int qx) const {
      return a.pg[q(dy, qx)];
    }
    __device__ __forceinline__ void normal(int dy, int qx, float n[3]) const {
      const int k = q(dy, qx);
      n[0] = a.pn[3 * k];
      n[1] = a.pn[3 * k + 1];
      n[2] = a.pn[3 * k + 2];
    }
    // color, moments and history length
    __device__ __forceinline__ void values(int dy, int qx,
                                           float out6[6]) const {
      const int k = q(dy, qx);
      out6[0] = a.ch[3 * k];
      out6[1] = a.ch[3 * k + 1];
      out6[2] = a.ch[3 * k + 2];
      out6[3] = a.mh[2 * k];
      out6[4] = a.mh[2 * k + 1];
      out6[5] = (float)a.hl[k];
    }
  };
  __device__ __forceinline__ Rows rows(int by) const { return Rows{a, by}; }
  // band mode: the slab start of image row gy's band
  __device__ __forceinline__ int start(int gy) const {
    return a.starts[gy / a.band_rows];
  }
};

// The back-projection of pixel (iy, ix) of the launch's rows, image row
// gy of a full_h-row image (a shard's rows lie in a taller image; the
// whole image's are gy = iy, full_h = a.h). Its current-frame values and
// its own history length are read at iy * w + ix, the previous frame's
// taps through `prev` (ImagePrev, or a shard's staged tile or buffers,
// reproject.cu) at image rows. Stencil mode (Banded false): the caller
// gates on motion of at most one pixel, and the taps are read around the
// pixel itself at the clipped base offset, as the TPU stencil's shifted
// views do. Band mode: the taps are read at the true base, and a pixel
// whose clipped padded base row gi = clip(fy + 1, 0, full_h + 1) lies
// outside its band's slab [start, start + slab_h) is rejected
// (ptdn_tpu/denoise/reproject.py:back_projection_banded).
template <bool Banded, class Prev>
__device__ inline Accum reproject_pixel(const ReprojArgs& a, int iy, int ix,
                                        int gy, int full_h,
                                        const Prev& prev) {
  const int i = iy * a.w + ix;
  const float cr = a.color[3 * i], cg = a.color[3 * i + 1],
              cb = a.color[3 * i + 2];
  const float lum = dot3(0.2126f, 0.7152f, 0.0722f, cr, cg, cb);
  const int geo = a.geom[i];
  const float n_hist = (float)a.hl[i];

  bool valid = false;
  float pc[3] = {0.f, 0.f, 0.f}, pm[2] = {0.f, 0.f}, ph = 0.f;
  if (geo != -1 && n_hist > 0.f) {
    float prevx, prevy;
    prev_coords(a.view, a.pos + 3 * i, a.w, full_h, prevx, prevy);
    const float floorx = floorf(prevx), floory = floorf(prevy);
    const float fracx = prevx - floorx, fracy = prevy - floory;
    bool base_valid =
        (floorx >= 0.f) && (floory >= 0.f) && (floorx < a.w) &&
        (floory < full_h);
    int fx, fy, by, bx;
    bool slab_ok = true;
    if constexpr (Banded) {
      fx = base_index(floorx);
      fy = base_index(floory);
      by = fy;
      bx = fx;
      const int gi = min(max(fy + 1, 0), full_h + 1);
      const int li = gi - prev.start(gy);
      slab_ok = (li >= 0) && (li < a.slab_h);
      base_valid = base_valid && slab_ok;
    } else {
      fx = __float2int_rz(floorx);
      fy = __float2int_rz(floory);
      // under the caller's gate (|f - pixel| <= 1) this is f
      by = gy + min(max(fy - gy, -1), 1);
      bx = ix + min(max(fx - ix, -1), 1);
    }
    const float cnx = a.nrm[3 * i], cny = a.nrm[3 * i + 1],
                cnz = a.nrm[3 * i + 2];
    const auto rows = prev.rows(by);

    // 3x3 taps (dy, dx) in row-major order; validity and values
    bool tv[9];
    for (int k = 0; k < 9; ++k) {
      const int dy = k / 3 - 1, dx = k % 3 - 1;
      const int qy = by + dy, qx = bx + dx;
      tv[k] = false;
      if (!slab_ok) continue;
      if (fx + dx < 0 || fx + dx >= a.w || fy + dy < 0 || fy + dy >= full_h)
        continue;
      if (qx < 0 || qx >= a.w || qy < 0 || qy >= full_h) continue;
      const int pg = rows.geom(dy, qx);
      if (pg == -1 || pg != geo) continue;
      float pn[3];
      rows.normal(dy, qx, pn);
      const float dnx = pn[0] - cnx, dny = pn[1] - cny, dnz = pn[2] - cnz;
      const float d2 = dot3(dnx, dny, dnz, dnx, dny, dnz);
      tv[k] = d2 <= kNormalDist2;
    }
    auto tap = [&](int k, float* out6) {
      rows.values(k / 3 - 1, bx + k % 3 - 1, out6);
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

// The whole image's pixel (iy, ix) (kernel L, kernel C unsharded)
template <bool Banded>
__device__ inline Accum reproject_pixel(const ReprojArgs& a, int iy, int ix) {
  return reproject_pixel<Banded>(a, iy, ix, iy, a.h, ImagePrev{a});
}

}  // namespace ptdn
