// Kernel C: SVGF back-projection, in two modes, on the whole image or on
// a shard's rows.
//
// Stencil mode replaces the TPU kernel ptdn_tpu/ops/pallas/reproject.py:
// back_projection_stencil_pallas (_kernel): motion of at most one pixel,
// every static-camera frame. Band mode is the far branch of
// back_projection_auto, which the JAX package runs as XLA code
// (ptdn_tpu/denoise/reproject.py:back_projection_banded); it runs on
// every frame of a moving camera, where its plain version is some
// hundreds of small launches, so it has a kernel too. Every thread runs
// reproject.cuh:reproject_pixel for one pixel. The TPU kernel built the
// taps from nine masked shifted views of the whole strip, and the banded
// path gathered them from a packed slab table, because a TPU has no
// per-lane gather and its gathers are count-bound; a GPU thread loads
// them directly.
//
// What bounds it: bytes. Per pixel ~40 B of current frame in, ~40 B of
// previous frame (9 taps of 40 B that neighbouring pixels share: a
// smooth camera motion keeps a warp's taps neighbours), ~28 B out; at
// 800x800 that is ~69 MB of compulsory traffic, about 21 us at the
// H100's 3.35 TB/s.
//
// The whole image's band mode (back_projection_banded_kernel): a thread
// a pixel, blocks of 256 in row-major order, every tap read from the
// previous frame's planes in device memory (reproject.cuh:ImagePrev).
// The whole image's stencil mode is the shard kernel's with rows (0, h)
// and no halo rows (ops/cuda/reproject.py): the same bits, and no
// slower at cornell 800x800 and room 1920x1080 on the H100, where the
// shard band kernel is slower than this one (PERF.md).
//
// A shard (parallel/sharded.py; ReprojShardArgs): the launch's h rows
// are image rows row0.. of a full_h-row image. As kernel D's shard mode
// (atrous.cu), its inputs are read where they lie: the shard's own
// previous-frame planes as its state holds them (ch, mh, hl, pn, pg of
// its h rows), and the `halo` image rows above and below it as the
// exchange returns them (parallel/halo.py), packed (halo, W, 10) in
// denoise/reproject.py:prev_pack's layout (color, moments, history
// length, normal, geom id, the last and the history as floats; zeros
// past the image, which the row tests never read). Rows past the image
// and taps outside it are tested by their image row, so each pixel
// equals the whole image's launch bit for bit. A 100-row shard of an
// 800-wide image is 80,000 pixels: the whole image's kernel there made
// three dependent rounds of device loads a thread (the position, the
// nine taps' geom and normal, the taps' values), each tap five loads of
// five planes, and ran at ~5 empty launches. So a block takes a 32 x 8
// pixel tile (a 100-row shard's 325 blocks reach every SM of the
// H100's 132) and:
// - stencil mode (back_projection_shard_stencil_kernel): every tap lies
//   within kReach = 2 rows and columns of its pixel, so the block first
//   stages the tile's previous-frame records and that ring, 36 x 12
//   records of 40 B (17 KB), plane by plane in shared memory, each staged
//   row reading its own source once: the own planes by cp.async (one
//   round of loads in flight, the halo rows' packed floats converted on
//   the way), the top or bottom halo, or nothing past the image; each
//   thread then tests and reads its taps there (TilePrev);
// - band mode (back_projection_shard_banded_kernel): the taps lie
//   around the true base, which the data decides (the band rule bounds
//   them to the rows the shard's bands' slabs reach, which the halo
//   holds), so they are not staged: each thread picks the buffer of each
//   of its three tap rows once (own planes, top or bottom halo) and reads
//   its taps there (ShardPrev). The shard's bands' slab starts come by
//   value in the arguments (copying them to shared memory first, behind
//   a barrier, measured no faster).
// A launch of 80,000 pixels runs as one wave whose time is a thread's
// chain of work, so a tap's normal distance is tested without its
// square root (reproject.cuh:kNormalDist2, the same bits, in every
// kernel that reprojects): 9% off a 100-row shard in either mode on the
// H100 (PERF.md).
#include "reproject.cuh"

namespace ptdn {

// bands a shard's rows may span in band mode
// (ops/cuda/reproject.py:MAX_SHARD_BANDS)
constexpr int kMaxShardBands = 64;

// A shard's back-projection: `a` its h rows (its current frame, its own
// previous-frame planes and its outputs; starts unused), its halo rows
// and where it lies
struct ReprojShardArgs {
  ReprojArgs a;
  const float* top;      // (halo, W, 10) packed, the image rows above row 0
  const float* bottom;   // (halo, W, 10) packed, below row h - 1
  int row0;              // image row of the shard's row 0
  int full_h;            // image rows
  int halo;              // rows of top and bottom
  int band0;             // band mode: the band of image row row0
  int bands;             // band mode: the bands of the shard's rows
  int starts[kMaxShardBands];  // band mode: their slab starts
};

}  // namespace ptdn

namespace {

constexpr int kBlock = 256;       // the whole image's band-mode launch
constexpr int kTileW = 32;        // a shard's launch: a tile of pixels
constexpr int kTileH = 8;
constexpr int kReach = 2;         // stencil mode: the taps' reach
constexpr int kSideW = kTileW + 2 * kReach;     // staged records a row
constexpr int kStaged = kSideW * (kTileH + 2 * kReach);
constexpr int kPacked = 10;       // floats a pixel of a halo row

__device__ __forceinline__ void store_pixel(const ptdn::ReprojArgs& a,
                                            int i, const ptdn::Accum& r) {
  a.acc[3 * i] = r.acc[0];
  a.acc[3 * i + 1] = r.acc[1];
  a.acc[3 * i + 2] = r.acc[2];
  a.mom[2 * i] = r.mom[0];
  a.mom[2 * i + 1] = r.mom[1];
  a.var[i] = r.var;
  a.hist[i] = r.hist;
}

__global__ void back_projection_banded_kernel(ptdn::ReprojArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  const int iy = i / a.w, ix = i - iy * a.w;
  store_pixel(a, i, ptdn::reproject_pixel<true>(a, iy, ix));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The halo row of shard row y (y < 0: top, y >= h: bottom), packed
__device__ __forceinline__ const float* halo_row(
    const ptdn::ReprojShardArgs& s, int y) {
  return y < 0 ? s.top + (size_t)(y + s.halo) * s.a.w * kPacked
               : s.bottom + (size_t)(y - s.a.h) * s.a.w * kPacked;
}

// Stencil mode's staged records, plane by plane (a warp's 32 adjacent
// records are 32 consecutive words of each plane)
struct Staged {
  float ch[3][kStaged];
  float mh[2][kStaged];
  int hl[kStaged];
  float pn[3][kStaged];
  int pg[kStaged];
};

// The previous frame's taps from the staged tile, whose record 0 is
// image pixel (oy, ox)
struct TilePrev {
  const Staged& s;
  int oy, ox;
  struct Rows {
    const Staged& s;
    int base;     // record of image row by, column 0
    __device__ __forceinline__ int k(int dy, int qx) const {
      return base + dy * kSideW + qx;
    }
    __device__ __forceinline__ int geom(int dy, int qx) const {
      return s.pg[k(dy, qx)];
    }
    __device__ __forceinline__ void normal(int dy, int qx, float n[3]) const {
      const int j = k(dy, qx);
      n[0] = s.pn[0][j];
      n[1] = s.pn[1][j];
      n[2] = s.pn[2][j];
    }
    __device__ __forceinline__ void values(int dy, int qx,
                                           float out6[6]) const {
      const int j = k(dy, qx);
      out6[0] = s.ch[0][j];
      out6[1] = s.ch[1][j];
      out6[2] = s.ch[2][j];
      out6[3] = s.mh[0][j];
      out6[4] = s.mh[1][j];
      out6[5] = (float)s.hl[j];
    }
  };
  __device__ __forceinline__ Rows rows(int by) const {
    return Rows{s, (by - oy) * kSideW - ox};
  }
};

__global__ void __launch_bounds__(kTileW * kTileH)
    back_projection_shard_stencil_kernel(ptdn::ReprojShardArgs s) {
  __shared__ Staged st;
  const ptdn::ReprojArgs& a = s.a;
  const int ty = blockIdx.y * kTileH, tx = blockIdx.x * kTileW;
  const int oy = ty - kReach, ox = tx - kReach;   // shard row, column of
                                                  // record 0
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int k = tid; k < kStaged; k += kTileW * kTileH) {
    const int r = k / kSideW, c = k - r * kSideW;
    const int y = oy + r, x = ox + c, gy = s.row0 + y;
    // past the image (or past the halo, which the wrapper refuses where
    // a tap could read it): never read, the taps' tests exclude it
    if (x < 0 || x >= a.w || gy < 0 || gy >= s.full_h || y < -s.halo ||
        y >= a.h + s.halo)
      continue;
    if (y >= 0 && y < a.h) {
      const int q = y * a.w + x;
      cp_async4(&st.ch[0][k], a.ch + 3 * q);
      cp_async4(&st.ch[1][k], a.ch + 3 * q + 1);
      cp_async4(&st.ch[2][k], a.ch + 3 * q + 2);
      cp_async4(&st.mh[0][k], a.mh + 2 * q);
      cp_async4(&st.mh[1][k], a.mh + 2 * q + 1);
      cp_async4(&st.hl[k], a.hl + q);
      cp_async4(&st.pn[0][k], a.pn + 3 * q);
      cp_async4(&st.pn[1][k], a.pn + 3 * q + 1);
      cp_async4(&st.pn[2][k], a.pn + 3 * q + 2);
      cp_async4(&st.pg[k], a.pg + q);
    } else {
      const float* p = halo_row(s, y) + kPacked * x;
      st.ch[0][k] = p[0];
      st.ch[1][k] = p[1];
      st.ch[2][k] = p[2];
      st.mh[0][k] = p[3];
      st.mh[1][k] = p[4];
      st.hl[k] = (int)p[5];
      st.pn[0][k] = p[6];
      st.pn[1][k] = p[7];
      st.pn[2][k] = p[8];
      st.pg[k] = (int)p[9];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int iy = ty + threadIdx.y, ix = tx + threadIdx.x;
  if (iy >= a.h || ix >= a.w) return;
  const TilePrev prev{st, s.row0 + oy, ox};
  store_pixel(a, iy * a.w + ix,
              ptdn::reproject_pixel<false>(a, iy, ix, s.row0 + iy, s.full_h,
                                           prev));
}

// The previous frame's taps from the shard's buffers: the own planes'
// rows and the packed halo rows
struct ShardPrev {
  const ptdn::ReprojShardArgs& s;
  // a tap row: a packed halo row, or (packed null) the own planes' row
  struct Row {
    const float* packed;
    int own;
  };
  struct Rows {
    const ptdn::ReprojArgs& a;
    Row r[3];             // image rows by - 1, by, by + 1
    __device__ __forceinline__ int geom(int dy, int qx) const {
      const Row& t = r[dy + 1];
      return t.packed ? (int)t.packed[kPacked * qx + 9]
                      : a.pg[t.own * a.w + qx];
    }
    __device__ __forceinline__ void normal(int dy, int qx, float n[3]) const {
      const Row& t = r[dy + 1];
      const float* p = t.packed ? t.packed + kPacked * qx + 6
                                : a.pn + 3 * (t.own * a.w + qx);
      n[0] = p[0];
      n[1] = p[1];
      n[2] = p[2];
    }
    __device__ __forceinline__ void values(int dy, int qx,
                                           float out6[6]) const {
      const Row& t = r[dy + 1];
      if (t.packed) {
        const float* p = t.packed + kPacked * qx;
        for (int c = 0; c < 6; ++c) out6[c] = p[c];
      } else {
        const int q = t.own * a.w + qx;
        out6[0] = a.ch[3 * q];
        out6[1] = a.ch[3 * q + 1];
        out6[2] = a.ch[3 * q + 2];
        out6[3] = a.mh[2 * q];
        out6[4] = a.mh[2 * q + 1];
        out6[5] = (float)a.hl[q];
      }
    }
  };
  // picked once a pixel; a row past the halo (outside the image, where
  // no tap reads it) is clamped onto it
  __device__ __forceinline__ Rows rows(int by) const {
    Rows out{s.a, {}};
    for (int d = 0; d < 3; ++d) {
      const int y =
          min(max(by + d - 1 - s.row0, -s.halo), s.a.h + s.halo - 1);
      out.r[d] = (y >= 0 && y < s.a.h) ? Row{nullptr, y}
                                        : Row{halo_row(s, y), 0};
    }
    return out;
  }
  __device__ __forceinline__ int start(int gy) const {
    return s.starts[gy / s.a.band_rows - s.band0];
  }
};

__global__ void __launch_bounds__(kTileW * kTileH)
    back_projection_shard_banded_kernel(ptdn::ReprojShardArgs s) {
  const ptdn::ReprojArgs& a = s.a;
  const int iy = blockIdx.y * kTileH + threadIdx.y;
  const int ix = blockIdx.x * kTileW + threadIdx.x;
  if (iy >= a.h || ix >= a.w) return;
  const ShardPrev prev{s};
  store_pixel(a, iy * a.w + ix,
              ptdn::reproject_pixel<true>(a, iy, ix, s.row0 + iy, s.full_h,
                                          prev));
}

}  // namespace

extern "C" int ptdn_back_projection_banded(const ptdn::ReprojArgs* a,
                                           void* stream) {
  const int n = a->w * a->h;
  if (n > 0)
    back_projection_banded_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                                    (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// A shard's launch (the whole image's in stencil mode), stencil mode
// (banded 0) or band mode: a kTileW x kTileH tile of the shard's pixels
// a block
extern "C" int ptdn_back_projection_shard(const ptdn::ReprojShardArgs* s,
                                          int banded, void* stream) {
  const ptdn::ReprojArgs& a = s->a;
  if (s->bands > ptdn::kMaxShardBands) return (int)cudaErrorInvalidValue;
  if (a.w > 0 && a.h > 0) {
    const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
    const dim3 block(kTileW, kTileH);
    if (banded)
      back_projection_shard_banded_kernel<<<grid, block, 0,
                                            (cudaStream_t)stream>>>(*s);
    else
      back_projection_shard_stencil_kernel<<<grid, block, 0,
                                             (cudaStream_t)stream>>>(*s);
  }
  return (int)cudaGetLastError();
}
