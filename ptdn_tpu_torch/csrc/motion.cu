// The moved frame's glue: kernels S1 (camera rays), S2 (the primary
// hit's finish) and T (the motion bounds). A frame whose camera moved
// runs S1, kernel A on its rays, S2, and in the denoiser T, read on the
// host once; a restored state (the rays not frame state) runs S1 and
// S2's position alone. Their plain versions are the PyTorch code they
// replace on the card, which stays the CPU path and the oracle:
//
// - S1 (ops/camera.py:generate_camera_rays_plain, pathtrace.cu:187-208):
//   a thread a pixel of rows row0 .. row0 + h - 1 of a full_h-row image
//   writes the camera position and the direction
//   fmaf(-up, dy, fmaf(-right, dx, view)) over the IEEE square root of
//   fmaf(z, z, fmaf(y, y, x * x)), IEEE-divided, in that order;
// - S2 (ops/cuda/camera.py:primary_finish_plain): a thread a lane writes
//   the G-buffer position fmaf(t, d, o) and, on a moved frame, the
//   primary albedo, the material color or, where show_tex is on and the
//   material is textured, the nearest texel (ptdn.cuh:tex_index_of and
//   texel_channel, the unpacking F and J use), and the hit flag of
//   kernel A's geom id;
// - T (denoise/reproject.py:motion_bounds_plain, motion_parts_plain): a
//   block a row reprojects each pixel with geometry through the previous
//   view matrix (reproject.cuh:prev_coords and base_index, kernel C's own
//   code, so that T and C agree by construction) and reduces the reach,
//   the largest |fy - y| or |fx - x|, and the row's sum of fy - y and
//   count; the last block to finish (a ticket in device memory, zeroed
//   by the entry point) reduces the rows into each band's int64 sum and
//   count and the image's reach, and writes either those parts (a
//   shard's, for the group's Reduce exchanges) or the whole image's
//   bounds: the near flag and each band's slab start. Every reduction is
//   over integers, so the order of the blocks changes no bit.
//
// On the card the plain versions run each fma as ~24 elementwise
// launches of ops/fp.py's float64 emulation over every pixel (~455
// launches a moved room 1920x1080 frame). What bounds the kernels: bytes. S1 writes 24 B a
// pixel, S2 reads 44 B and writes 25 B (and the texels it reads), T
// reads 16 B; at 1920x1080 that is 0.015, 0.043 and 0.010 ms at the
// H100's 3.35 TB/s.
#include "reproject.cuh"

namespace ptdn {

struct CameraArgs {
  const float* pos;    // (3,) camera position
  const float* view;   // (3,)
  const float* up;     // (3,) unnormalized
  const float* right;  // (3,) unnormalized
  const float* pl;     // (2,) pixel length
  float* o;            // (N, 3) ray origins
  float* d;            // (N, 3) ray directions
  int w;
  int h;               // the launch's rows
  int row0;            // their first image row
  float cx;            // w * 0.5 - 0.5
  float cy;            // full_h * 0.5 - 0.5
};

struct FinishArgs {
  const float* t;      // (N,) primary hit distance
  const float* o;      // (N, 3)
  const float* d;      // (N, 3)
  const int* mat;      // (N,) hit material, or null: the position alone
  const float* uv;     // (N, 2) hit uv
  const int* geom;     // (N,) hit geom id, -1 on a miss
  float* position;     // (N, 3)
  float* albedo;       // (N, 3), written where mat is given
  bool* hit;           // (N,) geom >= 0, written where mat is given
  int n;
  int show_tex;
};

struct MotionArgs {
  const float* pos;    // (H, W, 3) G-buffer position
  const int* geom;     // (H, W) geom id, -1 where no geometry
  const float* view;   // (4, 4) previous view matrix, row-major
  long long* rows;     // (H, 3) scratch: each row's sum, count and reach
  unsigned int* done;  // blocks finished, 0 at the launch
  long long* parts;    // (1 + 2 n_bands,) reach, sums, counts; or null
  int* bounds;         // (1 + n_bands,) near flag, slab starts; or null
  int w;
  int h;               // the launch's rows
  int row0;            // their first image row
  int full_h;
  int band_rows;
  int margin;
  int slab_h;          // rows of a band's slab in the padded grid
  int n_bands;         // bands of the full_h-row image
};

}  // namespace ptdn

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
    camera_rays_kernel(ptdn::CameraArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  const int ix = i % a.w, iy = i / a.w;
  const float dx = ((float)ix - a.cx) * a.pl[0];
  const float dy = (((float)iy + (float)a.row0) - a.cy) * a.pl[1];
  float d[3];
  for (int k = 0; k < 3; ++k)
    d[k] = fmaf(-a.up[k], dy, fmaf(-a.right[k], dx, a.view[k]));
  const float s = sqrtf(fmaf(d[2], d[2], fmaf(d[1], d[1], d[0] * d[0])));
  for (int k = 0; k < 3; ++k) {
    a.o[3 * i + k] = a.pos[k];
    a.d[3 * i + k] = d[k] / s;
  }
}

__global__ void __launch_bounds__(kBlock)
    primary_finish_kernel(ptdn::SceneDev s, ptdn::FinishArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float t = a.t[i];
  for (int k = 0; k < 3; ++k)
    a.position[3 * i + k] = fmaf(t, a.d[3 * i + k], a.o[3 * i + k]);
  if (a.mat == nullptr) return;
  const int m = a.mat[i];
  const int ti =
      a.show_tex ? ptdn::tex_index(s, m, a.uv[2 * i], a.uv[2 * i + 1]) : -1;
  const uint32_t texel = ti >= 0 ? s.tex_flat[ti] : 0u;
  for (int c = 0; c < 3; ++c)
    a.albedo[3 * i + c] = ti >= 0 ? ptdn::texel_channel(texel, c)
                                  : s.mat_attr[16 * m + c];
  a.hit[i] = a.geom[i] >= 0;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The block's sum of `sum` and `cnt` and max of `reach`, in thread 0
__device__ void block_reduce(long long& sum, long long& cnt, int& reach) {
  __shared__ long long s_sum[kWarps], s_cnt[kWarps];
  __shared__ int s_reach[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  sum = warp_sum(sum);
  cnt = warp_sum(cnt);
  reach = warp_max(reach);
  if (lane == 0) {
    s_sum[warp] = sum;
    s_cnt[warp] = cnt;
    s_reach[warp] = reach;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      sum += s_sum[k];
      cnt += s_cnt[k];
      reach = max(reach, s_reach[k]);
    }
  }
  __syncthreads();
}

// The last block: the rows' partials into the bands' and the image's
__device__ void motion_finish(const ptdn::MotionArgs& a) {
  long long unused0 = 0, unused1 = 0;
  int reach = 0;
  for (int r = threadIdx.x; r < a.h; r += blockDim.x)
    reach = max(reach, (int)__ldcg(a.rows + 3 * r + 2));
  block_reduce(unused0, unused1, reach);
  if (threadIdx.x == 0) {
    if (a.parts) a.parts[0] = reach;
    if (a.bounds) a.bounds[0] = reach <= 1 ? 1 : 0;
  }
  for (int b = threadIdx.x; b < a.n_bands; b += blockDim.x) {
    // the band's image rows that lie in the launch's rows
    const int lo = max(b * a.band_rows, a.row0) - a.row0;
    const int hi = min((b + 1) * a.band_rows, a.row0 + a.h) - a.row0;
    long long total = 0, cnt = 0;
    for (int r = lo; r < hi; ++r) {
      total += __ldcg(a.rows + 3 * r);
      cnt += __ldcg(a.rows + 3 * r + 1);
    }
    if (a.parts) {
      a.parts[1 + b] = total;
      a.parts[1 + a.n_bands + b] = cnt;
    }
    if (a.bounds) {
      // denoise/reproject.py:starts_from_sums: the mean shift rounded
      // half up in float32, the start clipped to the padded grid
      const float mean = (float)total / (float)max(cnt, 1LL);
      const long long s_b = (long long)floorf(mean + 0.5f);
      const long long start = (long long)b * a.band_rows + s_b - a.margin;
      const long long top = (long long)a.full_h + 2 - a.slab_h;
      a.bounds[1 + b] = (int)(start < 0 ? 0 : start > top ? top : start);
    }
  }
}

__global__ void __launch_bounds__(kBlock) motion_kernel(ptdn::MotionArgs a) {
  const int iy = blockIdx.x;
  const int gy = a.row0 + iy;
  long long sum = 0, cnt = 0;
  int reach = 0;
  for (int ix = threadIdx.x; ix < a.w; ix += blockDim.x) {
    const int i = iy * a.w + ix;
    if (a.geom[i] < 0) continue;
    float prevx, prevy;
    ptdn::prev_coords(a.view, a.pos + 3 * i, a.w, a.full_h, prevx, prevy);
    const int fx = ptdn::base_index(floorf(prevx));
    const int fy = ptdn::base_index(floorf(prevy));
    sum += fy - gy;
    cnt += 1;
    reach = max(reach, max(abs(fy - gy), abs(fx - ix)));
  }
  block_reduce(sum, cnt, reach);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.rows[3 * iy] = sum;
    a.rows[3 * iy + 1] = cnt;
    a.rows[3 * iy + 2] = reach;
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) motion_finish(a);
}

}  // namespace

extern "C" int ptdn_camera_rays(const ptdn::CameraArgs* a, void* stream) {
  const int n = a->w * a->h;
  if (n > 0)
    camera_rays_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                         (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int ptdn_primary_finish(const ptdn::SceneDev* s,
                                   const ptdn::FinishArgs* a, void* stream) {
  if (a->n > 0)
    primary_finish_kernel<<<(a->n + kBlock - 1) / kBlock, kBlock, 0,
                            (cudaStream_t)stream>>>(*s, *a);
  return (int)cudaGetLastError();
}

extern "C" int ptdn_motion_bounds(const ptdn::MotionArgs* a, void* stream) {
  if (a->w <= 0 || a->h <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(a->done, 0, sizeof(unsigned int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  motion_kernel<<<a->h, kBlock, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
