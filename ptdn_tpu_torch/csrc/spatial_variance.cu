// Kernel R: native mode's spatial variance and its short-history
// fallback (SVGF paper, section 4.2).
//
// Replaces XLA code of the JAX package, outside any Pallas kernel:
// ptdn_tpu/denoise/variance.py:spatial_variance (the luminance moments
// over a 7x7 window with the a-trous normal and position edge-stopping
// weights, max(mu2 - mu1^2, 0)) and variance_with_spatial_fallback
// (that estimate where the history is shorter than 4 frames, the
// temporal variance elsewhere). On the TPU it is one fused XLA pass; in
// plain PyTorch it is ~25 operations on each of 49 taps, about 1,200
// launches a frame.
//
// A block of kThreads threads owns a kTileW x kTileH tile of pixels, a
// thread a pixel. It reads the tile's history (and temporal variance)
// and counts the pixels that run the taps (history under 4 frames; every
// pixel without a history). A block with none copies the temporal
// variance and returns without staging: 12 B a pixel. Otherwise the
// other pixels copy it, the needing ones go, in tile order, into a list
// in shared memory, and the block stages the tile with its kRadius-pixel
// ring: per pixel its position with the luminance in w (computed once,
// the same dot3) and its normal, two float4s, read from the G-buffer's
// (H, W, 3) planes (staging from kernel D's packed (H, W, 8) planes,
// two 16-byte loads a pixel, timed the same).
// Then the first `count` threads walk the list, so that whole warps run
// the taps: on native cornell's steady temporal frame the 17% of pixels
// whose history restarts every frame (the background) fill 3,440 warps
// instead of the 4,712 of one thread a pixel, and 1,936 of the 2,500
// blocks stage nothing.
//
// A pixel runs its taps in the JAX order (dy outer, dx inner) over the
// window clipped to the image (taps outside it weigh zero, as the plain
// version's zero padding makes them; a warp whose pixels all have their
// seven columns skips the column tests), with the plain version's
// arithmetic: D's distances (atrous.cuh:sqrt_dist of the fused dot
// product), min(1, exp(-d / (sigma + 1e-6))) with a true division, and
// the sums m1 + w * lq, m2 + (w * lq) * lq and ws + w rounded one
// operation at a time. Where a squared distance is exactly 0 (94.2% of
// native cornell's normal distances: flat walls) the factor is the one a
// zero distance gives, computed once a thread: the same bits without
// the square root, division and exp, whatever sigma is. So the kernel
// equals its plain version (ptdn_tpu_torch/denoise/variance.py) wherever
// expf and torch.exp agree, and the one-thread-a-pixel kernel it
// replaced (each tap read from device memory, every factor computed) on
// every pixel.
//
// What bounds it: by the card's peaks, operations where every pixel runs
// the taps (49 x ~40 float operations a tap), 0.0187 ms at 800x800;
// bytes where none does (12 B a pixel), 0.0023 ms. In practice the
// instructions of the position's factor, which 98% of taps compute: a
// square root, an IEEE division (the quotient's correction and the
// range check, with the reciprocal of the constant divisor taken again
// each time) and an exp, ~60 instructions a tap. On an H100 80GB HBM3
// at 700 W, native cornell 800x800: 0.093 ms with every pixel running
// the taps (5x the bound; 0.186 for the kernel it replaced), 0.028 ms
// on the steady temporal frame (0.077; its bound 0.0036 ms, bytes: 12 B
// a pixel and 36 B a pixel that a tap reads), 0.0042 ms where no pixel
// does (0.0039). Tiles of 16x16 ran 3-7% faster than 32x8 and 32x16, 64x8
// slower; fewer registers (6 or 8 blocks an SM) slower where the taps
// run (PERF.md).
#include "atrous.cuh"

namespace ptdn {

struct SpatialVarianceArgs {
  const float* color;   // (H, W, 3) the color whose moments are estimated
  const float* pos;     // (H, W, 3) G-buffer position
  const float* nrm;     // (H, W, 3) G-buffer normal
  const int* hist;      // (H, W) history length, or null: every pixel
  const float* var;     // (H, W) temporal variance (with hist)
  float* out;           // (H, W)
  int w, h;
  float sigma_n, sigma_x;
};

constexpr int kHistThreshold = 4;
constexpr int kRadius = 3;

__device__ __forceinline__ float luminance3(const float* c) {
  return dot3(0.2126f, 0.7152f, 0.0722f, c[0], c[1], c[2]);
}

// min(1, exp(-|d| / den)) of a squared distance x as the plain version
// rounds it (-sqrt(x) divided by sigma + 1e-6)
__device__ __forceinline__ float edge_factor(float x, float den) {
  return jmin(expf(-sqrt_dist(x) / den), 1.f);
}

// the factor of the squared distance of a - b (3-vectors), `at0` that
// of a zero distance: a squared distance of exactly 0 (+0: a fused sum
// of squares) gives at0's bits, whatever den is
__device__ __forceinline__ float edge_weight(float4 a, float4 b, float den,
                                             float at0) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  const float x = dot3(dx, dy, dz, dx, dy, dz);
  if (x == 0.f) return at0;
  return edge_factor(x, den);
}

}  // namespace ptdn

namespace {

constexpr int kTileW = 16;     // a warp is two rows of the tile
constexpr int kTileH = 16;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kSide = kTileW + 2 * ptdn::kRadius;   // staged pixels a row
constexpr int kStaged = kSide * (kTileH + 2 * ptdn::kRadius);

// A pixel's window: its index c in the staged tile, the rows dy0..dy1
// and columns dx0..dx1 inside the image, its position and normal, the
// sigmas' divisors and the factors of a zero distance
struct Window {
  int c, dy0, dy1, dx0, dx1;
  float4 p0, n0;
  float den_n, den_x, at0_n, at0_x;
};

// The pixel's sums over its window in the JAX order: with kClip the
// columns dx0..dx1, without it all seven (a pixel kRadius or more from
// the left and right edges)
template <bool kClip>
__device__ __forceinline__ void window_sums(const float4* s_pl,
                                            const float4* s_n,
                                            const Window& v, float& m1,
                                            float& m2, float& ws) {
  for (int dy = v.dy0; dy <= v.dy1; ++dy) {
    const float4* rp = s_pl + v.c + dy * kSide;
    const float4* rn = s_n + v.c + dy * kSide;
#pragma unroll
    for (int dx = -ptdn::kRadius; dx <= ptdn::kRadius; ++dx) {
      if (kClip && (dx < v.dx0 || dx > v.dx1)) continue;
      const float4 pq = rp[dx];
      const float wn = ptdn::edge_weight(v.n0, rn[dx], v.den_n, v.at0_n);
      const float wx = ptdn::edge_weight(v.p0, pq, v.den_x, v.at0_x);
      const float w = wn * wx;
      m1 = m1 + w * pq.w;
      m2 = m2 + w * pq.w * pq.w;
      ws = ws + w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    spatial_variance_kernel(ptdn::SpatialVarianceArgs a) {
  __shared__ float4 s_pl[kStaged];   // position x y z, luminance
  __shared__ float4 s_n[kStaged];    // normal x y z
  __shared__ int s_list[kThreads];   // the tile pixels that run the taps
  __shared__ int s_warp[kWarps];     // their count in each warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = blockIdx.y * kTileH, tx = blockIdx.x * kTileW;
  const int y = ty + tid / kTileW, x = tx + tid % kTileW;
  const bool inside = y < a.h && x < a.w;
  const int i = y * a.w + x;
  bool need = inside;
  float var = 0.f;   // read with the history: one round trip fewer
  if (inside && a.hist != nullptr) {
    need = a.hist[i] < ptdn::kHistThreshold;
    var = a.var[i];
  }
  if (__syncthreads_count(need) == 0) {   // the whole block: no staging
    if (inside) a.out[i] = var;
    return;
  }

  const unsigned ballot = __ballot_sync(0xffffffffu, need);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int count = 0, first = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    first += k < warp ? s_warp[k] : 0;
    count += s_warp[k];
  }
  if (need) {
    s_list[first + __popc(ballot & ((1u << lane) - 1u))] = tid;
  } else if (inside) {   // a history of 4 frames or more
    a.out[i] = var;
  }

  for (int s = tid; s < kStaged; s += kThreads) {
    const int sy = s / kSide, sx = s - sy * kSide;
    const int qy = ty - ptdn::kRadius + sy, qx = tx - ptdn::kRadius + sx;
    if (qy < 0 || qy >= a.h || qx < 0 || qx >= a.w) continue;
    const int q = qy * a.w + qx;
    const float* pp = a.pos + 3 * q;
    const float* nn = a.nrm + 3 * q;
    s_pl[s] = make_float4(pp[0], pp[1], pp[2],
                          ptdn::luminance3(a.color + 3 * q));
    s_n[s] = make_float4(nn[0], nn[1], nn[2], 0.f);
  }
  __syncthreads();
  if (tid >= count) return;

  const int t = s_list[tid];
  const int ly = t / kTileW, lx = t - ly * kTileW;
  const int py = ty + ly, px = tx + lx;
  Window v;
  v.c = (ly + ptdn::kRadius) * kSide + lx + ptdn::kRadius;
  v.den_n = a.sigma_n + 1e-6f;
  v.den_x = a.sigma_x + 1e-6f;
  v.at0_n = ptdn::edge_factor(0.f, v.den_n);
  v.at0_x = ptdn::edge_factor(0.f, v.den_x);
  v.p0 = s_pl[v.c];
  v.n0 = s_n[v.c];
  // the window clipped to the image
  v.dy0 = max(-ptdn::kRadius, -py);
  v.dy1 = min(ptdn::kRadius, a.h - 1 - py);
  v.dx0 = max(-ptdn::kRadius, -px);
  v.dx1 = min(ptdn::kRadius, a.w - 1 - px);
  // a warp whose pixels all have their seven columns takes the taps
  // without the column tests; the list's first `count` threads run
  const int left = count - (tid & ~31);
  const unsigned lanes = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  float m1 = 0.f, m2 = 0.f, ws = 0.f;
  if (__all_sync(lanes, v.dx0 == -ptdn::kRadius && v.dx1 == ptdn::kRadius))
    window_sums<false>(s_pl, s_n, v, m1, m2, ws);
  else
    window_sums<true>(s_pl, s_n, v, m1, m2, ws);
  const float inv = 1.0f / ptdn::jmax(ws, 1e-20f);
  const float mu1 = m1 * inv;
  const float mu2 = m2 * inv;
  a.out[py * a.w + px] = ptdn::jmax(mu2 - mu1 * mu1, 0.f);
}

}  // namespace

extern "C" int ptdn_spatial_variance(const ptdn::SpatialVarianceArgs* a,
                                     void* stream) {
  if (a->w > 0 && a->h > 0) {
    const dim3 grid((a->w + kTileW - 1) / kTileW,
                    (a->h + kTileH - 1) / kTileH);
    spatial_variance_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
