// Kernel Q (ranges_and_key): the sorted wavefront's crossed-chunk ranges
// and coherence sort key, once per bounce between kernels E and F.
//
// Replaces XLA code of the JAX package, not a Pallas kernel:
// ptdn_tpu/engine/wavefront.py:ranges_and_key with the
// chunk_range_planes it calls for the next and the shadow ray. The plain
// version (ops/cuda/ranges.py:ranges_and_key_plain) is that code in
// PyTorch; in the port it cost hundreds of launches a bounce.
//
// One thread per lane reads E's 21 planes and the pixel plane and writes
// the whole 26-plane allp (E's planes, nlo, nhi, slo, shi as float32, the
// pixel plane: F's input and the pixel plane the sort carries) and the
// key, so the plain version's torch.cat is folded in. A live lane tests
// its next ray and, when it carries one (O_NEE), its shadow ray against
// every box in ascending order in one loop (the two share their origin
// and each box's loads): the first crossed box gives lo, the last hi.
// The boxes (ops/cuda/ranges.py:range_boxes, at most 64: the chunk
// AABBs, or past 64 chunks the supergroups' unions) are one small table
// that every lane of a warp reads at the same address, a broadcast from
// L1. A dead lane tests nothing.
//
// The bits equal the plain version's on every lane:
// - the slab is (lo - o) * (1 / d), IEEE division and no contraction
//   (the build's --fmad=false), as torch computes it;
// - min and max propagate NaN as torch.minimum / maximum do: a ±0
//   direction component gives 1 / d = ±inf, and a box face through the
//   origin then 0 * inf = NaN, which must fail the crossing. fminf and
//   fmaxf drop NaN; PTX's min.NaN / max.NaN keep it in one instruction
//   each (ptdn.cuh's jmin / jmax keep it too, as compares and selects,
//   and are slower: PERF.md §6);
// - the range test is tmin <= limit (slab_crossed's is tmin < t_lim):
//   the next ray's limit is +inf, the shadow ray's sqrt(dot3(e, e)) +
//   light_radius with e = light_pos - origin, rounded as ops/fp.py
//   rounds it (two correctly rounded FMAs, a correctly rounded sqrt);
// - past 64 chunks lo = min(slo * G, n), hi = shi < 0 ? -1 :
//   min(shi * G + G - 1, n - 1);
// - the key: dead lanes SENTINEL; with do_vis the morton interleave of
//   (nlo, slo) times 16384 plus that of (max(nhi, 0), max(shi, 0)), each
//   id squeezed to 7 bits (x * 127 / n past 127 chunks, then clamped),
//   else nlo * (n + 1) + max(nhi, 0), in wrapping int32 as torch's.
//
// What bounds it: bytes. A lane reads 22 planes (88 B) and writes 26
// planes and a key (108 B); its box tests are 2 rays x at most 64 boxes x
// about 25 float operations. Room's 1920x1080 frame: 2,073,600 lanes,
// 406 MB, 0.12 ms at 3.35 TB/s; its 22 boxes take about 2.3 GFLOP,
// 0.034 ms at 67 TFLOP/s.
#include "ptdn.cuh"

namespace {

// E's output planes (ops/cuda/shade.py: O_*)
constexpr int kOutPlanes = 21;
constexpr int kDx = 0, kSpx = 3, kAct = 13, kSdx = 14, kNee = 20;
constexpr int kSentinel = 1 << 30;
constexpr int kBlock = 128;   // threads a block

}  // namespace

namespace ptdn {

struct RangeArgs {
  const float* sh;     // (21, N) E's planes
  const float* pix;    // (N,) pixel plane
  const float* boxes;  // (n_boxes, 6) lo xyz, hi xyz
  float* allp;         // (26, N)
  int* key;            // (N,)
  int n;               // lanes
  int n_boxes;
  int group;           // chunks a box covers (1: the chunk AABBs)
  int n_chunks;
  int do_vis;          // the morton key
  int has_limit;       // the shadow range's light limit
  float lx, ly, lz;    // light center
  float lrad;          // light AABB half diagonal
};

}  // namespace ptdn

namespace {

// min and max that propagate NaN, as torch.minimum / maximum do
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Does o + t d (ix, iy, iz = 1 / d) cross the box b (lo xyz, hi xyz) at
// t >= 0 with tmin <= lim?
__device__ __forceinline__ bool range_crossed(const float (&b)[6], float ox,
                                              float oy, float oz, float ix,
                                              float iy, float iz, float lim) {
  const float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
  const float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
  const float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
  const float tmin =
      nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
  const float tmax =
      nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z));
  return (tmax >= 0.f) && (tmin <= tmax) && (tmin <= lim);
}

// x squeezed into 7 bits: x * 127 / n past 127 chunks, clamped to [0, 127]
__device__ __forceinline__ unsigned to7(int x, int n_chunks) {
  // x in [0, n]: the integer division is torch's floor division
  if (n_chunks > 127) x = x * 127 / n_chunks;
  return (unsigned)min(max(x, 0), 127);
}

// a's 7 bits at the odd positions, b's at the even ones
__device__ __forceinline__ unsigned interleave7(int a, int b, int n_chunks) {
  const unsigned ua = to7(a, n_chunks), ub = to7(b, n_chunks);
  unsigned m = 0;
#pragma unroll
  for (int bit = 0; bit < 7; ++bit)
    m |= (((ua >> bit) & 1u) << (2 * bit + 1))
         | (((ub >> bit) & 1u) << (2 * bit));
  return m;
}

__global__ void ranges_and_key_kernel(ptdn::RangeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  float v[kOutPlanes];
#pragma unroll
  for (int p = 0; p < kOutPlanes; ++p) {
    v[p] = a.sh[p * n + i];
    a.allp[p * n + i] = v[p];
  }
  a.allp[25 * n + i] = a.pix[i];

  const int nc = a.n_chunks;
  int nlo = nc, nhi = -1, slo = nc, shi = -1;
  const bool alive = v[kAct] > 0.5f;
  if (alive) {
    const bool nee = v[kNee] > 0.5f;
    const float ox = v[kSpx], oy = v[kSpx + 1], oz = v[kSpx + 2];
    const float nix = 1.0f / v[kDx], niy = 1.0f / v[kDx + 1],
                niz = 1.0f / v[kDx + 2];
    const float six = 1.0f / v[kSdx], siy = 1.0f / v[kSdx + 1],
                siz = 1.0f / v[kSdx + 2];
    float s_lim = __int_as_float(0x7f800000);   // +inf: no limit
    if (a.has_limit) {
      const float e0 = __fsub_rn(a.lx, ox), e1 = __fsub_rn(a.ly, oy),
                  e2 = __fsub_rn(a.lz, oz);
      s_lim = __fadd_rn(
          __fsqrt_rn(__fmaf_rn(e2, e2, __fmaf_rn(e0, e0, __fmul_rn(e1, e1)))),
          a.lrad);
    }
    const float n_lim = __int_as_float(0x7f800000);
    int blo = a.n_boxes, bhi = -1, sblo = a.n_boxes, sbhi = -1;
    for (int c = 0; c < a.n_boxes; ++c) {
      float b[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) b[k] = __ldg(a.boxes + 6 * c + k);
      if (range_crossed(b, ox, oy, oz, nix, niy, niz, n_lim)) {
        blo = min(blo, c);
        bhi = c;
      }
      if (nee && range_crossed(b, ox, oy, oz, six, siy, siz, s_lim)) {
        sblo = min(sblo, c);
        sbhi = c;
      }
    }
    // whole supergroups (group 1: the boxes are the chunks)
    const int g = a.group;
    nlo = min(blo * g, nc);
    nhi = bhi < 0 ? -1 : min(bhi * g + g - 1, nc - 1);
    if (nee) {
      slo = min(sblo * g, nc);
      shi = sbhi < 0 ? -1 : min(sbhi * g + g - 1, nc - 1);
    }
  }
  a.allp[21 * n + i] = (float)nlo;
  a.allp[22 * n + i] = (float)nhi;
  a.allp[23 * n + i] = (float)slo;
  a.allp[24 * n + i] = (float)shi;
  unsigned k;
  if (!alive) {
    k = kSentinel;
  } else if (a.do_vis) {
    k = interleave7(nlo, slo, nc) * 16384u
        + interleave7(max(nhi, 0), max(shi, 0), nc);
  } else {
    k = (unsigned)nlo * (unsigned)(nc + 1) + (unsigned)max(nhi, 0);
  }
  a.key[i] = (int)k;
}

}  // namespace

extern "C" int ptdn_ranges_and_key(const ptdn::RangeArgs* a, void* stream) {
  if (a->n > 0)
    ranges_and_key_kernel<<<(a->n + kBlock - 1) / kBlock, kBlock, 0,
                            (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
