// Kernel Q (ranges_and_key): the sorted wavefront's crossed-chunk ranges
// and coherence sort key, once per bounce between kernels E and F.
//
// Replaces XLA code of the JAX package, not a Pallas kernel:
// ptdn_tpu/engine/wavefront.py:ranges_and_key with the
// chunk_range_planes it calls for the next and the shadow ray. The plain
// version (ops/cuda/ranges.py:ranges_and_key_plain) is that code in
// PyTorch; in the port it cost hundreds of launches a bounce.
//
// One thread per lane. E writes its 21 output planes straight into
// planes 0..20 of the bounce's 26-plane allp (engine/wavefront.py:
// trace_sorted, shade_bounce(out=allp[:21])), and Q reads there only the
// planes it tests (at most 11: next direction, origin, live flag, shadow
// direction, NEE flag) and writes planes 21..25 (nlo, nhi, slo, shi as
// float32, the pixel plane: F's input and the pixel plane the sort
// carries) and the key. The TPU design's concatenation of E's planes
// (the plain version's torch.cat, the JAX code's jnp.concatenate) does
// not carry over: XLA fuses it into the producer there, while here it was
// 176 of the 196 bytes a lane moved. A live lane tests its next ray and,
// when it carries one (O_NEE), its shadow ray against the boxes in
// ascending order (the two share their origin and each box's loads): the
// first crossed box gives lo, the last hi. The boxes
// (ops/cuda/ranges.py:range_boxes, at most 64: the chunk AABBs, or past
// 64 chunks the supergroups' unions) are staged in shared memory once a
// block, with the union of every 8 consecutive boxes
// (ops/cuda/ranges.py:range_group_boxes mirrors it). A ray tests a
// group's boxes only where it does not plainly miss their union; the
// skip is exact: where the union's slab gives no NaN, each member's slab
// interval lies inside the union's on every axis (rounding is monotone),
// so a union missed by tmax < 0, tmin > tmax or tmin > limit is missed by
// every member, and a NaN never skips. A dead lane tests nothing. The
// (lane, ray, group) tests that remain are few on a mesh scene (a ray
// crosses one or two of bunny's five groups) and scattered over a warp's
// lanes, which one loop over the groups would run in lock step: there
// the warp shares them out, a lane a group of one ray a round, and
// merges each crossing into its owner's range with shared-memory atomics
// (the range is the least and greatest crossed box, in any order). On
// room, whose rays cross most of its three groups, a loop over the
// groups per lane measured 7% faster, and shared out no slower than
// choosing per warp (PERF.md §6).
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
// What bounds it: bytes. Every lane reads its live flag and the pixel
// plane and writes 4 range planes, the pixel plane and the key (32 B); a
// live lane also reads the NEE flag, the origin and the next direction
// (28 B), and a lane with a shadow ray that ray's direction (12 B)
// (ops/cuda/ranges.py:traffic). Its box tests are 2 rays x at most 64
// boxes x about 25 float operations, of which the union pre-test skips
// most where a ray crosses few groups (room's do not). Room's 1920x1080
// frame: 2,073,600 lanes, at most 149 MB, 0.045 ms at 3.35 TB/s; its 22
// boxes take at most 2.3 GFLOP, 0.034 ms at 67 TFLOP/s.
#include "ptdn.cuh"

namespace {

// E's output planes (ops/cuda/shade.py: O_*), and allp's past them
constexpr int kDx = 0, kSpx = 3, kAct = 13, kSdx = 14, kNee = 20;
constexpr int kNlo = 21, kPix = 25;
constexpr int kSentinel = 1 << 30;
constexpr int kBlock = 256;      // threads a block
constexpr int kMaxBoxes = 64;    // ops/cuda/ranges.py:MAX_RANGE_SLABS
constexpr int kGroup = 8;        // boxes under one union box
constexpr int kMaxGroups = kMaxBoxes / kGroup;

}  // namespace

namespace ptdn {

struct RangeArgs {
  const float* sh;     // (21, N) E's planes: allp's first 21
  const float* pix;    // (N,) pixel plane
  const float* boxes;  // (n_boxes, 6) lo xyz, hi xyz
  float* allp;         // (26, N): planes 21..25 written
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

// The slab of o + t d (ix, iy, iz = 1 / d) through the box (lo, hi):
// tmin and tmax, NaN where any face gives 0 * inf
struct Slab {
  float tmin, tmax;
};

__device__ __forceinline__ Slab slab(float4 lo, float4 hi, float ox,
                                     float oy, float oz, float ix, float iy,
                                     float iz) {
  const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  return {nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z)),
          nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z))};
}

// Does the ray cross the box at t >= 0 with tmin <= lim?
__device__ __forceinline__ bool crossed(Slab s, float lim) {
  return (s.tmax >= 0.f) && (s.tmin <= s.tmax) && (s.tmin <= lim);
}

// Does the ray plainly miss the box: no NaN and one test failed? A union
// box missed so is missed by every box inside it.
__device__ __forceinline__ bool missed(Slab s, float lim) {
  return (s.tmax < 0.f) || (s.tmin > s.tmax) || (s.tmin > lim);
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

constexpr int kWarps = kBlock / 32;
// a lane's rays in shared memory: origin, 1 / d of the next ray and of
// the shadow ray, the shadow ray's limit
constexpr int kRay = 10;

__global__ void __launch_bounds__(kBlock)
    ranges_and_key_kernel(ptdn::RangeArgs a) {
  __shared__ float4 s_lo[kMaxBoxes], s_hi[kMaxBoxes];
  __shared__ float4 s_ulo[kMaxGroups], s_uhi[kMaxGroups];
  // per warp: its lanes' rays, the (lane, ray, group) work items, each
  // lane's first and last crossed box of each ray
  __shared__ float s_ray[kWarps][32][kRay];
  __shared__ unsigned short s_item[kWarps][32 * 2 * kMaxGroups];
  __shared__ int s_range[kWarps][32][4];
  const int nbx = a.n_boxes, ng = (nbx + kGroup - 1) / kGroup;
  for (int c = threadIdx.x; c < ng * kGroup; c += kBlock) {
    const float nan = __int_as_float(0x7fffffff);
    float4 lo = make_float4(nan, nan, nan, 0.f), hi = lo;
    if (c < nbx) {
      const float* b = a.boxes + 6 * c;
      lo = make_float4(b[0], b[1], b[2], 0.f);
      hi = make_float4(b[3], b[4], b[5], 0.f);
    }
    s_lo[c] = lo;
    s_hi[c] = hi;
  }
  __syncthreads();
  if (threadIdx.x < ng) {
    const float inf = __int_as_float(0x7f800000);
    float4 lo = make_float4(inf, inf, inf, 0.f),
           hi = make_float4(-inf, -inf, -inf, 0.f);
    for (int c = threadIdx.x * kGroup;
         c < min(nbx, (threadIdx.x + 1) * kGroup); ++c) {
      const float4 l = s_lo[c], h = s_hi[c];
      lo.x = fminf(lo.x, fminf(l.x, h.x));
      lo.y = fminf(lo.y, fminf(l.y, h.y));
      lo.z = fminf(lo.z, fminf(l.z, h.z));
      hi.x = fmaxf(hi.x, fmaxf(l.x, h.x));
      hi.y = fmaxf(hi.y, fmaxf(l.y, h.y));
      hi.z = fmaxf(hi.z, fmaxf(l.z, h.z));
    }
    s_ulo[threadIdx.x] = lo;
    s_uhi[threadIdx.x] = hi;
  }
  __syncthreads();

  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = i < a.n;
  const size_t n = (size_t)a.n;
  const float* sh = a.sh;
  const int nc = a.n_chunks;
  const float inf = __int_as_float(0x7f800000);   // no limit
  const bool alive = valid && sh[kAct * n + i] > 0.5f;
  bool nee = false;
  unsigned mn = 0, ms = 0;     // the groups each ray tests
  int* rng = s_range[wp][lane];
  rng[0] = nbx;
  rng[1] = -1;
  rng[2] = nbx;
  rng[3] = -1;
  if (alive) {
    nee = sh[kNee * n + i] > 0.5f;
    float* r = s_ray[wp][lane];
    const float ox = sh[kSpx * n + i], oy = sh[(kSpx + 1) * n + i],
                oz = sh[(kSpx + 2) * n + i];
    const float nix = 1.0f / sh[kDx * n + i],
                niy = 1.0f / sh[(kDx + 1) * n + i],
                niz = 1.0f / sh[(kDx + 2) * n + i];
    float six = 0.f, siy = 0.f, siz = 0.f, s_lim = inf;
    if (nee) {
      six = 1.0f / sh[kSdx * n + i];
      siy = 1.0f / sh[(kSdx + 1) * n + i];
      siz = 1.0f / sh[(kSdx + 2) * n + i];
      if (a.has_limit) {
        const float e0 = __fsub_rn(a.lx, ox), e1 = __fsub_rn(a.ly, oy),
                    e2 = __fsub_rn(a.lz, oz);
        s_lim = __fadd_rn(__fsqrt_rn(__fmaf_rn(
                              e2, e2, __fmaf_rn(e0, e0, __fmul_rn(e1, e1)))),
                          a.lrad);
      }
    }
    const float ray[kRay] = {ox, oy, oz, nix, niy, niz, six, siy, siz, s_lim};
#pragma unroll
    for (int k = 0; k < kRay; ++k) r[k] = ray[k];
    for (int g = 0; g < ng; ++g) {
      const float4 ulo = s_ulo[g], uhi = s_uhi[g];
      if (!missed(slab(ulo, uhi, ox, oy, oz, nix, niy, niz), inf))
        mn |= 1u << g;
      if (nee && !missed(slab(ulo, uhi, ox, oy, oz, six, siy, siz), s_lim))
        ms |= 1u << g;
    }
  }
  // the warp's (lane, ray, group) work items, in lane order; a lane an
  // item (8 boxes of one ray) a round, each crossing merged into its
  // owner's range
  const int cnt = __popc(mn) + __popc(ms);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int pos = incl - cnt;
  for (unsigned m = mn; m; m &= m - 1)
    s_item[wp][pos++] = (unsigned short)((lane << 4) | (__ffs(m) - 1));
  for (unsigned m = ms; m; m &= m - 1)
    s_item[wp][pos++] = (unsigned short)((lane << 4) | 8 | (__ffs(m) - 1));
  __syncwarp();
  for (int it = lane; it < total; it += 32) {
    const int item = s_item[wp][it];
    const int owner = item >> 4, ray = (item >> 3) & 1, g = item & 7;
    const float* r = s_ray[wp][owner];
    const float ox = r[0], oy = r[1], oz = r[2];
    const float ix = r[3 + 3 * ray], iy = r[4 + 3 * ray],
                iz = r[5 + 3 * ray];
    const float lim = ray ? r[9] : inf;
    int first = nbx, last = -1;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int c = g * kGroup + j;
      if (crossed(slab(s_lo[c], s_hi[c], ox, oy, oz, ix, iy, iz), lim)) {
        first = min(first, c);
        last = c;
      }
    }
    if (last >= 0) {
      atomicMin(&s_range[wp][owner][2 * ray], first);
      atomicMax(&s_range[wp][owner][2 * ray + 1], last);
    }
  }
  __syncwarp();
  if (!valid) return;
  a.allp[kPix * n + i] = a.pix[i];
  int nlo = nc, nhi = -1, slo = nc, shi = -1;
  if (alive) {
    const int blo = rng[0], bhi = rng[1], sblo = rng[2], sbhi = rng[3];
    // whole supergroups (group 1: the boxes are the chunks)
    const int g = a.group;
    nlo = min(blo * g, nc);
    nhi = bhi < 0 ? -1 : min(bhi * g + g - 1, nc - 1);
    if (nee) {
      slo = min(sblo * g, nc);
      shi = sbhi < 0 ? -1 : min(sbhi * g + g - 1, nc - 1);
    }
  }
  a.allp[kNlo * n + i] = (float)nlo;
  a.allp[(kNlo + 1) * n + i] = (float)nhi;
  a.allp[(kNlo + 2) * n + i] = (float)slo;
  a.allp[(kNlo + 3) * n + i] = (float)shi;
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
  if (a->n_boxes > kMaxBoxes) return (int)cudaErrorInvalidValue;
  if (a->n > 0)
    ranges_and_key_kernel<<<(a->n + kBlock - 1) / kBlock, kBlock, 0,
                            (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
