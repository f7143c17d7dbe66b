// Kernel P (mesh_intersect_v1): the rough closest triangle hit of each
// ray in plane form, over 128-triangle chunks, with a chunk cull by the
// warp.
//
// Replaces the TPU kernel benchmarks/pallas_intersect_v1.py:
// mesh_intersect_pallas (_mesh_kernel), the superseded first mesh
// closest hit; kernel A replaced it on the renderer's path. Its script
// is ptdn_tpu_torch/probes/intersect_v1.py.
//
// Per chunk, a (3, 4, 128) plane table holds for each triangle the
// columns (n, -n.v0), (g1, c1) and (g2, c2) (ops/cuda/intersect_v1.py:
// plane_table). With o4 = (o, 1) and d4 = (d, 0), six 4-term dots give
// a_n, b_n, a_u, b_u, a_v, b_v; then t = -a_n / b_n, u = a_u + t b_u,
// v = a_v + t b_v, and a lane is a hit where -b_n >= FLT_EPSILON, u, v
// lie in the triangle, t > 0 and the lane is a real triangle. The first
// lane at the chunk's minimum wins it, and the chunk replaces the ray's
// best only where strictly closer. Each dot sums its products left to
// right in float32 FMAs (fmaf(o3, m3, fmaf(o2, m2, fmaf(o1, m1,
// o0 * m0)))); the TPU kernel took them as two MXU matmuls per chunk,
// which are not used here (no tensor cores, no TF32).
//
// What bounds it: operations. The whole test is about 60 float32
// operations a lane-triangle pair (the six dots' 24 products and sums,
// a division, two FMAs, the compares); bunny's 640,000 camera rays make
// 278 M such pairs under the TPU's 512-ray block cull. The design cuts
// the work:
//
// * The cull is a warp's, not the block's (a deviation from the TPU
//   design, whose 512-ray block tested a chunk when any of its rays
//   crossed the chunk's box): a warp tests a chunk only where one of its
//   own 32 rays crosses the box before its running best (__any_sync),
//   and rays past the last, the TPU's padding, do not vote. On bunny's
//   camera rays that leaves 53.5 M pairs. A block of 128 threads stages
//   a chunk's 6 KB of planes in shared memory, transposed to a
//   triangle's 12 floats together (the reads broadcast), when any of its
//   warps wants it; 5,000 blocks fill the 132 SMs. The vote's barrier
//   also guards the staged chunk: a thread reaches it only after its
//   warp's tests of the last one.
// * The cheap rejects come first, each only where it cannot change a
//   bit of the result: b_n alone drops a pair facing away (about half
//   on a closed mesh); then a_n and t = -a_n / b_n (IEEE division) drop
//   a pair with t <= 0 or t not below lim, the smaller of the chunk's
//   running minimum and the ray's best (a pair at or beyond the ray's
//   best never wins the chunk's strict update, and one at or beyond the
//   chunk's minimum never replaces the first lane at it); only the rest
//   compute the four u and v dots. A lane tests kGroup triangles at
//   once, each check on all of them, so that their loads and divisions
//   overlap. The w = 0 term of each direction dot stays an fmaf(0, m.w,
//   ...): a degenerate or padding triangle has non-finite planes, and
//   the NaN of 0 * inf is what rejects it.
// * Each lane walks only the chunk's real triangles.
//
// Tried on an H100 and not kept (PERF.md): the transposed scan of
// chunk_scan.cuh (a thread per triangle over the block's rays that want
// the chunk, each culled on its own: faster on random rays, slower on
// camera rays, whose lanes then diverge at the facing test); two to eight
// threads per ray, each a share of the chunk's triangles (slower: the
// facing test diverges the same way); groups of 1, 2 or 8 triangles;
// blocks of 64 or 256; a division-free prefilter of the whole test with
// a margin, the division only for the pairs left.
//
// The answer equals the plain version's at the same cull group (the
// warp's; mesh_intersect_v1_plain's group): the sequential strict-< walk
// from lim ends on the first lane at the chunk's minimum where it beats
// the ray's best. That it also equals the TPU kernel's (its 512-ray
// block cull), and the answer without the cull, is checked, not
// guaranteed: the cull skips only chunks whose box a ray misses before
// its best, but the boxes are not padded and the slab test rounds apart
// from the plane test, so a ray that grazes a box face can be culled at
// one group size and hit a triangle there at another. The checks: the
// diamond and random meshes in the tests, and the probe's three sets of
// 640,000 rays on the card (chip_smoke.py).
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;   // rays (threads) per block: 4 warps
constexpr int kGroup = 4;     // triangles a lane tests at once
constexpr int kChunk = 128;
constexpr float kFltMax = 3.402823466e38f;
constexpr float kFltEpsilon = 1.1920929e-07f;

__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : (a > b ? a : b);
}

// (x, y, z, w) . m, the products summed left to right
__device__ __forceinline__ float dot4(float x, float y, float z, float w,
                                      const float4 m) {
  return fmaf(w, m.w, fmaf(z, m.z, fmaf(y, m.y, x * m.x)));
}

__global__ void __launch_bounds__(kBlock)
    mesh_intersect_v1_kernel(const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ planes,
                             const float* __restrict__ cmin,
                             const float* __restrict__ cmax, int n,
                             int n_chunks, int n_tris, int cull,
                             float* __restrict__ t_out,
                             int* __restrict__ i_out) {
  // per triangle j: n (4), g1 (4), g2 (4)
  __shared__ float4 tri[kChunk * 3];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool real = i < n;
  const float ox = real ? o[3 * i] : 0.f, oy = real ? o[3 * i + 1] : 0.f,
              oz = real ? o[3 * i + 2] : 0.f;
  const float dx = real ? d[3 * i] : 1.f, dy = real ? d[3 * i + 1] : 1.f,
              dz = real ? d[3 * i + 2] : 1.f;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float best_t = kFltMax;
  int best_i = -1;
  for (int c = 0; c < n_chunks; ++c) {
    bool want = true;
    if (cull) {
      const float* lo = cmin + 3 * c;
      const float* hi = cmax + 3 * c;
      const float t0x = (lo[0] - ox) * ix, t1x = (hi[0] - ox) * ix;
      const float t0y = (lo[1] - oy) * iy, t1y = (hi[1] - oy) * iy;
      const float t0z = (lo[2] - oz) * iz, t1z = (hi[2] - oz) * iz;
      const float tmin =
          jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmin(t0z, t1z));
      const float tmax =
          jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmax(t0z, t1z));
      want = real && (tmax >= 0.f) && (tmin <= tmax) && (tmin < best_t);
    }
    const bool warp_wants = __any_sync(0xffffffffu, want);
    // uniform over the block; every warp's tests of the last chunk done
    if (!__syncthreads_or(warp_wants)) continue;
    // stage the chunk's (3, 4, 128) planes as 128 x (n, g1, g2), four
    // triangles of one plane row a thread at a time
    const float4* src =
        reinterpret_cast<const float4*>(planes + (size_t)c * 3 * 4 * kChunk);
    float* dst = reinterpret_cast<float*>(tri);
    for (int e = threadIdx.x; e < 3 * kChunk; e += kBlock) {
      const int pq = e / (kChunk / 4), j = 4 * (e % (kChunk / 4));
      const int p = pq / 4, q = pq % 4;
      const float4 v = __ldg(src + e);
      dst[((j + 0) * 3 + p) * 4 + q] = v.x;
      dst[((j + 1) * 3 + p) * 4 + q] = v.y;
      dst[((j + 2) * 3 + p) * 4 + q] = v.z;
      dst[((j + 3) * 3 + p) * 4 + q] = v.w;
    }
    __syncthreads();
    if (!warp_wants) continue;   // uniform over the warp
    const int lanes = min(kChunk, n_tris - c * kChunk);
    // the sequential strict-< walk from the ray's best, kGroup triangles
    // at a time: lim is the chunk's running minimum where it beats the
    // best, ci its first lane
    float lim = best_t;
    int ci = -1;
    for (int j0 = 0; j0 < lanes; j0 += kGroup) {
      // a group's tests run against lim at the group's start (a superset
      // of the pairs that can win), each check on all kGroup at once, so
      // that their loads, dots and divisions overlap; the strict-<
      // updates then go in lane order
      float4 mn[kGroup];
      float b_n[kGroup], t[kGroup];
      bool ok[kGroup], any = false;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        mn[k] = tri[3 * (j0 + k)];
        b_n[k] = dot4(dx, dy, dz, 0.f, mn[k]);
        ok[k] = (-b_n[k] >= kFltEpsilon) && (j0 + k < lanes);
        any |= ok[k];
      }
      if (!any) continue;
      any = false;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        t[k] = -dot4(ox, oy, oz, 1.f, mn[k]) / b_n[k];
        ok[k] = ok[k] && (t[k] > 0.f) && (t[k] < lim);
        any |= ok[k];
      }
      if (!any) continue;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const float4 mu = tri[3 * (j0 + k) + 1], mv = tri[3 * (j0 + k) + 2];
        const float u = fmaf(t[k], dot4(dx, dy, dz, 0.f, mu),
                             dot4(ox, oy, oz, 1.f, mu));
        const float v = fmaf(t[k], dot4(dx, dy, dz, 0.f, mv),
                             dot4(ox, oy, oz, 1.f, mv));
        ok[k] = ok[k] && (u >= 0.f) && (u <= 1.f) && (v >= 0.f) &&
                (u + v <= 1.f);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (ok[k] && t[k] < lim) {
          lim = t[k];
          ci = j0 + k;
        }
      }
    }
    if (ci >= 0) {
      best_t = lim;
      best_i = c * kChunk + ci;
    }
  }
  if (real) {
    t_out[i] = best_i >= 0 ? best_t : -1.f;
    i_out[i] = best_i;
  }
}

}  // namespace

extern "C" int ptdn_mesh_intersect_v1(const float* o, const float* d,
                                      const float* planes, const float* cmin,
                                      const float* cmax, int n, int n_chunks,
                                      int n_tris, int cull, float* t_out,
                                      int* i_out, void* stream) {
  if (n > 0) {
    mesh_intersect_v1_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                               (cudaStream_t)stream>>>(
        o, d, planes, cmin, cmax, n, n_chunks, n_tris, cull, t_out, i_out);
  }
  return (int)cudaGetLastError();
}
