// Kernel P (mesh_intersect_v1): the rough closest triangle hit of each
// ray in plane form, over 128-triangle chunks, with the chunk cull of a
// 512-ray block.
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
// One CUDA block of 512 threads is one of the TPU kernel's 512-ray
// blocks, a thread one ray: with the cull on, a chunk is skipped unless
// some ray of the block crosses its box before its running best, which
// __syncthreads_or decides exactly as the TPU block's jnp.any. Rays past
// the last are the TPU's padding (o = 0, d = 1) and take part in that
// vote. Each chunk's 6 KB of planes is staged in shared memory, a
// triangle's 12 floats together; every thread reads the same triangle at
// the same time, so the reads broadcast.
//
// What bounds it: operations, about 60 float32 operations per
// lane-triangle test (the six dots' 24 products and sums, a division,
// two FMAs, the compares): bunny's 640,000 camera rays against its 39
// chunks make 3.19 G tests with the cull off, 2.9 ms at 67 TFLOP/s.
#include <cuda_runtime.h>

namespace {

constexpr int kRblk = 512;
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

__global__ void __launch_bounds__(kRblk)
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
  const int i = blockIdx.x * kRblk + threadIdx.x;
  const bool real = i < n;
  const float ox = real ? o[3 * i] : 0.f, oy = real ? o[3 * i + 1] : 0.f,
              oz = real ? o[3 * i + 2] : 0.f;
  const float dx = real ? d[3 * i] : 1.f, dy = real ? d[3 * i + 1] : 1.f,
              dz = real ? d[3 * i + 2] : 1.f;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float best_t = kFltMax;
  int best_i = -1;
  for (int c = 0; c < n_chunks; ++c) {
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
      const bool box = (tmax >= 0.f) && (tmin <= tmax) && (tmin < best_t);
      if (!__syncthreads_or(box)) continue;   // uniform over the block
    }
    __syncthreads();   // the previous chunk's reads are done
    // stage the chunk's (3, 4, 128) planes as 128 x (n, g1, g2)
    const float* src = planes + (size_t)c * 3 * 4 * kChunk;
    float* dst = reinterpret_cast<float*>(tri);
    for (int e = threadIdx.x; e < 3 * 4 * kChunk; e += kRblk) {
      const int p = e / (4 * kChunk), q = (e / kChunk) % 4, j = e % kChunk;
      dst[(j * 3 + p) * 4 + q] = __ldg(src + e);
    }
    __syncthreads();
    const int lanes = min(kChunk, n_tris - c * kChunk);
    // the first lane at the chunk's minimum (lane 0 where none hits)
    float ct = kFltMax;
    int ci = 0;
    for (int j = 0; j < kChunk; ++j) {
      const float4 mn = tri[3 * j], mu = tri[3 * j + 1], mv = tri[3 * j + 2];
      const float a_n = dot4(ox, oy, oz, 1.f, mn);
      const float b_n = dot4(dx, dy, dz, 0.f, mn);
      const float a_u = dot4(ox, oy, oz, 1.f, mu);
      const float b_u = dot4(dx, dy, dz, 0.f, mu);
      const float a_v = dot4(ox, oy, oz, 1.f, mv);
      const float b_v = dot4(dx, dy, dz, 0.f, mv);
      const float t = -a_n / b_n;
      const float u = fmaf(t, b_u, a_u);
      const float v = fmaf(t, b_v, a_v);
      const bool ok = (-b_n >= kFltEpsilon) && (u >= 0.f) && (u <= 1.f) &&
                      (v >= 0.f) && (u + v <= 1.f) && (t > 0.f) && (j < lanes);
      if (ok && t < ct) {
        ct = t;
        ci = j;
      }
    }
    if (ct < best_t) {
      best_t = ct;
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
    mesh_intersect_v1_kernel<<<(n + kRblk - 1) / kRblk, kRblk, 0,
                               (cudaStream_t)stream>>>(
        o, d, planes, cmin, cmax, n, n_chunks, n_tris, cull, t_out, i_out);
  }
  return (int)cudaGetLastError();
}
