// Kernels A (scene_intersect_full), J (scene_intersect_full_tex) and M
// (scene_intersect), templated on the row policy of their analytic
// tests: built once into the kernel library with MatRows
// (scene_intersect.cu), and once per scene with the scene's matrices as
// constants (scene/scene_intersect.cu, SceneMats). The design is in
// scene_intersect.cu's note.
#pragma once

#include "chunk_scan.cuh"

namespace ptdn {

struct RayArgs {
  const float* o;  // ray k's component c at o[k * o_rs + c * o_cs]
  const float* d;
  int o_rs, o_cs, d_rs, d_cs;
  int n;
};

struct IsectArgs {
  float* t;    // (N,)
  float* nrm;  // (N, 3)
  float* uv;   // (N, 2)
  int* geom;   // (N,)
  int* mat;    // (N,)
  int* tidx;   // (N,) texel index, written by J only
};

struct BestArgs {
  float* t_a;    // (N,) closest analytic t, -1 where none
  int* geom_a;   // (N,) its geom, -1 where none
  float* nrm_a;  // (N, 3) its normal, 0 where none
  float* t_m;    // (N,) closest triangle's t where it beats t_a, else -1
  int* tri_m;    // (N,) that triangle's index, else -1
};

// The closest hit of the block's lanes, one ray each: the analytic
// geoms, one closest-hit chunk scan of the block over every chunk (each
// ray behind its own AABB cull), the refine and merge of resolve_hit,
// and with Tex the texel index. Every thread of the block runs it.
template <bool Tex, class Rows>
__device__ __forceinline__ void closest_hit_block(const SceneDev& s,
                                                  const RayArgs& r,
                                                  const IsectArgs& a,
                                                  ScanSmem<true, false>& sm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < r.n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  Analytic an{kFltMax, -1, 0.f, 0.f, 0.f};
  ScanQuery q = no_query();
  if (lane) {
    const float* o = r.o + (size_t)i * r.o_rs;
    const float* d = r.d + (size_t)i * r.d_rs;
    ox = o[0];
    oy = o[r.o_cs];
    oz = o[2 * r.o_cs];
    dx = d[0];
    dy = d[r.d_cs];
    dz = d[2 * r.d_cs];
    an = analytic_best<Rows>(s, ox, oy, oz, dx, dy, dz, true);
    q = ScanQuery{scan_ray(ox, oy, oz, dx, dy, dz),
                  an.geom >= 0 ? an.t : kFltMax, -1, 0, s.n_chunks - 1,
                  s.n_tris > 0};
  }
  chunk_scan(s, sm, q);
  if (!lane) return;
  const Hit h = resolve_hit<Rows>(s, an, q.best, ox, oy, oz, dx, dy, dz);
  a.t[i] = h.t;
  a.nrm[3 * i] = h.nx;
  a.nrm[3 * i + 1] = h.ny;
  a.nrm[3 * i + 2] = h.nz;
  a.uv[2 * i] = h.u;
  a.uv[2 * i + 1] = h.v;
  a.geom[i] = h.geom;
  a.mat[i] = h.mat;
  if (Tex) a.tidx[i] = tex_index(s, h.mat, h.u, h.v);
}

template <class Rows>
__global__ void __launch_bounds__(kScanBlock, kScanBlocksPerSM)
    scene_intersect_full_kernel(SceneDev s, RayArgs r, IsectArgs a) {
  __shared__ ScanSmem<true, false> sm;
  closest_hit_block<false, Rows>(s, r, a, sm);
}

template <class Rows>
__global__ void __launch_bounds__(kScanBlock, kScanBlocksPerSM)
    scene_intersect_full_tex_kernel(SceneDev s, RayArgs r, IsectArgs a) {
  __shared__ ScanSmem<true, false> sm;
  closest_hit_block<true, Rows>(s, r, a, sm);
}

// Kernel M: per ray the closest analytic hit (analytic_best) and the
// closest triangle that beats it, unmerged: the closest-hit scan seeded
// with the analytic t, its key's t and index taken as they are (no
// refine, no merge). Without Cull every ray scans every chunk.
template <bool Cull, class Rows>
__global__ void __launch_bounds__(kScanBlock, kScanBlocksPerSM)
    scene_intersect_kernel(SceneDev s, RayArgs r, BestArgs a) {
  __shared__ ScanSmem<true, false> sm;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < r.n;
  Analytic an{kFltMax, -1, 0.f, 0.f, 0.f};
  ScanQuery q = no_query();
  if (lane) {
    const float* o = r.o + (size_t)i * r.o_rs;
    const float* d = r.d + (size_t)i * r.d_rs;
    const float ox = o[0], oy = o[r.o_cs], oz = o[2 * r.o_cs];
    const float dx = d[0], dy = d[r.d_cs], dz = d[2 * r.d_cs];
    an = analytic_best<Rows>(s, ox, oy, oz, dx, dy, dz, true);
    q = ScanQuery{scan_ray(ox, oy, oz, dx, dy, dz),
                  an.geom >= 0 ? an.t : kFltMax, -1, 0, s.n_chunks - 1,
                  s.n_tris > 0};
  }
  chunk_scan<Cull>(s, sm, q);
  if (!lane) return;
  a.t_a[i] = an.geom >= 0 ? an.t : -1.f;
  a.geom_a[i] = an.geom;
  a.nrm_a[3 * i] = an.nx;
  a.nrm_a[3 * i + 1] = an.ny;
  a.nrm_a[3 * i + 2] = an.nz;
  a.t_m[i] = q.best >= 0 ? q.lim : -1.f;
  a.tri_m[i] = q.best;
}

// The launches, on `stream`: one thread per ray, kScanBlock rays a block
template <class Rows>
int launch_scene_intersect(const SceneDev* s, const RayArgs* r,
                           const BestArgs* a, int cull, void* stream) {
  const int blocks = (r->n + kScanBlock - 1) / kScanBlock;
  if (r->n > 0) {
    if (cull)
      scene_intersect_kernel<true, Rows>
          <<<blocks, kScanBlock, 0, (cudaStream_t)stream>>>(*s, *r, *a);
    else
      scene_intersect_kernel<false, Rows>
          <<<blocks, kScanBlock, 0, (cudaStream_t)stream>>>(*s, *r, *a);
  }
  return (int)cudaGetLastError();
}

template <bool Tex, class Rows>
int launch_closest_hit(const SceneDev* s, const RayArgs* r,
                       const IsectArgs* a, void* stream) {
  const int blocks = (r->n + kScanBlock - 1) / kScanBlock;
  if (r->n > 0) {
    if constexpr (Tex)
      scene_intersect_full_tex_kernel<Rows>
          <<<blocks, kScanBlock, 0, (cudaStream_t)stream>>>(*s, *r, *a);
    else
      scene_intersect_full_kernel<Rows>
          <<<blocks, kScanBlock, 0, (cudaStream_t)stream>>>(*s, *r, *a);
  }
  return (int)cudaGetLastError();
}

}  // namespace ptdn
