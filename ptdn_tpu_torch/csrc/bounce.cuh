// Kernels F (trace_bounce) and H (bounce_fused), templated on the row
// policy of their analytic tests: built once into the kernel library
// with MatRows (bounce.cu), and once per scene with the scene's matrices
// as constants (scene/bounce.cu, SceneMats).
//
// F is the trace half of the sorted wavefront's bounce: NEE visibility,
// the lit radiance add, the next closest hit and the next bounce's
// albedo. It replaces the TPU kernel ptdn_tpu/ops/pallas/bounce.py:
// trace_bounce_pallas (_trace_kernel with its range planes, the joint
// next + shadow chunk scan scene_intersect.py:joint_mesh_tiles, and
// closest_hit_tiles with `alive` and `chunk_range`), and on textured
// scenes the albedo fetch that follows it every bounce but the last
// (engine/wavefront.py:fetch_alb: albedo_from_tilepack, its texel gather
// packed_texel_gather and the TPU kernel ptdn_tpu/ops/pallas/path.py:
// uncompact_tiles_pallas, which routes the gathered texels back to their
// lanes). Sorted lane i reads, at lane order[i] of the bounce's unsorted
// planes (the stable sort of kernel Q's key; engine/wavefront.py:
// permute_planes), E's 21 output planes plus the crossed-chunk ranges
// [nlo, nhi] of the next ray and [slo, shi] of the shadow ray (kernel
// Q, csrc/ranges.cu) and the pixel plane, so that no copy of the planes
// in sorted order is made; and writes, below the last depth, the next
// bounce's 22 I_* planes and its pixel id at its own index i (kernel E
// reads them there next), on the last depth its radiance to its pixel's
// row:
//   1. on an NEE lane, the shadow ray's visibility: its closest analytic
//      hit is the light and no triangle of the chunks [slo, shi] occludes
//      it;
//   2. rr += lit ? cr * emit : 0, a select and not a product, because
//      cr can be inf or NaN on lanes without a shadow ray;
//   3. when do_next, the closest hit over the chunks [nlo, nhi] (a dead
//      lane takes no mesh hit), act2 = act * (geom >= 0), and the three
//      planes of the next albedo: the hit material's color, or on a live
//      lane of a textured material (show_tex) the nearest texel, read and
//      unpacked here. The hit's uv serves the texel and is not carried.
// A block's 128 lanes are consecutive sorted lanes, so its chunk scan
// and every output bit are those of F on planes gathered into sorted
// order beforehand; the gathered loads take the gather's scattered reads
// (a 32-byte sector a 4-byte value where neighbours did not sort
// together) and save its writes and F's second read.
// Why a lane's own range is exact: the range test (kernel Q) and
// the cull (ptdn.cuh:chunk_crossed) are the same subtract-then-multiply
// slab with no multiply-add to contract, so they agree bit for bit: a
// chunk outside a lane's range is one its ray does not cross, which the
// cull skips anyway.
//
// H replaces the TPU kernel ptdn_tpu/ops/pallas/bounce.py:
// bounce_fused_pallas (_kernel without its pixel plane), the whole bounce
// of the unsorted per-bounce engine in one launch. A lane reads the 22
// I_* planes and writes the 21 B_* planes: E's shading (shade.cuh:
// shade_lane, TEA seeded with (lane + lane0, frame + depth) as lane_seed
// does: the lanes stay in pixel order), then F's steps 1-3 over every
// chunk, except that on the last depth the lane's current t, normal and
// material stay and uv is 0 (bounce.py:148-158), and that it reads no
// albedo: kernel K does that after it, as fetch_alb follows the TPU
// kernel. Left out: the pixel-plane mode (23 planes in), which no engine
// calls bounce_fused_pallas with.
//
// The design (one block of kScanBlock lanes): each lane runs the
// analytic part of both its rays, then the block runs one joint mesh
// scan of both (chunk_scan.cuh: the chunks once per block, each chunk's
// triangles staged in shared memory and tested by a thread each against
// every ray of the block that crosses it), then each lane resolves its
// hit. Both take the full dot products, as the TPU kernels do; the
// per-scene build folds each matrix entry into the code as a constant,
// with the same operations in the same order.
//
// What bounds them: on the mesh scenes, the lane-triangle tests (~52
// float operations each, with a reciprocal; tens to hundreds per lane and
// bounce) and the SIMT issue slots they take; on cornell (one chunk of
// 38 triangles) H's shading and analytic tests. A lane moves 26 planes
// and its 8-byte order in and 23 planes out (F, 204 B; 124 B on the last
// depth, 12 B out) or 22 in and 21 out (H, 172 B). PERF.md has the counts
// and times.
#pragma once

#include "chunk_scan.cuh"
#include "shade.cuh"

namespace ptdn {

struct TraceArgs {
  const float* in;         // (26, N): E's O_* planes, nlo nhi slo shi and
                           // the pixel plane, lanes unsorted
  const long long* order;  // (N,): sorted lane i reads lane order[i]
  float* out;              // do_next: (23, N) the next bounce's I_* planes
                           // and pixel plane; else (N, 3) the radiance by
                           // pixel id
  int n;
  int light_geom;
  int do_vis;
  int do_next;
  int show_tex;
  float emit_r, emit_g, emit_b;
};

struct BounceArgs {
  const float* in;  // (22, N): the I_* planes
  float* out;       // (21, N): the B_* planes
  int n;
  unsigned int fd;  // frame + depth
  unsigned int lane0;
  ShadeParams p;
  int light_geom;
  int do_vis;
  int do_next;
  float emit_r, emit_g, emit_b;
};

// F's range planes after E's output, then the pixel plane; and the B_*
// output planes of H (bounce.py:69-71)
enum { R_NLO = kShadeOut, R_NHI, R_SLO, R_SHI, R_PIX };
enum {
  B_SPX, B_SPY, B_SPZ, B_DX, B_DY, B_DZ, B_T, B_NX, B_NY, B_NZ,
  B_TR, B_TG, B_TB, B_RR, B_RG, B_RB, B_MAT, B_ACT, B_DIF, B_UU, B_VV
};

template <class Rows>
__global__ void __launch_bounds__(kScanBlock, kScanBlocksPerSM)
    trace_kernel(SceneDev s, TraceArgs a) {
  __shared__ ScanSmem<true, true> sm;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < a.n;
  const size_t n = (size_t)a.n;
  // sorted lane i: its planes at lane order[i], its next planes at i
  const float* in = a.in + (lane ? a.order[i] : 0);
  float* nxt = a.out + i;

  // the analytic part of both rays, then one joint mesh scan
  ScanQuery sq = no_query(), nq = no_query();
  Analytic na{kFltMax, -1, 0.f, 0.f, 0.f};
  float spx = 0.f, spy = 0.f, spz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float act = 0.f;
  bool nee = false;
  if (lane) {
    spx = in[O_SPX * n];
    spy = in[O_SPY * n];
    spz = in[O_SPZ * n];
    dx = in[O_DX * n];
    dy = in[O_DY * n];
    dz = in[O_DZ * n];
    act = in[O_ACT * n];
    nee = a.do_vis && in[O_NEE * n] > 0.5f;
    if (nee) {
      const float sdx = in[O_SDX * n], sdy = in[O_SDY * n],
                  sdz = in[O_SDZ * n];
      const Analytic sa =
          analytic_best<Rows>(s, spx, spy, spz, sdx, sdy, sdz, false);
      nee = sa.geom == a.light_geom;
      sq = ScanQuery{scan_ray(spx, spy, spz, sdx, sdy, sdz), sa.t, -1,
                     (int)in[R_SLO * n], (int)in[R_SHI * n], nee};
    }
    if (a.do_next) {
      na = analytic_best<Rows>(s, spx, spy, spz, dx, dy, dz, true);
      nq = ScanQuery{scan_ray(spx, spy, spz, dx, dy, dz),
                     na.geom >= 0 ? na.t : kFltMax, -1, (int)in[R_NLO * n],
                     (int)in[R_NHI * n], s.n_tris > 0 && act > 0.5f};
      nxt[I_OX * n] = spx;
      nxt[I_OY * n] = spy;
      nxt[I_OZ * n] = spz;
      nxt[I_DX * n] = dx;
      nxt[I_DY * n] = dy;
      nxt[I_DZ * n] = dz;
      nxt[I_TR * n] = in[O_TR * n];
      nxt[I_TG * n] = in[O_TG * n];
      nxt[I_TB * n] = in[O_TB * n];
      nxt[I_DIF * n] = in[O_DIF * n];
      nxt[kShadeIn * n] = in[R_PIX * n];
    }
  }
  chunk_scan(s, sm, nq, sq);
  if (!lane) return;

  const bool lit = nee && sq.best < 0;
  const float rr = in[O_RR * n] + (lit ? in[O_CR * n] * a.emit_r : 0.f);
  const float rg = in[O_RG * n] + (lit ? in[O_CG * n] * a.emit_g : 0.f);
  const float rb = in[O_RB * n] + (lit ? in[O_CB * n] * a.emit_b : 0.f);
  if (!a.do_next) {
    // last depth: only the radiance survives, in its pixel's row (the
    // pixel ids are a permutation of the lanes)
    float* row = a.out + 3 * (size_t)(int)in[R_PIX * n];
    row[0] = rr;
    row[1] = rg;
    row[2] = rb;
    return;
  }
  nxt[I_RR * n] = rr;
  nxt[I_RG * n] = rg;
  nxt[I_RB * n] = rb;
  const Hit h =
      resolve_hit<Rows>(s, na, nq.best, spx, spy, spz, dx, dy, dz);
  const float act2 = act * (h.geom >= 0 ? 1.f : 0.f);
  nxt[I_T * n] = h.t;
  nxt[I_NX * n] = h.nx;
  nxt[I_NY * n] = h.ny;
  nxt[I_NZ * n] = h.nz;
  nxt[I_MAT * n] = (float)h.mat;
  nxt[I_ACT * n] = act2;
  const int ti =
      (a.show_tex && act2 > 0.5f) ? tex_index(s, h.mat, h.u, h.v) : -1;
  const uint32_t texel = ti >= 0 ? s.tex_flat[ti] : 0u;
  for (int c = 0; c < 3; ++c)
    nxt[(I_AR + c) * n] = ti >= 0 ? texel_channel(texel, c)
                                  : s.mat_attr[16 * h.mat + c];
}

template <class Rows>
__global__ void __launch_bounds__(kScanBlock, kScanBlocksPerSM)
    bounce_fused_kernel(SceneDev s, BounceArgs a) {
  __shared__ ScanSmem<true, true> sm;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < a.n;
  const size_t n = (size_t)a.n;
  const float* in = a.in + i;
  float* out = a.out + i;

  // E's shading, the analytic part of both rays, then one joint mesh
  // scan over every chunk
  ScanQuery sq = no_query(), nq = no_query();
  Analytic na{kFltMax, -1, 0.f, 0.f, 0.f};
  float o[kShadeOut];
  bool nee = false;
  if (lane) {
    shade_lane(in, n, tea16((uint32_t)i + a.lane0, a.fd), a.p, o);
    nee = a.do_vis && o[O_NEE] > 0.5f;
    if (nee) {
      const Analytic sa =
          analytic_best<Rows>(s, o[O_SPX], o[O_SPY], o[O_SPZ], o[O_SDX],
                                 o[O_SDY], o[O_SDZ], false);
      nee = sa.geom == a.light_geom;
      sq = ScanQuery{scan_ray(o[O_SPX], o[O_SPY], o[O_SPZ], o[O_SDX],
                              o[O_SDY], o[O_SDZ]),
                     sa.t, -1, 0, s.n_chunks - 1, nee};
    }
    if (a.do_next) {
      na = analytic_best<Rows>(s, o[O_SPX], o[O_SPY], o[O_SPZ], o[O_DX],
                                  o[O_DY], o[O_DZ], true);
      nq = ScanQuery{scan_ray(o[O_SPX], o[O_SPY], o[O_SPZ], o[O_DX],
                              o[O_DY], o[O_DZ]),
                     na.geom >= 0 ? na.t : kFltMax, -1, 0, s.n_chunks - 1,
                     s.n_tris > 0 && o[O_ACT] > 0.5f};
    }
    out[B_SPX * n] = o[O_SPX];
    out[B_SPY * n] = o[O_SPY];
    out[B_SPZ * n] = o[O_SPZ];
    out[B_DX * n] = o[O_DX];
    out[B_DY * n] = o[O_DY];
    out[B_DZ * n] = o[O_DZ];
    out[B_TR * n] = o[O_TR];
    out[B_TG * n] = o[O_TG];
    out[B_TB * n] = o[O_TB];
    out[B_DIF * n] = o[O_DIF];
  }
  chunk_scan(s, sm, nq, sq);
  if (!lane) return;

  const bool lit = nee && sq.best < 0;
  out[B_RR * n] = o[O_RR] + (lit ? o[O_CR] * a.emit_r : 0.f);
  out[B_RG * n] = o[O_RG] + (lit ? o[O_CG] * a.emit_g : 0.f);
  out[B_RB * n] = o[O_RB] + (lit ? o[O_CB] * a.emit_b : 0.f);
  if (!a.do_next) {
    // last depth: the current intersection stays (only the radiance
    // survives; the rest stays finite)
    out[B_T * n] = in[I_T * n];
    out[B_NX * n] = in[I_NX * n];
    out[B_NY * n] = in[I_NY * n];
    out[B_NZ * n] = in[I_NZ * n];
    out[B_MAT * n] = in[I_MAT * n];
    out[B_ACT * n] = o[O_ACT];
    out[B_UU * n] = 0.f;
    out[B_VV * n] = 0.f;
    return;
  }
  const Hit h = resolve_hit<Rows>(s, na, nq.best, o[O_SPX], o[O_SPY],
                                     o[O_SPZ], o[O_DX], o[O_DY], o[O_DZ]);
  out[B_T * n] = h.t;
  out[B_NX * n] = h.nx;
  out[B_NY * n] = h.ny;
  out[B_NZ * n] = h.nz;
  out[B_MAT * n] = (float)h.mat;
  out[B_ACT * n] = o[O_ACT] * (h.geom >= 0 ? 1.f : 0.f);
  out[B_UU * n] = h.u;
  out[B_VV * n] = h.v;
}

// The launches, on `stream`: one thread per lane, kScanBlock lanes a block
template <class Rows>
int launch_trace_bounce(const SceneDev* s, const TraceArgs* a, void* stream) {
  if (a->n > 0)
    trace_kernel<Rows><<<(a->n + kScanBlock - 1) / kScanBlock, kScanBlock, 0,
                         (cudaStream_t)stream>>>(*s, *a);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_bounce_fused(const SceneDev* s, const BounceArgs* a,
                        void* stream) {
  if (a->n > 0)
    bounce_fused_kernel<Rows>
        <<<(a->n + kScanBlock - 1) / kScanBlock, kScanBlock, 0,
           (cudaStream_t)stream>>>(*s, *a);
  return (int)cudaGetLastError();
}

}  // namespace ptdn
