// Kernels F (trace_bounce) and H (bounce_fused).
//
// F is the trace half of the sorted wavefront's bounce: NEE visibility,
// the lit radiance add, the next closest hit and the next bounce's albedo.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/bounce.py:
// trace_bounce_pallas (_trace_kernel with its range planes, the joint
// next + shadow chunk scan scene_intersect.py:joint_mesh_tiles, and
// closest_hit_tiles with `alive` and `chunk_range`), and on textured
// scenes the albedo fetch that follows it every bounce but the last
// (engine/wavefront.py:fetch_alb: albedo_from_tilepack, its texel gather
// packed_texel_gather and the TPU kernel ptdn_tpu/ops/pallas/path.py:
// uncompact_tiles_pallas, which routes the gathered texels back to their
// lanes). One thread per lane reads E's 21 output planes plus the
// crossed-chunk ranges [nlo, nhi] of the next ray and [slo, shi] of the
// shadow ray (engine/wavefront.py:ranges_and_key), and writes the 21
// planes of the B_* layout:
//   1. on an NEE lane, light_visible over the chunks [slo, shi];
//   2. rr += lit ? cr * emit : 0, a select and not a product, because
//      cr can be inf or NaN on lanes without a shadow ray;
//   3. when do_next, the closest hit over the chunks [nlo, nhi] (a dead
//      lane takes no mesh hit), act2 = act * (geom >= 0), and the three
//      planes of the next albedo: the hit material's color, or on a live
//      lane of a textured material (show_tex) the nearest texel, read and
//      unpacked here; on the last depth the constant planes.
//
// Why a per-lane range is exact: the TPU kernel scans the union of its
// tile's ranges and culls per lane inside it. The range test
// (ranges_and_key) and the in-kernel cull (ptdn.cuh:chunk_crossed) are the
// same subtract-then-multiply slab with no multiply-add to contract, so
// they agree bit for bit: a chunk outside a lane's own range is one its
// ray does not cross, which the per-lane cull skips anyway. Both queries
// then visit, in ascending order, exactly the chunks a scan of the whole
// scene visits, and ties still go to the lowest triangle index.
//
// What bounds it: per lane it moves 25 planes in and 24 out (196 B), and
// runs ~10 analytic geom tests per query plus ~50 float operations per
// triangle of every chunk its rays cross before their running best. On
// the mesh scenes the two bounds come out close (bytes slightly ahead on
// diamond; PERF.md has the counts), and the kernel runs well above both:
// its per-lane chunk loops have data-dependent trip counts. Coherence
// sorting puts lanes that cross the same chunks into the same warp, so a
// warp's threads walk the same triangles and the cache broadcasts them.
//
// Dropped from the TPU design: the tile-union scan and its needing-row
// loops (per-lane ranges on a GPU thread instead), and the tile-wide
// compaction of the texel indices with its gather ladder and uncompact
// kernel (compact.py:tile_route, tile_gather_compact,
// wavefront.py:packed_texel_gather, path.py:uncompact_tiles_pallas): a
// GPU thread reads its own texel at no such cost. The two queries run one
// after the other instead of in one joint loop; the results are the same
// function.
//
// H replaces the TPU kernel ptdn_tpu/ops/pallas/bounce.py:
// bounce_fused_pallas (_kernel without its pixel plane), the whole bounce
// of the unsorted per-bounce engine in one launch. One thread per lane
// reads the 22 I_* planes and writes the 21 B_* planes:
//   1. E's shading (shade.cuh:shade_lane), TEA seeded with (lane + lane0,
//      frame + depth) as lane_seed does: the lanes stay in pixel order;
//   2. on an NEE lane, light_visible over every chunk, and rr += lit ?
//      cr * emit : 0, the same select as F's;
//   3. when do_next, the next closest hit of the scattered ray over every
//      chunk (a dead lane takes no mesh hit) and act2 = act * (geom >= 0);
//      on the last depth the lane's current t, normal and material stay
//      and uv is 0 (bounce.py:148-158; F writes constants there instead).
// H takes the full dot products, as the TPU kernel does (it bakes no
// scene matrix). It does not read the next albedo: kernel K does that
// after it, as fetch_alb follows the TPU kernel. Left out: the pixel-plane
// mode (23 planes in), which no engine calls bounce_fused_pallas with.
//
// What bounds H: arithmetic and divergence. A lane moves 22 planes in and
// 21 out (172 B); it runs E's ~250 float operations, ~10 analytic geom
// tests per query and ~50 float operations per triangle of each chunk
// its two rays cross before their running best. Unlike F's lanes, a
// warp's lanes are neighbouring pixels, coherent on the first bounces and
// scattered after, and each scans every chunk its rays cross.
#include "shade.cuh"

namespace ptdn {

struct TraceArgs {
  const float* in;  // (25, N): the O_* planes of E, then nlo nhi slo shi
  float* out;       // (21, N): the B_* planes
  float* alb;       // (3, N): the next albedo, written when do_next
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

}  // namespace ptdn

namespace {

using namespace ptdn;

// F's range planes after E's output, and the B_* output planes
// (bounce.py:69-71)
enum { R_NLO = kShadeOut, R_NHI, R_SLO, R_SHI };
enum {
  B_SPX, B_SPY, B_SPZ, B_DX, B_DY, B_DZ, B_T, B_NX, B_NY, B_NZ,
  B_TR, B_TG, B_TB, B_RR, B_RG, B_RB, B_MAT, B_ACT, B_DIF, B_UU, B_VV
};

__global__ void trace_kernel(SceneDev s, TraceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  const float* in = a.in + i;
  float* out = a.out + i;
  const float spx = in[O_SPX * n], spy = in[O_SPY * n], spz = in[O_SPZ * n];
  const float dx = in[O_DX * n], dy = in[O_DY * n], dz = in[O_DZ * n];
  const float act = in[O_ACT * n];

  bool lit = false;
  if (a.do_vis && in[O_NEE * n] > 0.5f) {
    const ptdn::ChunkRange sr{(int)in[R_SLO * n], (int)in[R_SHI * n]};
    lit = ptdn::light_visible<ptdn::MatRows>(
        s, a.light_geom, spx, spy, spz, in[O_SDX * n], in[O_SDY * n],
        in[O_SDZ * n], sr);
  }
  out[B_RR * n] = in[O_RR * n] + (lit ? in[O_CR * n] * a.emit_r : 0.f);
  out[B_RG * n] = in[O_RG * n] + (lit ? in[O_CG * n] * a.emit_g : 0.f);
  out[B_RB * n] = in[O_RB * n] + (lit ? in[O_CB * n] * a.emit_b : 0.f);
  out[B_SPX * n] = spx;
  out[B_SPY * n] = spy;
  out[B_SPZ * n] = spz;
  out[B_DX * n] = dx;
  out[B_DY * n] = dy;
  out[B_DZ * n] = dz;
  out[B_TR * n] = in[O_TR * n];
  out[B_TG * n] = in[O_TG * n];
  out[B_TB * n] = in[O_TB * n];
  out[B_DIF * n] = in[O_DIF * n];

  if (!a.do_next) {
    // last depth: only the radiance survives; the rest stays finite
    out[B_T * n] = 1.f;
    out[B_NX * n] = 0.f;
    out[B_NY * n] = 0.f;
    out[B_NZ * n] = 1.f;
    out[B_MAT * n] = 0.f;
    out[B_ACT * n] = act;
    out[B_UU * n] = 0.f;
    out[B_VV * n] = 0.f;
    return;
  }
  const ptdn::ChunkRange nr{(int)in[R_NLO * n], (int)in[R_NHI * n]};
  const ptdn::Hit h = ptdn::closest_hit<ptdn::MatRows>(
      s, spx, spy, spz, dx, dy, dz, act > 0.5f, nr);
  const float act2 = act * (h.geom >= 0 ? 1.f : 0.f);
  out[B_T * n] = h.t;
  out[B_NX * n] = h.nx;
  out[B_NY * n] = h.ny;
  out[B_NZ * n] = h.nz;
  out[B_MAT * n] = (float)h.mat;
  out[B_ACT * n] = act2;
  out[B_UU * n] = h.u;
  out[B_VV * n] = h.v;
  const int ti =
      (a.show_tex && act2 > 0.5f) ? ptdn::tex_index(s, h.mat, h.u, h.v) : -1;
  const uint32_t texel = ti >= 0 ? s.tex_flat[ti] : 0u;
  for (int c = 0; c < 3; ++c)
    a.alb[c * n + i] = ti >= 0 ? ptdn::texel_channel(texel, c)
                               : s.mat_attr[16 * h.mat + c];
}

__global__ void bounce_fused_kernel(SceneDev s, BounceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  const float* in = a.in + i;
  float* out = a.out + i;
  float o[kShadeOut];
  shade_lane(in, n, tea16((uint32_t)i + a.lane0, a.fd), a.p, o);

  bool lit = false;
  if (a.do_vis && o[O_NEE] > 0.5f)
    lit = light_visible<MatRows>(s, a.light_geom, o[O_SPX], o[O_SPY],
                                 o[O_SPZ], o[O_SDX], o[O_SDY], o[O_SDZ],
                                 all_chunks(s));
  out[B_RR * n] = o[O_RR] + (lit ? o[O_CR] * a.emit_r : 0.f);
  out[B_RG * n] = o[O_RG] + (lit ? o[O_CG] * a.emit_g : 0.f);
  out[B_RB * n] = o[O_RB] + (lit ? o[O_CB] * a.emit_b : 0.f);
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
  const Hit h = closest_hit<MatRows>(s, o[O_SPX], o[O_SPY], o[O_SPZ],
                                     o[O_DX], o[O_DY], o[O_DZ],
                                     o[O_ACT] > 0.5f, all_chunks(s));
  out[B_T * n] = h.t;
  out[B_NX * n] = h.nx;
  out[B_NY * n] = h.ny;
  out[B_NZ * n] = h.nz;
  out[B_MAT * n] = (float)h.mat;
  out[B_ACT * n] = o[O_ACT] * (h.geom >= 0 ? 1.f : 0.f);
  out[B_UU * n] = h.u;
  out[B_VV * n] = h.v;
}

}  // namespace

extern "C" int ptdn_trace_bounce(const ptdn::SceneDev* s,
                                 const ptdn::TraceArgs* a, void* stream) {
  if (a->n > 0) {
    const int block = 128;
    trace_kernel<<<(a->n + block - 1) / block, block, 0,
                   (cudaStream_t)stream>>>(*s, *a);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptdn_bounce_fused(const ptdn::SceneDev* s,
                                 const ptdn::BounceArgs* a, void* stream) {
  if (a->n > 0) {
    const int block = 128;
    bounce_fused_kernel<<<(a->n + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(*s, *a);
  }
  return (int)cudaGetLastError();
}
