// The block-level chunk scan of kernels F and H (bounce.cuh), A, J and M
// (closest_hit.cuh) and I (light_visibility.cuh): a block of kScanBlock
// lanes walks the scene's triangle chunks once, in ascending order, and
// tests each chunk's 128 triangles, staged in shared memory, against
// every ray of the block that crosses the chunk. Which queries a lane
// carries is a compile-time choice: F and H scan the next rays (closest
// hit, Next) and the shadow rays (any hit, Shadow) in one joint loop, the
// TPU kernels' joint scan (ptdn_tpu/ops/pallas/scene_intersect.py:
// joint_mesh_tiles) in the form this card wants; A, J and M the
// closest-hit query alone; I the any-hit query alone. A scan without one
// of the two pays for no second list slot, key, cull or ballot of it.
// Without Cull (M's cull=False) a lane wants every chunk of its range,
// the AABB test skipped: the same answer, more work; every lane of the
// block then tests every staged triangle, so each thread walks its own
// ray over them (no list: a transposed test gains nothing where no lane
// skips a chunk, and ran 20% slower than M's per-lane walk there).
//
// The block's chunk range is the union of its lanes' ranges (a block
// reduction). The AABBs of its first kAabbStaged chunks are loaded into
// shared memory once per block. For each chunk every lane evaluates its
// own cull (ptdn.cuh:chunk_crossed against its running best or its shadow
// limit, inside its own range), and a block vote (__syncthreads_or)
// skips the chunks that no lane crosses. A chunk that some lane crosses
// is copied, its 128 tri_moller rows (6 KB), into a ring of kStages
// stages by cp.async, so that the next crossed chunk loads while this one
// is tested.
//
// The test is transposed: the rays that cross the chunk are compacted
// into a list in shared memory, and thread j tests triangle j against
// every ray of the list (a chunk of fewer triangles, the scene's last,
// splits the list among groups of threads). A warp's threads run the
// same ray at the same time, whatever each lane wants, so no thread
// idles while another walks its own chunks (a thread per lane walking
// the staged triangles leaves the lanes of a warp idle wherever their
// chunk sets differ: it ran slower than the per-lane walks, PERF.md). A hit
// that beats the ray's limit at the chunk's start goes into the ray's
// key, (t's bits, triangle index), by a shared-memory atomicMin.
//
// Why the results are the scan of ptdn.cuh (mesh_best, light_visible)
// bit for bit: a ray is tested against exactly the chunks its own cull
// lets through, evaluated at the chunk's start with its running best, in
// ascending order; within a chunk the sequential strict-< update from
// the chunk's starting best ends on the smallest t that beats it, at the
// lowest index among equal ones, which is the smallest key (t > 0, so
// its bits order as the floats do); the test is ptdn.cuh's moller. A
// shadow ray is occluded where any triangle beats its limit, in whatever
// order; it stops at the chunk of its first occluder. The block vote for
// the next crossed chunk is cast before the current chunk is tested,
// with each lane's running best as it stands then; since a running best
// only falls, and a chunk crossed below a limit is crossed below any
// larger one, the vote's chunk set holds every chunk a lane will want,
// and a lane re-evaluates its own cull at the chunk's turn.
//
// The reciprocal stays eager: deferring it past a < FLT_EPSILON and
// t's numerator <= 0, per thread or per warp, computes the same bits but
// ran 0-21% slower here, since a warp's threads test different triangles
// and diverge at every early exit (PERF.md).
#pragma once

#include "ptdn.cuh"

namespace ptdn {

// Sizes chosen on an H100 for F and H: 256 lanes a block, and 5 or 7
// blocks an SM (96 or 72 registers), each ran slower on some of the
// timed cases. A and J take 60 registers under any cap from 5 to 8
// blocks an SM, and ran the same under each.
constexpr int kScanBlock = 128;       // threads per block: one per triangle
constexpr int kScanBlocksPerSM = 6;   // at most 80 registers a thread
constexpr int kStages = 2;         // the triangle ring
constexpr int kAabbStaged = 256;   // chunk AABBs kept in shared memory
static_assert(kScanBlock == kChunk, "a thread per triangle of a chunk");

// A ray of the list that crosses the current chunk: origin and limit,
// direction
struct ScanEntry {
  float4 ol;
  float4 d;
};

// The block's shared state; Next: a lane carries a closest-hit query,
// Shadow: an any-hit query (one of them at least)
template <bool Next, bool Shadow>
struct ScanSmem {
  static_assert(Next || Shadow, "a scan of no query");
  // the list's slots: the next ray and the shadow ray of every lane, as
  // the lanes carry them
  static constexpr int kRays = ((int)Next + (int)Shadow) * kScanBlock;
  float4 tri[kStages][kChunk * 3];     // 128 tri_moller rows per stage
  float aabb[kAabbStaged][6];          // lo xyz, hi xyz
  ScanEntry ray[kRays];
  unsigned long long key[kRays];
  int count[kScanBlock / 32];          // rays per warp
  int lo, hi;                          // the block's chunk range
};

// A ray of the scan and its reciprocal direction
struct ScanRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ ScanRay scan_ray(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  return ScanRay{ox, oy, oz, dx, dy, dz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
}

// One query of a lane: `on` while the lane still scans for it; the
// chunks [lo, hi]; the limit its hits must beat (the running best of a
// closest-hit query, fixed for a shadow query); the triangle found, -1
// if none (the closest one that beats the starting limit, or an
// occluder).
struct ScanQuery {
  ScanRay r;
  float lim;
  int best;
  int lo, hi;
  bool on;
};

// A lane's query that scans nothing: off, best -1
__device__ __forceinline__ ScanQuery no_query() {
  return ScanQuery{ScanRay{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f},
                   0.f, -1, 0, -1, false};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one of this thread's groups is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Does query q want chunk c: on, c in its range, and (with Cull) its ray
// crosses the chunk's AABB below its limit (the AABB from shared memory
// within the staged ones, else from device memory: the same values)
template <bool Cull, bool Next, bool Shadow>
__device__ __forceinline__ bool query_wants(const SceneDev& s,
                                            const ScanSmem<Next, Shadow>& sm,
                                            int c, const ScanQuery& q) {
  if (!q.on || c < q.lo || c > q.hi) return false;
  if (!Cull) return true;
  const int k = c - sm.lo;
  if (k < kAabbStaged)
    return slab_crossed(sm.aabb[k], sm.aabb[k] + 3, q.r.ox, q.r.oy, q.r.oz,
                        q.r.ix, q.r.iy, q.r.iz, q.lim);
  return chunk_crossed(s, c, q.r.ox, q.r.oy, q.r.oz, q.r.ix, q.r.iy,
                       q.r.iz, q.lim);
}

// The first chunk after c that some lane of the block wants, hi + 1 if
// none (block-uniform; every thread of the block calls it)
template <bool Cull, bool Next, bool Shadow>
__device__ __forceinline__ int next_voted(const SceneDev& s,
                                          const ScanSmem<Next, Shadow>& sm,
                                          int c, int hi, const ScanQuery& nq,
                                          const ScanQuery& sq) {
  for (++c; c <= hi; ++c)
    if (__syncthreads_or((Next && query_wants<Cull>(s, sm, c, nq)) ||
                         (Shadow && query_wants<Cull>(s, sm, c, sq))))
      return c;
  return c;
}

// Copy chunk c's tri_moller rows into ring stage `stage`: 384 16-byte
// pieces, three per thread. tri_moller is padded to whole chunks.
template <bool Next, bool Shadow>
__device__ __forceinline__ void stage_chunk(const SceneDev& s,
                                            ScanSmem<Next, Shadow>& sm, int c,
                                            int stage) {
  const float4* src =
      reinterpret_cast<const float4*>(s.tri_moller) + (size_t)c * kChunk * 3;
  for (int k = threadIdx.x; k < kChunk * 3; k += kScanBlock)
    cp_async16(&sm.tri[stage][k], src + k);
}

// Put query q's ray into list slot k, its key empty
template <bool Next, bool Shadow>
__device__ __forceinline__ void put_ray(ScanSmem<Next, Shadow>& sm, int k,
                                        const ScanQuery& q) {
  sm.ray[k].ol = make_float4(q.r.ox, q.r.oy, q.r.oz, q.lim);
  sm.ray[k].d = make_float4(q.r.dx, q.r.dy, q.r.dz, 0.f);
  sm.key[k] = ~0ull;
}

// The scan of a block's lanes: with Next nq, the next ray's closest-hit
// query, and with Shadow sq, the shadow ray's any-hit query (each with
// best -1 and its limit on entry; a query the scan does not carry is not
// read). Every thread of the block calls it, a thread without a lane
// with its queries off.
template <bool Next, bool Shadow, bool Cull = true>
__device__ inline void chunk_scan(const SceneDev& s,
                                  ScanSmem<Next, Shadow>& sm, ScanQuery& nq,
                                  ScanQuery& sq) {
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  if (tid == 0) {
    sm.lo = 0x7fffffff;
    sm.hi = -1;
  }
  if (Next) {
    nq.lo = max(nq.lo, 0);
    nq.hi = min(nq.hi, s.n_chunks - 1);
  }
  if (Shadow) {
    sq.lo = max(sq.lo, 0);
    sq.hi = min(sq.hi, s.n_chunks - 1);
  }
  int lo = 0x7fffffff, hi = -1;
  if (Next && nq.on && nq.lo <= nq.hi) {
    lo = nq.lo;
    hi = nq.hi;
  }
  if (Shadow && sq.on && sq.lo <= sq.hi) {
    lo = min(lo, sq.lo);
    hi = max(hi, sq.hi);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  __syncthreads();
  if (wl == 0) {
    atomicMin(&sm.lo, lo);
    atomicMax(&sm.hi, hi);
  }
  __syncthreads();
  lo = sm.lo;
  hi = sm.hi;
  if (lo > hi) return;   // block-uniform: no lane scans
  const int n_aabb = min(hi - lo + 1, kAabbStaged);
  for (int k = tid; k < n_aabb * 6; k += kScanBlock) {
    const int c = lo + k / 6, j = k % 6;
    sm.aabb[k / 6][j] = j < 3 ? s.chunk_min[3 * c + j]
                              : s.chunk_max[3 * c + j - 3];
  }
  __syncthreads();

  const unsigned below = (1u << wl) - 1u;   // the warp's lanes before
  int c = next_voted<Cull>(s, sm, lo - 1, hi, nq, sq);
  if (c <= hi) stage_chunk(s, sm, c, 0);
  cp_async_commit();
  for (int stage = 0; c <= hi; stage ^= 1) {
    // the vote for the chunk after c, before c's tests lower any best
    const int c2 = next_voted<Cull>(s, sm, c, hi, nq, sq);
    if (c2 <= hi) stage_chunk(s, sm, c2, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // chunk c staged; the last chunk's keys read

    if constexpr (!Cull) {
      // every lane wants every chunk of its range: each thread walks its
      // own ray over the staged triangles in ascending order, strict <,
      // as mesh_best does (a warp reads one triangle at a time, and no
      // list, key or atomic is needed); the next vote's barrier guards
      // the stage before it is refilled
      static_assert(Next && !Shadow, "the cull is off for M alone");
      if (query_wants<Cull>(s, sm, c, nq)) {
        const int cnt = min(kChunk, s.n_tris - c * kChunk);
        for (int j = 0; j < cnt; ++j) {
          const float4 r0 = sm.tri[stage][3 * j];
          const float4 r1 = sm.tri[stage][3 * j + 1];
          const float4 r2 = sm.tri[stage][3 * j + 2];
          const MollerTri mt{r0.x, r0.y, r0.z, r0.w, r1.x,
                             r1.y, r1.z, r1.w, r2.x};
          float t;
          if (moller(mt, nq.r.ox, nq.r.oy, nq.r.oz, nq.r.dx, nq.r.dy,
                     nq.r.dz, t) && t < nq.lim) {
            nq.lim = t;
            nq.best = c * kChunk + j;
          }
        }
      }
      c = c2;
      continue;
    }

    // the list of rays that want chunk c: each warp's next rays, then
    // its shadow rays, warp after warp
    const bool wn = Next && query_wants<Cull>(s, sm, c, nq);
    const bool ws = Shadow && query_wants<Cull>(s, sm, c, sq);
    const unsigned bn = Next ? __ballot_sync(0xffffffffu, wn) : 0u;
    const unsigned bs = Shadow ? __ballot_sync(0xffffffffu, ws) : 0u;
    if (wl == 0) sm.count[warp] = __popc(bn) + __popc(bs);
    __syncthreads();
    int base = 0, m = 0;
    for (int w = 0; w < kScanBlock / 32; ++w) {
      base += w < warp ? sm.count[w] : 0;
      m += sm.count[w];
    }
    const int kn = base + __popc(bn & below);
    const int ks = base + __popc(bn) + __popc(bs & below);
    if (wn) put_ray(sm, kn, nq);
    if (ws) put_ray(sm, ks, sq);
    __syncthreads();

    // thread tid tests triangle j of the chunk against every ray, or,
    // where the chunk holds fewer triangles than threads, against every
    // groups-th ray from its group's: thread tid is triangle tid % cnt
    // of group tid / cnt
    const int cnt = min(kChunk, s.n_tris - c * kChunk);
    const int groups = kScanBlock / cnt;
    const int grp = tid / cnt, j = tid - grp * cnt;
    if (grp < groups) {
      const int tri = c * kChunk + j;
      const float4 r0 = sm.tri[stage][3 * j];
      const float4 r1 = sm.tri[stage][3 * j + 1];
      const float4 r2 = sm.tri[stage][3 * j + 2];
      const MollerTri mt{r0.x, r0.y, r0.z, r0.w, r1.x,
                         r1.y, r1.z, r1.w, r2.x};
#pragma unroll 2   // two rays in flight: 1-4% faster on the H100
      for (int k = grp; k < m; k += groups) {
        const float4 ol = sm.ray[k].ol, d = sm.ray[k].d;
        float t;
        if (moller(mt, ol.x, ol.y, ol.z, d.x, d.y, d.z, t) && t < ol.w)
          atomicMin(&sm.key[k], (unsigned long long)__float_as_uint(t)
                                        << 32 | (unsigned)tri);
      }
    }
    __syncthreads();

    // each lane takes its rays' results
    if (wn && sm.key[kn] != ~0ull) {
      nq.lim = __uint_as_float((unsigned)(sm.key[kn] >> 32));
      nq.best = (int)(sm.key[kn] & 0xffffffffu);
    }
    if (ws && sm.key[ks] != ~0ull) {
      sq.best = (int)(sm.key[ks] & 0xffffffffu);
      sq.on = false;
    }
    c = c2;
  }
}

// The closest-hit scan alone (kernels A, J and M): q as chunk_scan's nq
template <bool Cull = true>
__device__ inline void chunk_scan(const SceneDev& s,
                                  ScanSmem<true, false>& sm, ScanQuery& q) {
  ScanQuery none = no_query();
  chunk_scan<true, false, Cull>(s, sm, q, none);
}

// The any-hit scan alone (kernel I): q as chunk_scan's sq
__device__ inline void chunk_scan(const SceneDev& s,
                                  ScanSmem<false, true>& sm, ScanQuery& q) {
  ScanQuery none = no_query();
  chunk_scan(s, sm, none, q);
}

}  // namespace ptdn
