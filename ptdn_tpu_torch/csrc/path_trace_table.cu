// Kernel B1's table build (path_trace_table): the bounce loop of
// csrc/path_trace.cuh with the baked rows, geom types and materials read
// from device memory, for the scenes the per-scene build
// (csrc/scene/path_trace.cu) does not take: more than B1_MAX_GEOMS geoms,
// more than B1_MAX_MATS materials, or a matrix or material constant that
// is not finite (ops/cuda/scene_intersect.py:path_scene_header). The JAX
// path kernel has no such limits, so neither has this build.
//
// Replaces, like the per-scene build, the TPU kernel
// ptdn_tpu/ops/pallas/path.py:path_trace_fused_pallas. Its tables
// (ops/cuda/scene_intersect.py:table_rows) hold per geom a head word, the
// forms of its 5 kinds x 3 baked rows (baked_rows, the forms
// path_scene_header writes as constants) and a record of float4 words:
// the geom's padded world box, then each row's coefficients (c0..c3);
// besides them the (G, 2) geom type and material table and the (M, 16)
// material table. Every read goes through __ldg.
//
// The geom loop runs in scene order with strict < (the first geom wins a
// tie), as the per-scene build's, and takes per geom the path its head
// names, a branch that is the same for every lane of a warp:
//
// * a cube whose 15 rows each read one slot, the row's own (x, y or z:
//   translated, scaled, no rotation), or
// * a cube whose rows 0 and 2 read x then z and row 1 y alone (a rotation
//   about y, as the generated cubes of utils/assets.py:write_cornell_plus
//   and cornell's boxes have)
//
// has each row's expression fixed in the code, its coefficients loaded
// as one float4; every other geom runs form_row, the per-row switch of
// the per-scene build. Each path computes form_row's bits: a lone
// product c0 * v is fma(c0, v, -0.0) (its table c3 is -0.0, and adding
// -0.0 to the exact product changes no bit, a signed zero included), a
// form without a bias adds c3 = -0.0 (the same identity), and o - row of
// a lone product fuses into fma(-c0, v, o) exactly where form_sub_row
// fuses it (c3 is 0 there and only there: an FMA row's bias is not 0).
//
// A geom whose head says so (a small, well-conditioned cube) is skipped
// by a lane whose ray misses its world box: the box of the unit cube's
// corners through the transform, padded by 1e-3 of its largest
// coordinate (at least 1e-3), which holds every hit point the analytic
// test can report (tests/test_torch_b1_table.py checks that no hit is
// skipped on the 65-geom scene's rays). A NaN in the slab test keeps the
// geom. A warp runs a geom's test while any of its lanes wants it.
//
// What bounds it: as the per-scene build, arithmetic and divergence (the
// analytic tests of ~2 x G geoms per depth, minus the skipped ones),
// plus a dependent head load per geom. Tried on the 65-geom scene
// (cornell plus 55 cubes, 800x800) and cornell, NVIDIA H100 80GB HBM3,
// 700 W: the per-scene build with the loop unrolled over 65 geoms ran
// 2x slower than a switch per row (its code outgrows the instruction
// cache); the tables staged in shared memory gained nothing over __ldg
// (a warp reads one address: a broadcast from L1 either way); constant
// memory ran 2.69 ms against the per-scene build's 1.17 on cornell. The
// full dot products of MatRows would not compute these bits: they left
// 0.17% of pixels off the JAX kernel, the baked forms none.
#include "path_trace.cuh"

namespace {

// the layout of the tables (ops/cuda/scene_intersect.py:table_rows)
constexpr int kCodes = 16;    // ints a geom: its head, then 15 row forms
constexpr int kWords = 17;    // float4 words a geom: box lo, hi, 15 rows
// the head's path (its low 2 bits) and flag
constexpr int kSkip = 0, kGeneric = 1, kDiag = 2, kYRot = 3;
constexpr int kCull = 4;

__device__ __forceinline__ const float4* record(const ptdn::SceneDev& s,
                                                int g) {
  return reinterpret_cast<const float4*>(s.row_coef) + kWords * g;
}

// row i of geom g's record (i = kind * 3 + r)
__device__ __forceinline__ float4 coef(const ptdn::SceneDev& s, int g,
                                       int i) {
  return __ldg(record(s, g) + 2 + i);
}

// Does the ray o + t d (i = 1 / d) miss the box [lo, hi] or leave it
// behind its origin? False where the slab test meets a NaN.
__device__ __forceinline__ bool box_missed(float4 lo, float4 hi, float ox,
                                           float oy, float oz, float ix,
                                           float iy, float iz) {
  const float t0x = (lo.x - ox) * ix, t1x = (hi.x - ox) * ix;
  const float t0y = (lo.y - oy) * iy, t1y = (hi.y - oy) * iy;
  const float t0z = (lo.z - oz) * iz, t1z = (hi.z - oz) * iz;
  const float tmin = ptdn::jmax(ptdn::jmax(ptdn::jmin(t0x, t1x),
                                           ptdn::jmin(t0y, t1y)),
                                ptdn::jmin(t0z, t1z));
  const float tmax = ptdn::jmin(ptdn::jmin(ptdn::jmax(t0x, t1x),
                                           ptdn::jmax(t0y, t1y)),
                                ptdn::jmax(t0z, t1z));
  return (tmax < 0.f) || (tmin > tmax);
}

// The rows of a cube on a fixed path (kDiag or kYRot): row r of each
// kind reads slot r alone, fma(c0, v_r, c3), except on kYRot rows 0 and
// 2, fma(c0, x, c1 * z) + c3.
template <int Path>
struct CubeRows {
  __device__ static __forceinline__ int type(const ptdn::SceneDev&, int) {
    return ptdn::kCube;
  }
  __device__ static __forceinline__ float row(const ptdn::SceneDev& s, int g,
                                              int kind, int r, float x,
                                              float y, float z) {
    const float4 c = coef(s, g, kind * 3 + r);
    if (Path == kYRot && r != 1) return fmaf(c.x, x, c.y * z) + c.w;
    return fmaf(c.x, r == 0 ? x : (r == 1 ? y : z), c.w);
  }
  __device__ static __forceinline__ float sub_row(const ptdn::SceneDev& s,
                                                  int g, int kind, int r,
                                                  float o, float x, float y,
                                                  float z) {
    if (Path == kYRot && r != 1) return o - row(s, g, kind, r, x, y, z);
    const float4 c = coef(s, g, kind * 3 + r);
    const float v = r == 0 ? x : (r == 1 ? y : z);
    return c.w == 0.f ? fmaf(-c.x, v, o) : o - fmaf(c.x, v, c.w);
  }
};

// The row policy of the table build: every row by form_row from the
// tables (the generic path), the geom walk with its paths and cull, and
// the material table.
struct TableRows {
  static constexpr int kGeoms = -1;   // walks the geoms itself (walk)
  static constexpr bool kCompat = true;
  __device__ static __forceinline__ int type(const ptdn::SceneDev& s,
                                             int g) {
    return __ldg(s.geom + 2 * g);
  }
  __device__ static __forceinline__ int mat(const ptdn::SceneDev& s, int g) {
    return __ldg(s.geom + 2 * g + 1);
  }
  __device__ static __forceinline__ float row(const ptdn::SceneDev& s, int g,
                                              int kind, int r, float x,
                                              float y, float z) {
    const int i = kind * 3 + r;
    const float4 q = coef(s, g, i);
    const float c[4] = {q.x, q.y, q.z, q.w};
    return form_row(__ldg(s.row_code + kCodes * g + 1 + i), c, x, y, z);
  }
  __device__ static __forceinline__ float sub_row(const ptdn::SceneDev& s,
                                                  int g, int kind, int r,
                                                  float o, float x, float y,
                                                  float z) {
    const int i = kind * 3 + r;
    const float4 q = coef(s, g, i);
    const float c[4] = {q.x, q.y, q.z, q.w};
    return form_sub_row(__ldg(s.row_code + kCodes * g + 1 + i), c, o, x, y,
                        z);
  }
  // field k of material m's mat_attr row
  __device__ static __forceinline__ float mat_attr(const ptdn::SceneDev& s,
                                                   int m, int k) {
    return __ldg(s.mat_attr + 16 * m + k);
  }
  // The closest analytic hit b over the geoms in scene order: each geom
  // on the path of its head, skipped where the ray misses its box and
  // the head lets it.
  __device__ static void walk(const ptdn::SceneDev& s, float ox, float oy,
                              float oz, float dx, float dy, float dz,
                              bool want_normals, ptdn::Analytic& b) {
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    for (int g = 0; g < s.n_geoms; ++g) {
      const int head = __ldg(s.row_code + kCodes * g);
      const int path = head & 3;
      if (path == kSkip) continue;
      if ((head & kCull) &&
          box_missed(__ldg(record(s, g)), __ldg(record(s, g) + 1), ox, oy,
                     oz, ix, iy, iz))
        continue;
      if (path == kDiag)
        ptdn::analytic_geom<CubeRows<kDiag>>(s, g, ox, oy, oz, dx, dy, dz,
                                             want_normals, b);
      else if (path == kYRot)
        ptdn::analytic_geom<CubeRows<kYRot>>(s, g, ox, oy, oz, dx, dy, dz,
                                             want_normals, b);
      else
        ptdn::analytic_geom<TableRows>(s, g, ox, oy, oz, dx, dy, dz,
                                       want_normals, b);
    }
  }
};

// TableRows in native mode (compat=False): true barycentric normals
struct TableRowsNative : TableRows {
  static constexpr bool kCompat = false;
};

__global__ void __launch_bounds__(128, 8)
    path_trace_table_kernel(ptdn::SceneDev s, ptdn::PathArgs a) {
  path_trace_lane<TableRows>(s, a, blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(128, 8)
    path_trace_table_native_kernel(ptdn::SceneDev s, ptdn::PathArgs a) {
  path_trace_lane<TableRowsNative>(s, a,
                                   blockIdx.x * blockDim.x + threadIdx.x);
}

int launch_table(void (*kernel)(ptdn::SceneDev, ptdn::PathArgs),
                 const ptdn::SceneDev* s, const ptdn::PathArgs* a,
                 void* stream) {
  if (a->n > 0) {
    const int block = 128;
    kernel<<<(a->n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
        *s, *a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// compat mode and native mode, picked at launch (the per-scene build,
// scene/path_trace.cu, takes the mode as a constant of its header)
extern "C" int ptdn_path_trace_table(const ptdn::SceneDev* s,
                                     const ptdn::PathArgs* a, void* stream) {
  return launch_table(path_trace_table_kernel, s, a, stream);
}

extern "C" int ptdn_path_trace_table_native(const ptdn::SceneDev* s,
                                            const ptdn::PathArgs* a,
                                            void* stream) {
  return launch_table(path_trace_table_native_kernel, s, a, stream);
}
