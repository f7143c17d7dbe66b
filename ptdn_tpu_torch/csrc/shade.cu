// Kernel E (shade_bounce): one bounce of shading for every lane of the
// sorted wavefront.
//
// Replaces the TPU kernel ptdn_tpu/ops/pallas/shade.py:
// shade_bounce_pallas (_kernel with its pixel plane, shade_tiles). One
// thread per lane reads the 22 input planes (the I_* layout) and the
// pixel plane, seeds TEA with (pixel + lane0, frame + depth) as pix_seed
// does, because the coherence sort moves lanes and the random streams
// must follow pixels, and writes the 21 output planes (the O_* layout):
// emissive termination, albedo modulation, the NEE disk sample and
// scatterRay (shade.cuh). Every lane computes every output, dead lanes
// included, as the plain version does, so the two agree bit for bit.
//
// What bounds it: bytes. A lane reads 23 and writes 21 float32 planes,
// 176 B: 113 MB at 800x800, 34 us at 3.35 TB/s. Its ~250 float
// operations and two sin/cos pairs are far below the card's rate. Plane
// k of lane i sits at k * N + i, so each warp moves 128 B per plane.
//
// Dropped from the TPU design: the per-material constants baked into the
// kernel as select chains (engine/wavefront.py:_static_mats); the kernel
// reads the (M, 16) material table, which holds the same float32 values
// and which the cache broadcasts to a warp.
#include "shade.cuh"

namespace ptdn {

struct ShadeArgs {
  const float* in;    // (23, N): the I_* planes, then the pixel plane
  float* out;         // (21, N): the O_* planes
  const float* mats;  // (M, 16): scene.mat_attr
  int n;
  unsigned int fd;    // frame + depth
  unsigned int lane0;
  int shadow_ray;
  int reduce_var;
  int alb_skip;
  float light_x, light_y, light_z;
  float lrad;
  float sint;
};

}  // namespace ptdn

namespace {

enum {
  I_OX, I_OY, I_OZ, I_DX, I_DY, I_DZ, I_T, I_NX, I_NY, I_NZ,
  I_AR, I_AG, I_AB, I_TR, I_TG, I_TB, I_RR, I_RG, I_RB,
  I_MAT, I_ACT, I_DIF, I_PIX
};
enum {
  O_DX, O_DY, O_DZ, O_SPX, O_SPY, O_SPZ, O_TR, O_TG, O_TB,
  O_RR, O_RG, O_RB, O_DIF, O_ACT, O_SDX, O_SDY, O_SDZ,
  O_CR, O_CG, O_CB, O_NEE
};

__global__ void shade_kernel(ptdn::ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  const float* in = a.in + i;
  float* out = a.out + i;
  const float ox = in[I_OX * n], oy = in[I_OY * n], oz = in[I_OZ * n];
  const float dx = in[I_DX * n], dy = in[I_DY * n], dz = in[I_DZ * n];
  const float t = in[I_T * n];
  const float nx = in[I_NX * n], ny = in[I_NY * n], nz = in[I_NZ * n];
  float tr = in[I_TR * n], tg = in[I_TG * n], tb = in[I_TB * n];
  const int mat = (int)in[I_MAT * n];
  bool active = in[I_ACT * n] > 0.5f;
  const bool dif = in[I_DIF * n] > 0.5f;
  uint32_t seed =
      ptdn::tea16((uint32_t)(int)in[I_PIX * n] + a.lane0, a.fd);
  const float* m = a.mats + 16 * mat;
  const float m_emit = m[10], m_refl = m[7], m_refr = m[8], m_ior = m[9];

  // emissive hit terminates; skipped for NEE'd diffuse paths
  const bool emissive = m_emit > 0.f;
  bool add_emit = active && emissive;
  if (a.shadow_ray && a.reduce_var) add_emit = add_emit && !dif;
  const float add_f = add_emit ? 1.f : 0.f;
  const float rr = in[I_RR * n] + add_f * tr * m[0] * m_emit;
  const float rg = in[I_RG * n] + add_f * tg * m[1] * m_emit;
  const float rb = in[I_RB * n] + add_f * tb * m[2] * m_emit;
  active = active && !emissive;

  // hit point + spawn origin (+1e-4 n, pathtrace.cu:338)
  const float spx = (ox + t * dx) + 1e-4f * nx;
  const float spy = (oy + t * dy) + 1e-4f * ny;
  const float spz = (oz + t * dz) + 1e-4f * nz;

  // throughput *= albedo (pathtrace.cu:343-355)
  const float af = (active && !a.alb_skip) ? 1.f : 0.f;
  tr = tr * (1.f + af * (in[I_AR * n] - 1.f));
  tg = tg * (1.f + af * (in[I_AG * n] - 1.f));
  tb = tb * (1.f + af * (in[I_AB * n] - 1.f));

  // NEE disk sample toward the light (pathtrace.cu:357-366)
  float sdx = 0.f, sdy = 0.f, sdz = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
  bool nee = false;
  if (a.shadow_ray) {
    nee = active && (m_refl < 1e-6f) && (m_refr < 1e-6f);
    const ptdn::ShadowSample ss = ptdn::shadow_sample(
        seed, nee, a.light_x, a.light_y, a.light_z, a.lrad, spx, spy, spz);
    const float lambert =
        ptdn::jmax(0.f, ss.dx * nx + ss.dy * ny + ss.dz * nz);
    const float scale = a.sint / ss.dist2 * lambert;
    const float neef = nee ? 1.f : 0.f;
    sdx = ss.dx;
    sdy = ss.dy;
    sdz = ss.dz;
    cr = tr * scale * neef;
    cg = tg * scale * neef;
    cb = tb * scale * neef;
  }

  // scatterRay (interactions.h:94-136)
  const ptdn::Scattered sc = ptdn::scatter_ray(seed, active, dx, dy, dz, nx,
                                               ny, nz, m_refl, m_refr, m_ior);
  const float rff = (active && sc.reflect) ? 1.f : 0.f;
  const float actf = active ? 1.f : 0.f;
  out[O_DX * n] = actf * sc.dx + (1.f - actf) * dx;
  out[O_DY * n] = actf * sc.dy + (1.f - actf) * dy;
  out[O_DZ * n] = actf * sc.dz + (1.f - actf) * dz;
  out[O_SPX * n] = actf * spx + (1.f - actf) * ox;
  out[O_SPY * n] = actf * spy + (1.f - actf) * oy;
  out[O_SPZ * n] = actf * spz + (1.f - actf) * oz;
  out[O_TR * n] = active ? tr * (1.f + rff * (m[3] - 1.f)) : tr;
  out[O_TG * n] = active ? tg * (1.f + rff * (m[4] - 1.f)) : tg;
  out[O_TB * n] = active ? tb * (1.f + rff * (m[5] - 1.f)) : tb;
  out[O_RR * n] = rr;
  out[O_RG * n] = rg;
  out[O_RB * n] = rb;
  out[O_DIF * n] = (dif || (active && sc.diffuse)) ? 1.f : 0.f;
  out[O_ACT * n] = actf;
  out[O_SDX * n] = sdx;
  out[O_SDY * n] = sdy;
  out[O_SDZ * n] = sdz;
  out[O_CR * n] = cr;
  out[O_CG * n] = cg;
  out[O_CB * n] = cb;
  out[O_NEE * n] = nee ? 1.f : 0.f;
}

}  // namespace

extern "C" int ptdn_shade_bounce(const ptdn::ShadeArgs* a, void* stream) {
  if (a->n > 0) {
    const int block = 256;
    shade_kernel<<<(a->n + block - 1) / block, block, 0,
                   (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}
