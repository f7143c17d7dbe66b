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
// Its light-table entry (ptdn_shade_bounce_lights) serves native mode
// with more than one emissive geom: each NEE lane draws one light
// uniformly before its disk sample and weights the contribution by the
// light's color and the light count, and the drawn index goes out as a
// 22nd plane. The JAX package runs that on its XLA oracle bounce
// (engine/wavefront.py:1321-1345), because its TPU kernel bakes one
// light; here the single-light kernel keeps its code and the table is a
// second instantiation of the same lane (shade.cuh:shade_lane_of).
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
  float* out;         // (21, N): the O_* planes (22 with the light table:
                      // then the drawn light's index)
  int n;
  unsigned int fd;    // frame + depth
  unsigned int lane0;
  ShadeParams p;
};

}  // namespace ptdn

namespace {

__global__ void shade_kernel(ptdn::ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  const float* in = a.in + i;
  const uint32_t seed =
      ptdn::tea16((uint32_t)(int)in[ptdn::kShadeIn * n] + a.lane0, a.fd);
  float o[ptdn::kShadeOut];
  ptdn::shade_lane(in, n, seed, a.p, o);
  for (int k = 0; k < ptdn::kShadeOut; ++k) a.out[k * n + i] = o[k];
}

// The light-table entry (native mode, more than one light): the same
// lane with the light drawn from `lights` (shade.cuh:shade_lane_of),
// and the drawn light's index as a 22nd output plane.
__global__ void shade_lights_kernel(ptdn::ShadeArgs a,
                                    ptdn::LightTable lights) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t n = (size_t)a.n;
  const float* in = a.in + i;
  const uint32_t seed =
      ptdn::tea16((uint32_t)(int)in[ptdn::kShadeIn * n] + a.lane0, a.fd);
  float o[ptdn::kShadeOut];
  float li = 0.f;
  ptdn::shade_lane_of<true>(in, n, seed, a.p, o, lights, &li);
  for (int k = 0; k < ptdn::kShadeOut; ++k) a.out[k * n + i] = o[k];
  a.out[ptdn::kShadeOut * n + i] = li;
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

extern "C" int ptdn_shade_bounce_lights(const ptdn::ShadeArgs* a,
                                        const ptdn::LightTable* lights,
                                        void* stream) {
  if (a->n > 0) {
    const int block = 256;
    shade_lights_kernel<<<(a->n + block - 1) / block, block, 0,
                          (cudaStream_t)stream>>>(*a, *lights);
  }
  return (int)cudaGetLastError();
}
