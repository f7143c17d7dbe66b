// Kernels F (trace_bounce) and H (bounce_fused) (bounce.cuh) with the
// analytic tests' full dot products read from the scene's matrices in
// device memory (ptdn.cuh:MatRows), built once into the kernel library.
// They serve the scenes past the per-scene build's limits
// (ops/cuda/scene_intersect.py:path_scene_header returns None); the
// others take scene/bounce.cu, which computes the same bits. Both modes
// are built: compat mode's and native mode's (the _native entries).
#include "bounce.cuh"

extern "C" int ptdn_trace_bounce(const ptdn::SceneDev* s,
                                 const ptdn::TraceArgs* a, void* stream) {
  return ptdn::launch_trace_bounce<ptdn::MatRows>(s, a, stream);
}

extern "C" int ptdn_bounce_fused(const ptdn::SceneDev* s,
                                 const ptdn::BounceArgs* a, void* stream) {
  return ptdn::launch_bounce_fused<ptdn::MatRows>(s, a, stream);
}

// the same in native mode (compat=False: true barycentric normals); the
// per-scene build takes the mode from its header
extern "C" int ptdn_trace_bounce_native(const ptdn::SceneDev* s,
                                        const ptdn::TraceArgs* a,
                                        void* stream) {
  return ptdn::launch_trace_bounce<ptdn::MatRowsNative>(s, a, stream);
}

extern "C" int ptdn_bounce_fused_native(const ptdn::SceneDev* s,
                                        const ptdn::BounceArgs* a,
                                        void* stream) {
  return ptdn::launch_bounce_fused<ptdn::MatRowsNative>(s, a, stream);
}
