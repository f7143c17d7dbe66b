// Kernels F (trace_bounce) and H (bounce_fused) (../bounce.cuh) built for
// one scene: the analytic tests' full dot products with the scene's
// matrix entries as constants.
//
// It is compiled once per scene beside kernel B1 (path_trace.cu;
// ops/cuda/_lib.py:build_scene) with the same generated scene.h
// (ops/cuda/scene_intersect.py:path_scene_header), which holds each
// geom's type, material and its three matrices as exact hex-float
// literals, read through scene_mats.cuh:SceneMats. B1's baked row forms
// round differently and are not used here. Scenes past the header's
// limits take the kernel library's build (bounce.cu).
#include "../bounce.cuh"
#include "scene_mats.cuh"

extern "C" int ptdn_trace_bounce(const ptdn::SceneDev* s,
                                 const ptdn::TraceArgs* a, void* stream) {
  return ptdn::launch_trace_bounce<SceneMats>(s, a, stream);
}

extern "C" int ptdn_bounce_fused(const ptdn::SceneDev* s,
                                 const ptdn::BounceArgs* a, void* stream) {
  return ptdn::launch_bounce_fused<SceneMats>(s, a, stream);
}
