// Kernels A and J (scene_intersect.cu) in native mode (compat=False):
// the closest hit with true barycentric mesh normals
// (ptdn.cuh:resolve_hit, MatRowsNative), for the scenes past the
// per-scene build's limits; the per-scene build takes the mode from its
// header instead (scene/scene_intersect.cu). A translation unit of their
// own: built beside compat mode's kernels in scene_intersect.cu, they
// changed how the compiler inlined the block scan into kernels M and I,
// which then no longer compiled to the code they had before native mode.
// I and M resolve no normal and have no native build.
#include "closest_hit.cuh"

extern "C" int ptdn_scene_intersect_full_native(const ptdn::SceneDev* s,
                                                const ptdn::RayArgs* r,
                                                const ptdn::IsectArgs* a,
                                                void* stream) {
  return ptdn::launch_closest_hit<false, ptdn::MatRowsNative>(s, r, a,
                                                             stream);
}

extern "C" int ptdn_scene_intersect_full_tex_native(const ptdn::SceneDev* s,
                                                    const ptdn::RayArgs* r,
                                                    const ptdn::IsectArgs* a,
                                                    void* stream) {
  return ptdn::launch_closest_hit<true, ptdn::MatRowsNative>(s, r, a,
                                                            stream);
}
