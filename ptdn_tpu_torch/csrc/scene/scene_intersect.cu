// Kernels A (scene_intersect_full), J (scene_intersect_full_tex), M
// (scene_intersect) (../closest_hit.cuh) and I (light_visibility,
// ../light_visibility.cuh) built for one scene: the analytic tests' full dot
// products with the scene's matrix entries as constants
// (scene_mats.cuh:SceneMats), compiled once per scene beside B1, F and H
// (ops/cuda/_lib.py:build_scene) with the same generated scene.h. Scenes
// past the header's limits take the kernel library's build
// (../scene_intersect.cu), which computes the same bits.
#include "../light_visibility.cuh"
#include "scene_mats.cuh"

extern "C" int ptdn_scene_intersect_full(const ptdn::SceneDev* s,
                                         const ptdn::RayArgs* r,
                                         const ptdn::IsectArgs* a,
                                         void* stream) {
  return ptdn::launch_closest_hit<false, SceneMats>(s, r, a, stream);
}

extern "C" int ptdn_scene_intersect_full_tex(const ptdn::SceneDev* s,
                                             const ptdn::RayArgs* r,
                                             const ptdn::IsectArgs* a,
                                             void* stream) {
  return ptdn::launch_closest_hit<true, SceneMats>(s, r, a, stream);
}

extern "C" int ptdn_light_visibility(const ptdn::SceneDev* s,
                                     const ptdn::RayArgs* r, int light_geom,
                                     unsigned char* lit, void* stream) {
  return ptdn::launch_light_visibility<SceneMats>(s, r, light_geom, lit,
                                                  stream);
}

extern "C" int ptdn_scene_intersect(const ptdn::SceneDev* s,
                                    const ptdn::RayArgs* r,
                                    const ptdn::BestArgs* a, int cull,
                                    void* stream) {
  return ptdn::launch_scene_intersect<SceneMats>(s, r, a, cull, stream);
}
