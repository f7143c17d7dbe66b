// The row policy of the per-scene builds of kernels F, H (bounce.cu), A
// and J (scene_intersect.cu): ptdn.cuh:MatRows with the scene's geoms and
// matrices from the generated scene.h
// (ops/cuda/scene_intersect.py:path_scene_header). The geom loop unrolls
// over the scene's geoms (ptdn.cuh:analytic_best), each geom's type
// folds away, and each row is MatRows' dot product,
// fmaf(m2, z, fmaf(m0, x, m1 * y)) (+ m3), with its entries in the
// instructions instead of loads from device memory: the same operations
// in the same order, so the same bits (no fast math: the compiler folds
// no 0 * x).
#pragma once

#include "../ptdn.cuh"
#include "scene.h"

namespace {

// The row policy of the per-scene build: MatRows with the scene's
// geoms and matrices from scene.h
struct SceneMats {
  static constexpr int kGeoms = scene::kGeoms;
  static constexpr bool kCompat = scene::kCompat;
  __device__ static __forceinline__ int type(const ptdn::SceneDev&, int g) {
    return scene::kType[g];
  }
  __device__ static __forceinline__ int mat(const ptdn::SceneDev&, int g) {
    return scene::kMat[g];
  }
  __device__ static __forceinline__ float row(const ptdn::SceneDev&, int g,
                                              int kind, int r, float x,
                                              float y, float z) {
    const float* m = (kind <= ptdn::kInv ? scene::kInvM[g]
                      : kind <= ptdn::kTf ? scene::kTfM[g]
                                          : scene::kInvTM[g]) + 4 * r;
    const float e = ptdn::dot3(m[0], m[1], m[2], x, y, z);
    return (kind == ptdn::kInvBias || kind == ptdn::kTfBias) ? e + m[3] : e;
  }
  __device__ static __forceinline__ float sub_row(const ptdn::SceneDev& s,
                                                  int g, int kind, int r,
                                                  float o, float x, float y,
                                                  float z) {
    return o - row(s, g, kind, r, x, y, z);
  }
};

}  // namespace
