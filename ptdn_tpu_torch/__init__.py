"""ptdn_tpu_torch — the path tracer + SVGF denoiser of ptdn_tpu on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A 1-spp Monte Carlo path tracer (analytic cubes/spheres, OBJ meshes,
texture mapping, next-event-estimation shadow rays) feeding an SVGF
denoiser (temporal reprojection + accumulation, edge-stopping à-trous
filtering), with the JAX package ``ptdn_tpu`` as its reference. The
layout mirrors ``ptdn_tpu``:

  scene/     host scene layer: parser, OBJ loader, SAH BVH, DeviceScene
  ops/       plain PyTorch device math (RNG, camera, intersection, BSDF)
  ops/cuda/  the kernels' Python wrappers, each beside its plain version
  csrc/      the CUDA C++ kernels
  engine/    path tracer, frame step, Renderer
  denoise/   SVGF: reprojection, à-trous, orchestration
  utils/     config, assets, image IO, checkpoints, stats, terminal view
  app/       camera automation, the CLI, the evaluator, the viewer
  bench.py   the benchmark entry (python3 -m ptdn_tpu_torch.bench)

Every tensor lives on the device the caller names. A wrapper in
``ops/cuda`` runs its plain version on CPU tensors and launches its
kernel on CUDA tensors; there is no fallback between the two. This
package never imports jax.
"""

from ptdn_tpu_torch.utils.config import RenderConfig  # noqa: F401
