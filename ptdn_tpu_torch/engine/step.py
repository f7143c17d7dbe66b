"""The frame step: trace + denoise + accumulate, with the whole carried
state of a frame (accumulation image, SVGF history, primary-hit cache)
in the registered buffers of one module.

The per-frame host path of the reference (runCuda -> pathtrace ->
denoise, main.cpp:154-209 / pathtrace.cu:404-452): `left` is the raw
1-spp (or accumulated) image, `right` the denoised one
(sendTwoImagesToPBO, pathtrace.cu:46-78). `frame_state()` returns the
state under the JAX package's keys and layouts (engine/step.py:30-46),
`load_frame_state()` takes such a dict back.

A shard of a taller image (parallel/sharded.py) gives its own tracer
(PathTracer with row0 and full_height, the JAX package's trace_override)
and pyramid (the à-trous levels with their halos, pyramid_override);
its frame_gen() is then a generator of the exchanges its denoiser asks
of the group.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ptdn_tpu_torch.denoise.svgf import (Pyramid, SVGFDenoiser,
                                         init_denoise_state, run_alone)
from ptdn_tpu_torch.engine.wavefront import PathTracer, init_primary_cache
from ptdn_tpu_torch.utils.stats import span


def init_frame_state(resolution, device) -> Dict[str, torch.Tensor]:
    w, h = resolution
    state = {"accum_image": torch.zeros((h, w, 3), device=device)}
    state.update(init_denoise_state(resolution, device))
    state.update(init_primary_cache(w * h, device))
    return state


class FrameStep(nn.Module):
    def __init__(self, scene, cfg, resolution, device,
                 tracer: Optional[PathTracer] = None,
                 pyramid: Optional[Pyramid] = None):
        super().__init__()
        self.cfg = cfg
        self.resolution = tuple(resolution)
        self.tracer = tracer or PathTracer(scene, cfg, self.resolution,
                                           device)
        rows = (None if self.tracer.full_height is None
                else (self.tracer.row0, self.tracer.full_height))
        self.denoiser = SVGFDenoiser(cfg, self.resolution, device, rows,
                                     pyramid)
        w, h = self.resolution
        self.register_buffer("accum_image", torch.zeros((h, w, 3),
                                                        device=device))

    def frame_state(self) -> Dict[str, torch.Tensor]:
        # the scene tensors are non-persistent buffers: not frame state
        return {k.rpartition(".")[2]: v
                for k, v in self.state_dict(keep_vars=True).items()}

    def load_frame_state(self, state: Dict[str, torch.Tensor]):
        for k, v in state.items():
            owner = next(m for m in (self, self.tracer, self.denoiser)
                         if k in m._buffers)
            setattr(owner, k, v)
        self.tracer.rays_stale = True
        self.denoiser.forget_motion()

    def reset(self):
        self.load_frame_state(init_frame_state(self.resolution,
                                               self.accum_image.device))

    def forward(self, cam, view_mat, params, frame: int, cam_changed: bool):
        return run_alone(self.frame_gen(cam, view_mat, params, frame,
                                    cam_changed))

    def frame_gen(self, cam, view_mat, params, frame: int,
                  cam_changed: bool):
        """forward as a generator of exchanges (a shard's), returning
        (left, right)."""
        with span("ptdn.step"):
            w, h = self.resolution
            with span("ptdn.tracer"):
                radiance, gb = self.tracer(cam, params, frame, cam_changed)
            radiance = radiance.reshape(h, w, 3)
            gbuffer = {k: v.reshape((h, w) + tuple(v.shape[1:]))
                       for k, v in gb.items()}
            if self.cfg.denoise_enable:
                left = radiance
                with span("ptdn.denoiser"):
                    right = yield from self.denoiser.frame_gen(
                        radiance, gbuffer, view_mat, params, cam_changed)
                self.accum_image = radiance
            else:
                # running mean over frames (pathtrace.cu:398), float32
                # scalars
                f = np.float32(frame)
                one = np.float32(1.0)
                accum = (self.accum_image * float(f / (f + one))
                         + radiance / float(f + one))
                left = right = accum
                self.accum_image = accum
            return left, right


def make_frame_step(scene, cfg, resolution, device) -> FrameStep:
    return FrameStep(scene, cfg, resolution, device)
