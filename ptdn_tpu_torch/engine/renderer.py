"""Host-side renderer: owns scene, config, camera and the frame step on
one device — the reference's app control loop (main.cpp runCuda + reset
logic), headless.

The renderer runs on the card unless the caller names another device
(``device="cpu"`` runs every kernel's plain PyTorch version); without a
card the default raises.

Reset semantics mirror runCuda (main.cpp:154-209): a camera change resets
the accumulation frame counter only when denoising is OFF; frame == 0
forces a full tracer + denoiser state reset.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ptdn_tpu_torch.engine.step import make_frame_step
from ptdn_tpu_torch.ops.camera import OrbitCamera, view_matrix
from ptdn_tpu_torch.utils.config import RenderConfig


class Renderer:
    def __init__(self, scene, cfg: Optional[RenderConfig] = None,
                 resolution: Optional[Tuple[int, int]] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda') needs a CUDA device")
        self.scene = scene
        self.cfg = cfg or RenderConfig()
        self.resolution = tuple(resolution or scene.resolution)
        self.camera = OrbitCamera(scene.camera, resolution=self.resolution)
        self._cam = None
        self.cam_changed = True
        self._build()
        self.reset_state()

    def _build(self):
        self.step = make_frame_step(self.scene, self.cfg, self.resolution,
                                    self.device)
        self._params = self.cfg.traced_params()

    def set_config(self, cfg: RenderConfig):
        """Swap the config. A structural change (static_key) rebuilds the
        frame step and resets the state; a continuous one only changes
        the step's parameters."""
        rebuild = cfg.static_key() != self.cfg.static_key()
        self.cfg = cfg
        self._params = cfg.traced_params()
        if rebuild:
            self._build()
            self.reset_state()

    def reset_state(self):
        """pathtraceFree/Init + denoiseFree/Init (main.cpp:194-201)."""
        self.step.reset()
        self.frame = 0

    def render_frame(self):
        """Render one frame; returns (left, right) (H, W, 3) tensors on
        the device: left = raw/accumulated, right = denoised."""
        changed = self.cam_changed
        if changed:
            if not self.cfg.denoise_enable:
                self.frame = 0
            self.cam_changed = False
            self._cam = None
        if self.frame == 0:
            self.reset_state()
            changed = True      # fresh state: the primary cache is invalid
        if self._cam is None:
            fc = self.camera.frame()
            self._cam = (fc.as_tensors(self.device),
                         torch.from_numpy(view_matrix(fc)).to(self.device))
        cam, vm = self._cam
        with torch.no_grad():
            left, right = self.step(cam, vm, self._params, self.frame,
                                    changed)
        self.frame += 1
        return left, right

    def render(self, n_frames: int):
        """Render n frames; returns the final (left, right) as numpy."""
        left = right = None
        for _ in range(n_frames):
            left, right = self.render_frame()
        return left.cpu().numpy(), right.cpu().numpy()

    # -- interactive-style camera controls (main.cpp:231-304 semantics) --
    def orbit(self, dphi: float = 0.0, dtheta: float = 0.0):
        self.camera.phi += dphi
        self.camera.theta = float(np.clip(self.camera.theta + dtheta,
                                          0.001, np.pi))
        self.cam_changed = True

    def dolly(self, dzoom: float):
        self.camera.zoom = max(0.1, self.camera.zoom + dzoom)
        self.cam_changed = True

    def pan(self, delta):
        self.camera.look_at = self.camera.look_at + np.asarray(
            delta, np.float32)
        self.cam_changed = True

    def reset_camera(self):
        self.camera.reset()
        self.cam_changed = True
