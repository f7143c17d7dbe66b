"""Camera automation (runCuda, reference src/main.cpp:156-169):
sinusoidal look-at + orbit sweeps driven by per-axis speed settings.
A copy of the JAX package's ptdn_tpu/app/automate.py, which the port may
not import (importing ptdn_tpu imports jax)."""

from __future__ import annotations

import math


class CameraAutomation:
    def __init__(self, cfg):
        self.tx = self.ty = self.tz = 0.0
        self.ttheta = self.tphi = 0.0
        self.cfg = cfg

    def step(self, camera) -> bool:
        """Advance one frame; mutates the OrbitCamera. Returns True if the
        camera changed (main.cpp:156-169 constants)."""
        cfg = self.cfg
        if not cfg.automate_camera:
            return False
        self.tx += cfg.camera_speed_x
        self.ty += cfg.camera_speed_y
        self.tz += cfg.camera_speed_z
        self.ttheta += cfg.camera_speed_theta
        self.tphi += cfg.camera_speed_phi
        camera.look_at[0] = 0.0 + 2.0 * math.sin(self.tx)
        camera.look_at[1] = 5.0 + 1.0 * math.sin(self.ty)
        camera.look_at[2] = 0.0 + 1.5 * math.sin(self.tz)
        camera.theta = math.pi * 0.5 + math.pi / 18 * math.sin(self.ttheta)
        camera.phi = math.pi * 0.0 + math.pi / 12 * math.sin(self.tphi)
        return True
