"""Camera model: orbit state, ray generation, view matrices.

Replicates the reference's camera pipeline:
* fov/pixelLength derivation (scene.cpp:158-166) — tan(fovy_degrees *
  pi/180) with NO half-angle, so FOVY 45 means a 90-degree vertical
  frustum; replicated as-is;
* resetCamera's orbit decomposition into (zoom, theta, phi) around the
  look-at point (main.cpp:77-101) — acos() drops the sign of the view's
  x component, replicated;
* the camchanged basis rebuild (main.cpp:171-190) — `right`/`up` are NOT
  normalized there, which slightly widens the frustum off-axis; replicated;
* pinhole ray generation through pixel centers (pathtrace.cu:187-208);
* GetViewMatrix (denoise.cu:342-347) for temporal reprojection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ptdn_tpu_torch.ops.fp import fma, sqrt

F = np.float32


def derive_pixel_length(resolution: Tuple[int, int], fovy_deg: float):
    """scene.cpp:158-166 (keeps the missing /2 quirk)."""
    w, h = resolution
    yscaled = math.tan(fovy_deg * (math.pi / 180.0))
    xscaled = (yscaled * w) / h
    fovx = math.degrees(math.atan(xscaled))
    return (np.array([2 * xscaled / w, 2 * yscaled / h], F),
            np.array([fovx, fovy_deg], F))


@dataclasses.dataclass
class CameraFrame:
    """One frame's camera basis."""
    position: np.ndarray      # (3,)
    view: np.ndarray          # (3,)
    up: np.ndarray            # (3,) unnormalized (main.cpp:183 quirk)
    right: np.ndarray         # (3,) unnormalized
    look_at: np.ndarray       # (3,)
    pixel_length: np.ndarray  # (2,)

    def as_tensors(self, device) -> Dict[str, torch.Tensor]:
        return {k: torch.tensor(np.asarray(getattr(self, k), F),
                                device=device)
                for k in ("position", "view", "up", "right",
                          "pixel_length")}


class OrbitCamera:
    """Interactive orbit camera state (zoom/theta/phi around look_at)."""

    def __init__(self, camera_spec, resolution=None):
        spec = camera_spec
        self.resolution = tuple(resolution or spec.resolution)
        self.pixel_length, self.fov = derive_pixel_length(self.resolution,
                                                          spec.fovy)
        self.look_at = np.array(spec.look_at, F)
        self.og_look_at = self.look_at.copy()
        self._default_eye = np.array(spec.eye, F)
        self._default_up = np.array(spec.up, F)
        self.reset()

    def reset(self):
        """resetCamera (main.cpp:77-101): derive zoom/theta/phi from the
        scene's EYE/LOOKAT; acos() loses the horizontal sign (quirk)."""
        eye = self._default_eye
        look = self.og_look_at
        view = look - eye
        view = view / np.linalg.norm(view)
        view_xz = np.array([view[0], 0.0, view[2]], F)
        view_zy = np.array([0.0, view[1], view[2]], F)
        nxz = np.linalg.norm(view_xz)
        nzy = np.linalg.norm(view_zy)
        self.phi = float(np.arccos(np.clip(
            np.dot(view_xz / (nxz if nxz else 1.0), [0, 0, -1]), -1, 1)))
        self.theta = float(np.arccos(np.clip(
            np.dot(view_zy / (nzy if nzy else 1.0), [0, 1, 0]), -1, 1)))
        self.look_at = self.og_look_at.copy()
        self.zoom = float(np.linalg.norm(eye - look))

    def frame(self) -> CameraFrame:
        """The camchanged basis rebuild (main.cpp:171-190)."""
        st, ct = math.sin(self.theta), math.cos(self.theta)
        sp, cp = math.sin(self.phi), math.cos(self.phi)
        pos = self.zoom * np.array([sp * st, ct, cp * st], F)
        view = -pos / np.linalg.norm(pos)
        u = np.array([0, 1, 0], F)
        r = np.cross(view, u)          # NOT normalized (quirk)
        up = np.cross(r, view)         # NOT normalized (quirk)
        position = pos + self.look_at
        return CameraFrame(position=position.astype(F), view=view.astype(F),
                           up=up.astype(F), right=r.astype(F),
                           look_at=self.look_at.copy(),
                           pixel_length=self.pixel_length)


def generate_camera_rays(cam: Dict[str, torch.Tensor],
                         resolution: Tuple[int, int], row0: int = 0,
                         full_height: Optional[int] = None):
    """generateRayFromCamera (pathtrace.cu:187-208), flattened to (N, 3)
    in index = x + y*W order, on the device of the camera tensors. A
    shard of a taller image (parallel/sharded.py) makes its rows only:
    `row0` offsets the pixel rows and the pixel grid is centred on
    `full_height` (ptdn_tpu/ops/camera.py:106-125)."""
    w, h = resolution
    hc = h if full_height is None else full_height
    dev = cam["view"].device
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + row0
    plx, ply = cam["pixel_length"][0], cam["pixel_length"][1]
    dx = (x - (w * 0.5 - 0.5)) * plx
    dy = (y - (hc * 0.5 - 0.5)) * ply
    d = fma(-cam["up"][None, None, :], dy[..., None],
            fma(-cam["right"][None, None, :], dx[..., None],
                cam["view"][None, None, :]))
    # the norm is a reduction: x*x first, then fused y and z terms
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    d = d / sqrt(fma(z, z, fma(y, y, x * x)))[..., None]
    o = cam["position"].expand(d.shape)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def view_matrix(frame: CameraFrame) -> np.ndarray:
    """GetViewMatrix (denoise.cu:342-347): inverse of the camera basis
    matrix whose COLUMNS are (right, up, view, position)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = np.asarray(frame.right)
    m[:3, 1] = np.asarray(frame.up)
    m[:3, 2] = np.asarray(frame.view)
    m[:3, 3] = np.asarray(frame.position)
    return np.linalg.inv(m).astype(F)
