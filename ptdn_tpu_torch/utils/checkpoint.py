"""Checkpoint / resume for the frame state, in the JAX package's file
format (ptdn_tpu/utils/checkpoint.py): one .npz holding the frame-state
arrays under the JAX keys and a ``__meta__`` JSON of the frame counter,
the orbit camera and any caller metadata. A checkpoint written by either
package resumes in the other.

The port's frame state is ``renderer.step.frame_state()``, already under
the JAX keys and layouts (engine/step.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ptdn_tpu_torch.interop import frame_state_from_numpy
from ptdn_tpu_torch.utils.image_io import host


def save_state(path: str, state: Dict, frame: int, camera=None,
               meta: Optional[dict] = None) -> str:
    """Serialize a frame state (+ frame counter + orbit camera)."""
    arrays = {k: host(v) for k, v in state.items()}
    payload = {"frame": int(frame)}
    if camera is not None:
        payload["camera"] = {
            "zoom": float(camera.zoom),
            "theta": float(camera.theta),
            "phi": float(camera.phi),
            "look_at": [float(x) for x in camera.look_at],
        }
    if meta:
        payload["meta"] = meta
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(payload), **arrays)
    return path


def load_state(path: str, device="cuda"):
    """Returns (state dict of tensors on `device`, frame,
    camera_dict_or_None)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        payload = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return (frame_state_from_numpy(arrays, device), payload["frame"],
            payload.get("camera"))


def restore_renderer(renderer, path: str) -> None:
    """Resume a Renderer in place (state + frame + camera orbit)."""
    state, frame, cam = load_state(path, renderer.device)
    renderer.step.load_frame_state(state)
    renderer.frame = frame
    renderer.cam_changed = False
    if cam is not None:
        renderer.camera.zoom = cam["zoom"]
        renderer.camera.theta = cam["theta"]
        renderer.camera.phi = cam["phi"]
        renderer.camera.look_at = np.asarray(cam["look_at"], np.float32)
    renderer._cam = None    # the camera tensors, remade from the orbit
