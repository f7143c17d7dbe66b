"""Carry the JAX package's arrays into the port: a DeviceScene or a
frame state given as numpy arrays (``np.asarray`` of each field) becomes
torch tensors with the same keys, layouts and values, so both packages
can run on identical scene tensors and identical mid-sequence history.
Nothing here imports jax; the caller converts."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ptdn_tpu_torch.scene.scene import DeviceScene


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def device_scene_from_numpy(arrays: Dict[str, np.ndarray],
                            device="cpu") -> DeviceScene:
    return DeviceScene(**{f.name: _tensor(arrays[f.name], device)
                          for f in dataclasses.fields(DeviceScene)})


def frame_state_from_numpy(arrays: Dict[str, np.ndarray],
                           device="cpu") -> Dict[str, torch.Tensor]:
    return {k: _tensor(v, device) for k, v in arrays.items()}
