"""Carry the JAX package's arrays into the port: a DeviceScene or a
frame state given as numpy arrays (``np.asarray`` of each field) becomes
torch tensors with the same keys, layouts and values, so both packages
can run on identical scene tensors and identical mid-sequence history.
Nothing here imports jax; the caller converts. The tensors go to the card
unless the caller names another device (``device="cpu"``); without a
card the default raises, as ``Renderer``'s does."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ptdn_tpu_torch.scene.scene import DeviceScene


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("interop to device='cuda' needs a CUDA device")
    return device


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def device_scene_from_numpy(arrays: Dict[str, np.ndarray],
                            device="cuda") -> DeviceScene:
    device = _device(device)
    return DeviceScene(**{f.name: _tensor(arrays[f.name], device)
                          for f in dataclasses.fields(DeviceScene)})


def frame_state_from_numpy(arrays: Dict[str, np.ndarray],
                           device="cuda") -> Dict[str, torch.Tensor]:
    device = _device(device)
    return {k: _tensor(v, device) for k, v in arrays.items()}
