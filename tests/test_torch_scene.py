"""The port's host scene layer against the JAX package's: every
DeviceScene field, and that importing the port never imports jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu_torch import interop
from ptdn_tpu_torch.scene import DeviceScene, Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_arrays(jds):
    return {f.name: np.asarray(getattr(jds, f.name))
            for f in dataclasses.fields(jds)}


@pytest.mark.parametrize("name", ["cornell", "diamond", "room", "bunny",
                                  "terrain30k"])
def test_device_scene_equals_jax(scenes_dir, name):
    """Host code is NumPy on both sides: every field must be equal in
    shape, dtype and value, bit for bit."""
    path = str(scenes_dir / f"{name}.txt")
    ref = _jax_arrays(JScene(path).device())
    ds = Scene(path).device("cpu")
    assert ({f.name for f in dataclasses.fields(DeviceScene)}
            == set(ref))
    for k, v in ref.items():
        got = getattr(ds, k).numpy()
        assert got.dtype == v.dtype, k
        assert got.shape == v.shape, k
        assert np.array_equal(got, v), k


def test_interop_roundtrip(scenes_dir):
    ref = _jax_arrays(JScene(str(scenes_dir / "cornell.txt")).device())
    ds = interop.device_scene_from_numpy(ref, device="cpu")
    for k, v in ref.items():
        assert np.array_equal(getattr(ds, k).numpy(), v), k
    st = interop.frame_state_from_numpy(
        {"history_length": np.arange(6, dtype=np.int32).reshape(2, 3)},
        device="cpu")
    assert st["history_length"].dtype == torch.int32


def test_interop_defaults_to_the_card(scenes_dir, monkeypatch):
    """Both interop functions run on the card unless asked for the CPU:
    without a card the default raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = _jax_arrays(JScene(str(scenes_dir / "cornell.txt")).device())
    with pytest.raises(RuntimeError, match="CUDA device"):
        interop.device_scene_from_numpy(ref)
    with pytest.raises(RuntimeError, match="CUDA device"):
        interop.frame_state_from_numpy(
            {"history_length": np.zeros((2, 3), np.int32)})


def test_scene_device_is_cached_per_device(scenes_dir):
    s = Scene(str(scenes_dir / "cornell.txt"))
    assert s.device("cpu") is s.device(torch.device("cpu"))


def test_import_leaves_jax_out():
    code = ("import sys; import ptdn_tpu_torch, ptdn_tpu_torch.engine, "
            "ptdn_tpu_torch.ops.cuda.path, ptdn_tpu_torch.interop; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"
