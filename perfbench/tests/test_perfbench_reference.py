"""The plain reference against the program's CPU path (its plain
versions), at 64x64 over a few frames of both scenes, still and moving:
equal bit for bit, as the chip's runs found the card's kernels."""

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.reference.frame import HISTORY_KEYS, ReferenceFrame, Settings

POSES = [None, None, {"look_at": [0.3, 5.0, 0.0], "theta": 1.6, "phi": 0.1},
         {"look_at": [0.5, 5.0, 0.0], "theta": 1.62, "phi": 0.13}]


@pytest.mark.parametrize("cell", ["cornell_800.still", "room_1080.still"])
def test_reference_equals_the_programs_cpu_path(cell):
    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.scene import Scene
    from ptdn_tpu_torch.utils.config import RenderConfig

    c = harness.Cell.load(cell)
    res = (64, 64)
    scene = str(harness.REPO / c.config["scene"])
    r = Renderer(Scene(scene), RenderConfig(denoise_enable=True,
                                            **c.settings()), res,
                 device="cpu")
    ref = ReferenceFrame(scene, Settings(**c.settings()), res, "cpu")
    history, prev = None, None
    for i, pose in enumerate(POSES):
        if pose is not None:
            r.camera.look_at = np.asarray(pose["look_at"], np.float32)
            r.camera.theta, r.camera.phi = pose["theta"], pose["phi"]
            r.cam_changed = True
        index = r.frame
        left, right = r.render_frame()
        st = r.step.frame_state()
        want = ref.frame(pose, prev, index, history)
        got = dict(left=left, right=right, position=st["prev_position"],
                   normal=st["prev_normal"], geom_id=st["prev_geom_id"],
                   **{k: st[k] for k in HISTORY_KEYS})
        for k, v in want.items():
            assert torch.equal(got[k], v), (cell, i, k)
        assert check.readings(got, want) == {"tracer_off": 0.0,
                                             "denoiser_off": 0.0}
        history = {k: st[k].clone() for k in HISTORY_KEYS}
        prev = pose
        if i == 1:
            r.frame = 4321      # the window's jump to the seed's frame
