"""The general generator of a cell's traffic: the camera of every frame.

A traffic file (traffic/<name>.json) gives the parameters. Without
"axes" the camera stays at the scene's own view. With "axes" each of
look_at_x, look_at_y, look_at_z, theta and phi follows a closed loop of
`loop_frames` frames, center + amplitude * sin(2 pi cycles (phase + i) /
loop_frames) at frame i, the form and amplitudes of the reference app's
camera automation (main.cpp:156-169, ptdn_tpu_torch/app/automate.py);
a whole number of cycles closes the loop. `warmup_frames` frames are
rendered before the window, the shapes and branches the window takes
among them.

The seed draws the loop's start phase, the window's first frame index
(the renderer's random streams follow the pixel and the frame index) and
when, within the window, the frames that the check compares are taken.
It never changes the scene, the resolution or the path of the camera.
"""

from __future__ import annotations

import json
import math
import random
from typing import Dict, Optional

AXES = ("look_at_x", "look_at_y", "look_at_z", "theta", "phi")


def load(path) -> Dict:
    with open(path) as f:
        t = json.load(f)
    if "axes" in t:
        unknown = set(t["axes"]) - set(AXES)
        if unknown:
            raise ValueError(f"{path}: unknown camera axes {sorted(unknown)}")
        if int(t["loop_frames"]) < 1:
            raise ValueError(f"{path}: loop_frames must be positive")
    if int(t["warmup_frames"]) < 3:
        raise ValueError(f"{path}: warm up at least 3 frames (the reset, "
                         f"the moved frame after it, a still one)")
    return t


class Draw:
    """What a seed sets: the loop's start phase, the window's first frame
    index and the share of the window at which each compared frame is
    taken."""

    def __init__(self, seed: int, traffic: Dict, samples: int):
        rng = random.Random(int(seed))
        self.phase = rng.randrange(int(traffic.get("loop_frames", 1)))
        # past the warm-up, below 2**21 (the frame index rides in uint32)
        self.first_frame = int(traffic["warmup_frames"]) + rng.randrange(
            1 << 20)
        self.sample_at = sorted(rng.uniform(0.1, 0.9)
                                for _ in range(samples))


class CameraPath:
    def __init__(self, traffic: Dict, phase: int = 0):
        self.axes = traffic.get("axes")
        self.loop = int(traffic.get("loop_frames", 1))
        self.phase = phase

    def pose(self, i: int) -> Optional[Dict]:
        """The camera of frame i after the start (look_at, theta, phi),
        None for the scene's own view."""
        if not self.axes:
            return None
        v = {}
        for k in AXES:
            a = self.axes.get(k, {"center": 0.0, "amplitude": 0.0,
                                  "cycles": 0})
            v[k] = a["center"] + a["amplitude"] * math.sin(
                2.0 * math.pi * a["cycles"] * (self.phase + i) / self.loop)
        return {"look_at": [v["look_at_x"], v["look_at_y"], v["look_at_z"]],
                "theta": v["theta"], "phi": v["phi"]}
