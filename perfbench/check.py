"""The comparison that decides `correct`: frames of the timed path against
the plain reference (reference/frame.py), and the control.

The benchmark keeps, from the run, the first frame after the renderer's
reset and `check_frames` frames of the window (camera_path.Draw says
when). For each it keeps what the frame produced: the raw radiance
(`left`), the denoised image (`right`), and the state the frame leaves
(the G-buffer it stores as the previous frame's, the color and moment
histories and the history length); for a window frame also the histories
it started from. The reference renders the same frame from the scene
file, the camera, the frame index and those starting histories (a reset
for the first frame), and two numbers compare the layers:

* tracer_off: the share of pixels where the raw radiance or the G-buffer
  (position, normal, geometry id) differs from the reference's;
* denoiser_off: the share of pixels where the denoised image or the
  carried state (color and moment history, history length) differs.

A float differs where |program - reference| > RTOL |reference| + ATOL
(or is NaN on one side only); an integer where it is unequal. Each run
reports the largest share over its compared frames, against the cell's
limits (limits/<cell>.json, set from the readings in PERF.md).

The control (`control_store`) is the reference with every plane that a
stage hands the next (the raw radiance, the G-buffer, the SVGF planes
between levels and the carried history) stored in bfloat16, the nearest
precision below the float32 that the configuration states.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

RTOL = 1e-4
ATOL = 1e-6
TRACER = ("left", "position", "normal", "geom_id")
DENOISER = ("right", "color_history", "moment_history", "history_length")
NUMBERS = ("tracer_off", "denoiser_off")


@dataclasses.dataclass
class Sample:
    """A frame of the run that the check compares: its index, its camera
    and the last frame's (None: the scene's view), the histories it
    started from (None: the reset), and what it produced."""
    index: int
    pose: Optional[Dict]
    prev_pose: Optional[Dict]
    history: Optional[Dict[str, torch.Tensor]]
    out: Dict[str, torch.Tensor]


def control_store(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: the pixels where a differs from the reference b in
    any channel."""
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not b.is_floating_point():
        d = a != b
    else:
        a, b = a.double(), b.double()
        close = (a - b).abs() <= RTOL * b.abs() + ATOL
        d = ~(close | (a.isnan() & b.isnan()))
    return d.reshape(d.shape[:2] + (-1,)).any(dim=-1)


def share(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
          keys) -> float:
    off = None
    for k in keys:
        d = differs(out[k].to(ref[k].device), ref[k])
        off = d if off is None else off | d
    return float(off.float().mean())


def readings(out: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {"tracer_off": share(out, ref, TRACER),
            "denoiser_off": share(out, ref, DENOISER)}


def compare(samples: List[Sample], reference, counts=None) -> Dict:
    """Each sample against `reference` (a ReferenceFrame): the largest
    reading of each number over the samples, and per sample its
    readings. `counts` (path_trace_plain's) is filled on the first window
    frame."""
    per = []
    for i, s in enumerate(samples):
        ref = reference.frame(s.pose, s.prev_pose, s.index, s.history,
                              counts if i == 1 else None)
        per.append(readings(s.out, ref))
        del ref
    worst = {k: max(r[k] for r in per) for k in NUMBERS}
    return {"worst": worst, "frames": per}


def verdict(worst: Dict[str, float], limits: Dict[str, float],
            complete: bool) -> bool:
    return complete and all(worst[k] <= limits[k] for k in NUMBERS)
