"""Structured per-frame observability: a FrameStats record per frame (ms,
rays/s, SVGF history-rejection rate, mean variance, accumulated frame
index), as the JAX package's ptdn_tpu/utils/stats.py, and a
torch.profiler trace context for deep dives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class FrameStats:
    frame: int
    ms: float
    rays_per_s: float
    accum_frame: int
    history_rejection_rate: Optional[float] = None
    mean_variance: Optional[float] = None

    def json(self) -> str:
        return json.dumps({k: v for k, v in dataclasses.asdict(self).items()
                           if v is not None})


def sync(device: torch.device):
    """Wait for the device's queued work (the CPU's is done on return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StatsCollector:
    """Wraps a Renderer; collects per-frame stats. Each frame ends in a
    device sync, so don't use while benchmarking throughput."""

    def __init__(self, renderer, collect_denoiser_stats: bool = False):
        self.r = renderer
        self.collect_denoiser = collect_denoiser_stats
        self.frames = []

    def render_frame(self):
        t0 = time.perf_counter()
        left, right = self.r.render_frame()
        sync(self.r.device)
        dt = time.perf_counter() - t0
        w, h = self.r.resolution
        st = FrameStats(frame=len(self.frames), ms=dt * 1000,
                        rays_per_s=w * h / dt,
                        accum_frame=self.r.frame - 1)
        state = self.r.step.frame_state()
        if self.collect_denoiser and "history_length" in state:
            hist = state["history_length"].cpu().numpy()
            st.history_rejection_rate = float((hist <= 1).mean())
            mom = state["moment_history"].cpu().numpy()
            st.mean_variance = float(
                np.maximum(mom[..., 1] - mom[..., 0] ** 2, 0).mean())
        self.frames.append(st)
        return left, right


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler over the block (the card's kernels too where there
    is one), its Chrome trace written to <logdir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
