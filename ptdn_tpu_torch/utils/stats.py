"""Structured per-frame observability: a FrameStats record per frame (ms,
rays/s, SVGF history-rejection rate, mean variance, accumulated frame
index), as the JAX package's ptdn_tpu/utils/stats.py, a
torch.profiler trace context for deep dives, and the spans the frame
path records inside such a trace (span).

The spans, each a torch.profiler.record_function range named `ptdn.*`,
nest as the frame's stages do:

    ptdn.frame (engine/renderer.py: Renderer.render_frame; args: the
      frame index)
      ptdn.step (engine/step.py: FrameStep.frame_gen)
        ptdn.tracer (the step's call of engine/wavefront.py: PathTracer)
          ptdn.tracer.camera     camera rays, kernel A, the albedo and the
                                 G-buffer position of a moved camera
          ptdn.tracer.shade      kernel E (or H) and the cat of its input
          ptdn.tracer.ranges     kernel Q
          ptdn.tracer.permute    the sorts, kernel G, the planes' gather
          ptdn.tracer.bounce     kernel F and the cat of its output
          ptdn.tracer.visibility the split engine's shadow test (I or A)
          ptdn.tracer.next_hit   the next hit (J or A) and its albedo (K)
        ptdn.denoiser (the step's call of denoise/svgf.py: SVGFDenoiser)
          ptdn.denoiser.pack     the G-buffer packed for kernel D
          ptdn.denoiser.motion   the branch choice's reprojection
            ptdn.sync.motion     the host's read of it
          ptdn.denoiser.reproject kernel C, its band mode or L
          ptdn.denoiser.atrous   the à-trous levels (kernel D)

They are on only while a profiler records (perfbench's traced window,
profiler_trace, profile_frame.py); off, a span costs one check. Row
shards of one process (parallel/mesh.py: InProcessGroup) record each
its own, in lock step: a shard's spans stay open while the next shard
runs, so they no longer nest.
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


# the context every span is while no profiler records
_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A record_function range `name` (its args the string of `args`)
    while a profiler records, else a shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(
            name, None if args is None else str(args))
    return _OFF


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
