"""The traced window: spans around the program's layers, recorded from the
benchmark's own code, and what the profiler's trace says of them.

Spans are torch.profiler.record_function ranges: `perfbench.step` around
the frame step (forward hooks on renderer.step, engine/step.py:
FrameStep), `perfbench.tracer` around the path tracer inside it (hooks on
renderer.step.tracer, engine/wavefront.py:PathTracer), and from the
window's loop `perfbench.frame` around render_frame, `perfbench.sync`
around the synchronize that ends a frame and `perfbench.window` around
the whole window. A kernel belongs to the innermost span open on the host
when it was launched (its runtime call, joined to it by the profiler's
correlation id): `tracer`, `step` (inside the step, outside the tracer:
the denoiser and the step's glue) or `outside`.

The device is busy where any kernel, copy or memset runs (the union of
their intervals within the window); the gaps between are idle, each
labelled by the span open on the host as it began: `tracer`, `step`,
`sync` (the host waits for the frame), `frame` (the renderer's own code
around the step) or `harness` (between frames).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

from perfbench.work.intervals import gaps, union
from perfbench.work.kernels import short_name

SPANS = ("perfbench.window", "perfbench.frame", "perfbench.sync",
         "perfbench.step", "perfbench.tracer")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


@dataclasses.dataclass
class Trace:
    """What the traced window held: its frames and wall seconds, the
    seconds the device was busy, every kernel as (short name, seconds,
    span), and the idle gaps as (label, seconds)."""
    frames: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, str]]
    idle: List[Tuple[str, float]]

    def kernel_s(self, span=None, name=None) -> float:
        return sum(s for n, s, sp in self.kernels
                   if (span is None or sp == span)
                   and (name is None or n == name))

    def count(self, name=None) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if name is None or n == name)

    def breakdown(self) -> Dict:
        by = Counter()
        for n, s, _ in self.kernels:
            by[n] += s
        return {"device_ops": [[n, s] for n, s in by.most_common(10)],
                "idle_gaps": [[k, s] for k, s in
                              sorted(self.idle, key=lambda x: -x[1])[:10]]}


class Spans:
    """record_function ranges pushed by forward hooks on the renderer's
    frame step and path tracer."""

    def __init__(self, renderer):
        from torch.profiler import record_function

        self.handles = []
        for name, mod in (("perfbench.step", renderer.step),
                          ("perfbench.tracer", renderer.step.tracer)):
            stack = []

            def enter(m, args, stack=stack, name=name):
                rf = record_function(name)
                rf.__enter__()
                stack.append(rf)

            def leave(m, args, out, stack=stack):
                stack.pop().__exit__(None, None, None)
            self.handles += [mod.register_forward_pre_hook(enter),
                             mod.register_forward_hook(leave)]

    def remove(self):
        for h in self.handles:
            h.remove()


@contextlib.contextmanager
def traced(renderer, scratch_dir):
    """Profile the block with the spans on; yields a list that holds the
    chrome trace's events once the block has closed."""
    from torch.profiler import ProfilerActivity, profile

    spans = Spans(renderer)
    events: List[Dict] = []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield events
    finally:
        spans.remove()
    fd, path = tempfile.mkstemp(suffix=".json", dir=scratch_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events.extend(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def _open_spans(events):
    """name -> sorted [(start, end)] of the host's spans, in us."""
    out = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("name") in SPANS and \
                e.get("cat") in ("user_annotation", "cpu_instant_event",
                                 "cpu_op", None):
            out[e["name"]].append((float(e["ts"]),
                                   float(e["ts"]) + float(e["dur"])))
    return {k: sorted(v) for k, v in out.items()}


def _inside(spans, t) -> bool:
    """Is t inside one of the sorted disjoint `spans`?"""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def summarize(events, frames: int) -> Trace:
    """The Trace of a chrome trace's events over a window of `frames`
    frames."""
    spans = _open_spans(events)
    if not spans.get("perfbench.window"):
        raise RuntimeError("the trace holds no perfbench.window span")
    lo, hi = spans["perfbench.window"][0]
    launch_ts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver") \
                and e.get("name") in LAUNCHES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])

    def span_of(t):
        if t is None:
            return "outside"
        for name, label in (("perfbench.tracer", "tracer"),
                            ("perfbench.step", "step")):
            if _inside(spans.get(name, []), t):
                return label
        return "outside"

    kernels, device = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < lo or s > hi:
            continue
        device.append((s, s + d))
        if e["cat"] == "kernel":
            corr = (e.get("args") or {}).get("correlation")
            kernels.append((short_name(e["name"]), d * 1e-6,
                            span_of(launch_ts.get(corr))))
    merged = union(device, lo, hi)
    busy = sum(e - s for s, e in merged)

    def label(t):
        for name, lab in (("perfbench.tracer", "tracer"),
                          ("perfbench.step", "step"),
                          ("perfbench.sync", "sync"),
                          ("perfbench.frame", "frame")):
            if _inside(spans.get(name, []), t):
                return lab
        return "harness"
    idle = [(label(s), (e - s) * 1e-6) for s, e in gaps(merged, lo, hi)]
    return Trace(frames=frames, window_s=(hi - lo) * 1e-6,
                 busy_s=busy * 1e-6, kernels=kernels, idle=idle)
