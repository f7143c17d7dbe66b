"""The program's own spans in a profiler's chrome trace, and what they say
of a window of frames on the device.

The program records `ptdn.*` record_function ranges around its stages
while a profiler runs (ptdn_tpu_torch/utils/stats.py: span; `ptdn.frame`
around each frame). A kernel belongs to the spans open on the host at
its launch (its runtime call, joined to it by the profiler's correlation
id); an idle gap of the device (no kernel, copy or memset running) to the
spans open as it began; a blocking runtime call (BLOCKING) to the spans
open as it began, counted only inside `ptdn.frame`. Gaps outside
`ptdn.frame` are the caller's (`harness`).

That holds while the spans nest, as one frame's do. Row shards driven in
lock step in one process (parallel/mesh.py: InProcessGroup.run) leave a
shard's spans open while the next shard runs, so the spans open at a
launch are not all the launching shard's: read refuses such a trace
(Interleaved), and read(..., program=False) reads the window alone.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict
from typing import Dict, FrozenSet, List, Optional, Tuple

from perfbench.trace import DEVICE_CATS, LAUNCHES
from perfbench.work.intervals import gaps, union
from perfbench.work.kernels import short_name

PREFIX = "ptdn."
FRAME = "ptdn.frame"
OUTSIDE = "harness"
HOST_CATS = ("user_annotation", "cpu_instant_event", "cpu_op", None)
# the runtime calls in which the host waits for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")

Chain = Tuple[str, ...]
# us: the trace's rounding of a span's end
EPS = 1e-3


class Interleaved(ValueError):
    """The program's spans do not nest: no launch can be put to a
    stage."""


@dataclasses.dataclass
class Stages:
    """A window of `frames` frames: its wall and busy seconds, the spans
    that opened in it, every kernel as (short name, seconds, the spans
    open at its launch, outermost first), every idle gap as (seconds,
    the spans open as it began) and every blocking call inside a frame
    as (call, its innermost span)."""
    frames: int
    window_s: float
    busy_s: float
    opened: FrozenSet[str]
    kernels: List[Tuple[str, float, Chain]]
    idle: List[Tuple[float, Chain]]
    syncs: List[Tuple[str, str]]

    def kernel_ms(self, span: str) -> Optional[float]:
        """Device ms a frame of the kernels launched inside `span`; None
        where it never opened."""
        if span not in self.opened or not self.frames:
            return None
        return sum(s for _, s, c in self.kernels if span in c) \
            * 1e3 / self.frames

    def launches(self, span: str) -> Optional[float]:
        """Kernels a frame launched inside `span`."""
        if span not in self.opened or not self.frames:
            return None
        return sum(1 for _, _, c in self.kernels if span in c) / self.frames

    def idle_ms(self, span: str) -> Optional[float]:
        """Device-idle ms a frame in gaps that began inside `span`."""
        if span not in self.opened or not self.frames:
            return None
        return sum(s for s, c in self.idle if span in c) * 1e3 / self.frames

    def idle_by_stage(self) -> Dict[str, float]:
        """Idle ms a frame by the innermost span open as each gap began,
        OUTSIDE for gaps outside a frame."""
        out: Dict[str, float] = defaultdict(float)
        for s, c in self.idle:
            out[c[-1] if FRAME in c else OUTSIDE] += s * 1e3 / self.frames
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def syncs_per_frame(self) -> Optional[float]:
        """Blocking runtime calls a frame inside `ptdn.frame` (0 is a
        value); None where no frame span opened."""
        if FRAME not in self.opened or not self.frames:
            return None
        return len(self.syncs) / self.frames

    def syncs_by_stage(self) -> Dict[str, float]:
        """Blocking calls a frame by call and innermost span."""
        by = Counter(f"{call} in {span}" for call, span in self.syncs)
        return {k: n / self.frames for k, n in by.most_common()}


def _program_spans(events) -> Dict[str, List[Tuple[float, float]]]:
    """name -> sorted [(start, end)] of the program's spans, in us."""
    out = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS and \
                str(e.get("name", "")).startswith(PREFIX):
            ts = float(e["ts"])
            out[e["name"]].append((ts, ts + float(e["dur"])))
    return {k: sorted(v) for k, v in out.items()}


def _check_nested(spans):
    """Raise Interleaved unless every two spans are disjoint or one holds
    the other, and no span holds one of its own name."""
    open_ = []
    for s, e, name in sorted((s, -e, n) for n, iv in spans.items()
                             for s, e in iv):
        e = -e
        while open_ and open_[-1][0] <= s + EPS:
            open_.pop()
        if open_ and e > open_[-1][0] + EPS:
            raise Interleaved(f"{name} at {s} us ends after "
                              f"{open_[-1][1]}, which holds its start")
        if any(n == name for _, n in open_):
            raise Interleaved(f"{name} at {s} us inside another {name}")
        open_.append((e, name))


def _chain(spans, t: Optional[float]) -> Chain:
    """The spans open at t, outermost first."""
    if t is None:
        return ()
    found = []
    for name, iv in spans.items():
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        if i >= 0 and iv[i][0] <= t <= iv[i][1]:
            found.append((iv[i][0], -iv[i][1], name))
    return tuple(name for _, _, name in sorted(found))


def read(events, lo: float, hi: float, frames: int,
         program: bool = True) -> Stages:
    """The Stages of a chrome trace's events over the window [lo, hi]
    (us on the trace's clock) of `frames` frames; with `program` False
    the program's spans unread (no span opened)."""
    spans = _program_spans(events) if program else {}
    _check_nested(spans)
    launch_ts, device, blocking = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name")
        if cat in ("cuda_runtime", "cuda_driver"):
            if name in LAUNCHES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = float(e["ts"])
            elif name in BLOCKING and lo <= float(e["ts"]) <= hi:
                blocking.append((name, float(e["ts"])))
        elif cat in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            if s + d >= lo and s <= hi:
                device.append(e)
    kernels = []
    for e in device:
        if e["cat"] == "kernel":
            corr = (e.get("args") or {}).get("correlation")
            kernels.append((short_name(e["name"]), float(e["dur"]) * 1e-6,
                            _chain(spans, launch_ts.get(corr))))
    merged = union(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in device), lo, hi)
    idle = [((e - s) * 1e-6, _chain(spans, s))
            for s, e in gaps(merged, lo, hi)]
    syncs = []
    for name, t in blocking:
        c = _chain(spans, t)
        if FRAME in c:
            syncs.append((name, c[-1]))
    opened = frozenset(k for k, iv in spans.items()
                       if any(s <= hi and e >= lo for s, e in iv))
    return Stages(frames=frames, window_s=(hi - lo) * 1e-6,
                  busy_s=sum(e - s for s, e in merged) * 1e-6,
                  opened=opened, kernels=kernels, idle=idle, syncs=syncs)
