"""One run of one cell: the program's renderer built on the card, warmed
up, a window of frames rendered back to back, optionally traced, then
checked against the plain reference.

Everything a cell is made of is found by name: the cell and its metrics
in BENCHMARK.json, the configuration in the file BENCHMARK.json names
(configs/<name>.json), the traffic in traffic/<name>.json (read by
camera_path.py), each metric's reader in metrics/<name>.py and the
check's limits in limits/<cell>.json. A new cell, configuration, traffic
mix or metric is new files and entries, never an edit.

From the program (ptdn_tpu_torch) the harness takes the system under
test alone: its Scene, RenderConfig and Renderer, the renderer's camera
and frame counter, render_frame, the frame step's state
(FrameStep.frame_state) and, to hang spans on, the frame step and its
tracer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import camera_path, check
from perfbench.reference.frame import (HISTORY_KEYS, ReferenceFrame, Settings,
                                       identity)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the modules that no process of the benchmark may hold (compared by
# their top-level name, whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "ptdn_tpu")
# the longest traced window: a trace of every frame of a long window
# takes minutes to write and read
TRACE_SECONDS = 4.0


def manifest(root: pathlib.Path = REPO) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries, name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, root: pathlib.Path = REPO):
    """The `read` function of the metric's file, perfbench/metrics/
    <name>.py under `root`."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic, limits
    and metrics, all found by name."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    root: pathlib.Path = REPO

    @classmethod
    def load(cls, name: str, root: pathlib.Path = REPO) -> "Cell":
        """The cell `name` of root/BENCHMARK.json, its files found by name
        under root/perfbench."""
        man = manifest(root)
        w = by_name(man["workloads"], name, "workload")
        c = by_name(man["configs"], w["config"], "config")
        bench = root / "perfbench"

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]
        return cls(name=name, chips=int(w["chips"]),
                   config=load_json(root / c["file"]),
                   traffic=camera_path.load(
                       bench / "traffic" / f"{w['traffic']}.json"),
                   limits=load_json(bench / "limits" / f"{name}.json"),
                   end_to_end=mine(man["end_to_end"]),
                   per_layer=mine(man["per_layer"]), root=root)

    @property
    def resolution(self):
        return tuple(int(x) for x in self.config["RES"])

    def settings(self) -> Dict:
        s = dict(self.config["settings"])
        if s.pop("spp") != 1 or not s.pop("denoise_enable"):
            raise ValueError("the renderer draws 1 spp with its denoiser on")
        return s


class Program:
    """The system under test: ptdn_tpu_torch's Renderer on `device`."""

    def __init__(self, cell: Cell, device, resolution=None):
        from ptdn_tpu_torch.engine import Renderer
        from ptdn_tpu_torch.scene import Scene
        from ptdn_tpu_torch.utils.config import RenderConfig

        cfg = RenderConfig(denoise_enable=True, **cell.settings())
        self.device = torch.device(device)
        self.renderer = Renderer(Scene(str(cell.root / cell.config["scene"])),
                                 cfg, resolution or cell.resolution,
                                 device=device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def set_pose(self, pose: Optional[Dict]):
        if pose is None:
            return
        cam = self.renderer.camera
        cam.look_at = np.asarray(pose["look_at"], np.float32)
        cam.theta, cam.phi = float(pose["theta"]), float(pose["phi"])
        self.renderer.cam_changed = True

    def history(self) -> Dict[str, torch.Tensor]:
        st = self.renderer.step.frame_state()
        return {k: st[k].clone() for k in HISTORY_KEYS}

    def produced(self, left, right) -> Dict[str, torch.Tensor]:
        """What the frame just rendered produced: its images and the
        state it left."""
        st = self.renderer.step.frame_state()
        out = {k: st[k].clone() for k in HISTORY_KEYS}
        out.update(position=st["prev_position"].clone(),
                   normal=st["prev_normal"].clone(),
                   geom_id=st["prev_geom_id"].clone(),
                   left=left.clone(), right=right.clone())
        return out


@dataclasses.dataclass
class Run:
    """A finished run, as the metrics' readers see it."""
    frame_s: List[float]
    window_s: float
    setup_s: float
    pixels: int
    depth: int
    trace: Optional[object] = None
    counts: Optional[Dict] = None


@dataclasses.dataclass
class Played:
    """What a seed's warm-up and window gave: the frames the check
    compares, each window frame's seconds, the window's seconds, the
    trace's events (with the trace on) and the seconds of set-up."""
    samples: List[check.Sample]
    frame_s: List[float]
    window_s: float
    events: List
    setup_s: float


def play(prog: Program, cell: Cell, seed: int, seconds: float,
         trace: bool, t0: float, scratch_dir=None,
         log=lambda s: None) -> Played:
    """From the renderer's reset: the warm-up, whose first frame (the
    reset) the check compares, then the window of `seconds` (traced:
    at most TRACE_SECONDS) from the seed's first frame index."""
    draw = camera_path.Draw(seed, cell.traffic,
                            int(cell.config["check_frames"]))
    path = camera_path.CameraPath(cell.traffic, draw.phase)
    r = prog.renderer
    warm = int(cell.traffic["warmup_frames"])
    r.frame = 0
    samples: List[check.Sample] = []
    for i in range(warm):
        pose = path.pose(i)
        prog.set_pose(pose)
        left, right = r.render_frame()
        if i == 0:
            samples.append(check.Sample(0, pose, None, None,
                                        prog.produced(left, right)))
    del left, right
    prog.sync()
    r.frame = draw.first_frame
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s, window from frame {draw.first_frame}, "
        f"loop phase {draw.phase}")
    window = min(seconds, TRACE_SECONDS) if trace else seconds
    with _traced(trace, r, scratch_dir) as events:
        frame_s, window_s = _window(prog, path, warm, window, draw,
                                    samples, trace)
    return Played(samples, frame_s, window_s, events, setup_s)


def reference(cell: Cell, resolution, device, store=identity):
    """The plain reference of the cell's frames (reference/frame.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ReferenceFrame(str(cell.root / cell.config["scene"]),
                          Settings(**cell.settings()), resolution, device,
                          store)


def compared(cell: Cell, samples, ref, log=lambda s: None):
    """check.compare of the samples against `ref`, with the work of
    kernel B1 that the reference counted on the first window frame."""
    from perfbench.reference.intersect import light_visible, mesh_best

    counts = {"shade": 0, "nee": 0, "next": 0}
    mesh_best.tri_tests = light_visible.tri_tests = 0
    t = time.perf_counter()
    result = check.compare(samples, ref, counts)
    counts["tri_tests"] = mesh_best.tri_tests + light_visible.tri_tests
    counts["n_analytic"] = sum(1 for g in ref.scene.geom_types if g != 2)
    log(f"check {time.perf_counter() - t:.3f} s over {len(samples)} "
        f"frames: {result['frames']}")
    return result, (counts if counts["shade"] else None)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", resolution=None, scratch_dir=None,
        log=lambda s: None) -> Dict:
    """One run of `cell`; returns the result line's object. `t0` is the
    process's start on time.perf_counter's clock; `resolution` replaces
    the configuration's (tests on the CPU only)."""
    prog = Program(cell, device, resolution)
    res = prog.renderer.resolution
    p = play(prog, cell, seed, seconds, trace, t0, scratch_dir, log)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run's process holds {bad}")
    peak = (torch.cuda.max_memory_allocated(prog.device)
            if prog.device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(prog.device)
            if prog.device.type == "cuda" else "cpu")
    del prog
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    tr = None
    if trace:
        from perfbench.trace import summarize
        tr = summarize(p.events, len(p.frame_s))
        p.events.clear()

    # the check, after the window, the peak read and the program freed
    result, counts = compared(cell, p.samples,
                              reference(cell, res, device), log)
    worst = result["worst"]
    want = 1 + int(cell.config["check_frames"])
    correct = check.verdict(worst, cell.limits, len(p.samples) == want)

    rec = Run(frame_s=p.frame_s, window_s=p.window_s, setup_s=p.setup_s,
              pixels=res[0] * res[1],
              depth=int(cell.settings()["trace_depth"]), trace=tr,
              counts=counts)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": bool(correct), "attempted": len(p.frame_s),
           "failed": sum(1 for f in result["frames"]
                         if not check.verdict(f, cell.limits, True)),
           "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["check"] = {k: {"value": worst[k], "limit": cell.limits[k]}
                    for k in check.NUMBERS}
    out["check"]["frames_compared"] = {"value": len(p.samples),
                                       "limit": want}
    return out


def _traced(trace: bool, renderer, scratch_dir):
    """The profiler with the spans on, or nothing."""
    if not trace:
        return contextlib.nullcontext([])
    from perfbench.trace import traced
    return traced(renderer, scratch_dir)


def _window(prog: Program, path, warm: int, seconds: float, draw,
            samples: List[check.Sample], trace: bool):
    """Frames back to back for `seconds`, each ended by a synchronize;
    at the draw's shares of the window, a frame the check compares.
    Returns (each frame's seconds, the window's seconds)."""
    if trace:
        from torch.profiler import record_function
    else:
        def record_function(name):
            return contextlib.nullcontext()
    r = prog.renderer
    frame_s: List[float] = []
    want = list(draw.sample_at)
    with record_function("perfbench.window"):
        start = time.perf_counter()
        end = start + seconds
        k = 0
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            take = bool(want) and now - start >= want[0] * seconds
            if take:
                want.pop(0)
                history, index = prog.history(), r.frame
            pose = path.pose(warm + k)
            prog.set_pose(pose)
            t1 = time.perf_counter()
            with record_function("perfbench.frame"):
                left, right = r.render_frame()
            with record_function("perfbench.sync"):
                prog.sync()
            frame_s.append(time.perf_counter() - t1)
            if take:
                samples.append(check.Sample(index, pose,
                                            path.pose(warm + k - 1),
                                            history,
                                            prog.produced(left, right)))
            k += 1
        window_s = time.perf_counter() - start
    return frame_s, window_s
