"""Where a frame's time goes on the card: the device's busy and idle
share, the kernels by device time, and the frame's stages as the
program's own spans give them.

    python3 -m ptdn_tpu_torch.profile_frame [scene[,scene...]]
        [--frames N] [--engine sorted|whole_path|bounce_fused|bounce_split
        [,...]|all] [--res WxH] [--moving anim_slow|room_1080p]
        [--shards N]

Renders `scene` (default diamond; several joined by commas, each in
turn, through each engine named) at its own resolution (or WxH) with
the headline settings of bench.py (1 spp, depth 8, static camera,
temporal SVGF with 5 à-trous levels) through the engine the scene takes
by default or the one named, with `--moving` a camera that
CameraAutomation moves every frame at the speeds of
tests/test_golden.py's cornell_svgf_anim_slow or of bench.py's
room_1080p_animated, and with `--shards N` split into N row shards in
one process (parallel/sharded.py:ShardedRenderer over an
InProcessGroup, the shards one after another), warms up, then runs N
frames (default 10) under torch.profiler, each ended by a synchronize,
and prints per frame (the span lines only without --shards: shards in
lock step leave their spans open across each other's launches, so no
launch can be put to a stage):

* the wall ms, the device's busy ms and idle share, and the kernels
  launched;
* for each of the program's spans (utils/stats.py: span) that opened,
  the device ms and the kernels launched inside it and the idle ms in
  the gaps that began inside it (perfbench/work/stages.py);
* the idle ms by the innermost span open as each gap began, and the
  blocking runtime calls inside a frame by call and span;
* the kernels by device time.

Every number names the card it ran on. Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import Counter
from typing import Dict, List

import torch

from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.config import RenderConfig

# the flags that select each engine on every scene
ENGINES = {"sorted": dict(sort_rays=True),
           "whole_path": dict(sort_rays=False),
           "bounce_fused": dict(fuse_path=False, sort_rays=False),
           "bounce_split": dict(fuse_path=False, fuse_bounce=False)}
# the camera speeds of --moving
MOVING = {"anim_slow": dict(camera_speed_theta=0.4, camera_speed_phi=0.08),
          "room_1080p": dict(camera_speed_x=0.02, camera_speed_theta=0.01,
                             camera_speed_phi=0.015)}
# the profiled window's own span
WINDOW = "profile_frame.window"


def chrome_events(prof) -> List[Dict]:
    """The events of a finished profiler's chrome trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def profiled(r, frames: int, program: bool = True):
    """(the program's stages over `frames` frames under torch.profiler,
    each frame ended by a synchronize as a viewer's is (perfbench/work/
    stages.py; the program's spans unread unless `program`), wall ms per
    frame)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.work import stages

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(frames):
                r.render_frame()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / frames
    events = chrome_events(prof)
    w = next(e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation")
    lo = float(w["ts"])
    return stages.read(events, lo, lo + float(w["dur"]), frames,
                       program), wall


def report(st, wall: float, tag: str):
    """Print what the window `st` (stages.Stages) of wall ms a frame
    held, each line ending in `tag`."""
    busy = st.busy_s * 1e3 / st.frames
    print(f"profile: wall {wall:.3f} ms/frame, device busy {busy:.3f} "
          f"ms/frame, idle share {1 - st.busy_s / st.window_s:.3f}, "
          f"{len(st.kernels) / st.frames:.1f} kernels/frame {tag}")
    if not st.opened:
        print(f"stages: no span read {tag}")
    for span in sorted(st.opened):
        print(f"stage {span}: {st.kernel_ms(span):.3f} device ms/frame, "
              f"{st.launches(span):.1f} kernels/frame, idle "
              f"{st.idle_ms(span):.3f} ms/frame {tag}")
    if st.opened:
        print(f"idle by stage (ms/frame): "
              f"{json.dumps(st.idle_by_stage())} {tag}")
        print(f"host syncs: {st.syncs_per_frame()}/frame "
              f"{json.dumps(st.syncs_by_stage())} {tag}")
    by = Counter()
    for name, sec, _ in st.kernels:
        by[name] += sec * 1e3 / st.frames
    for name, ms in by.most_common(25):
        print(f"kernel {ms:8.3f} ms/frame  {name[:110]}")


def profile_one(scene: str, engine, a, card: str):
    """Print the profile of `scene` through `engine` (None: the scene's
    own)."""
    sc = Scene(scene_path(scene))
    res = (tuple(int(x) for x in a.res.split("x")) if a.res
           else sc.resolution)
    cfg = RenderConfig(trace_depth=8, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=5, automate_camera=bool(a.moving),
                       **MOVING.get(a.moving, {}),
                       **ENGINES.get(engine, {}))
    if a.shards:
        from ptdn_tpu_torch.parallel.mesh import InProcessGroup
        from ptdn_tpu_torch.parallel.sharded import ShardedRenderer
        r = ShardedRenderer(sc, cfg, res, InProcessGroup(a.shards),
                            device="cuda")
        tracer = r.step.steps[0].tracer
    else:
        r = Renderer(sc, cfg, resolution=res, device="cuda")
        tracer = r.step.tracer
    if a.moving:
        auto, still_frame = CameraAutomation(cfg), r.render_frame

        def moving_frame():
            if auto.step(r.camera):
                r.cam_changed = True
            return still_frame()
        r.render_frame = moving_frame
    for _ in range(5):
        r.render_frame()
    tag = (f"{scene} {res[0]}x{res[1]}, {tracer.engine}"
           f"{', moving ' + a.moving if a.moving else ''}"
           f"{f', {a.shards} shards' if a.shards else ''}, [{card}]")
    report(*profiled(r, a.frames, program=not a.shards), tag)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="diamond",
                    help="a scene, or several joined by commas")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--engine",
                    help="the tracer engine (default: the scene's), "
                    "several joined by commas, or all: "
                    + ", ".join(sorted(ENGINES)))
    ap.add_argument("--res", help="WxH (default: the scene's)")
    ap.add_argument("--moving", choices=sorted(MOVING),
                    help="move the camera every frame at these speeds")
    ap.add_argument("--shards", type=int, default=0,
                    help="split the image into this many row shards")
    a = ap.parse_args()
    engines = ([None] if not a.engine else sorted(ENGINES)
               if a.engine == "all" else a.engine.split(","))
    for e in engines:
        if e is not None and e not in ENGINES:
            ap.error(f"unknown engine {e}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for scene in a.scene.split(","):
        for engine in engines:
            profile_one(scene, engine, a, card)


if __name__ == "__main__":
    main()
