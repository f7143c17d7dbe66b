"""Where a frame's time goes on the card: the device's busy and idle
share, the kernels by device time, the per-bounce engines' stages, and
the per-frame glue's correctly rounded multiply-adds.

    python3 -m ptdn_tpu_torch.profile_frame [scene[,scene...]]
        [--frames N] [--engine sorted|whole_path|bounce_fused|bounce_split
        [,...]|all] [--res WxH] [--moving anim_slow|room_1080p]
        [--fma-sites] [--shards N]

Renders `scene` (default diamond; several joined by commas, each in
turn, through each engine named) at its own resolution (or WxH) with
the headline settings of bench.py (1 spp, depth 8, static camera,
temporal SVGF with 5 à-trous levels) through the engine the scene takes
by default or the one named, with `--moving` a camera that
CameraAutomation moves every frame at the speeds of
tests/test_golden.py's cornell_svgf_anim_slow or of bench.py's
room_1080p_animated, and with `--shards N` split into N row shards in
one process (parallel/sharded.py:ShardedRenderer over an
InProcessGroup, the shards one after another), warms up, then over N
frames (default 10):

* CUDA events around each stage of the bounce (the sorted wavefront's
  E, ranges_and_key, permute_planes with G inside it and F; the fused
  per-bounce engine's H, tex_index and K; the split one's E, I, J or A,
  and K): mean ms per frame of each;
* torch.profiler over the same number of frames: device time by kernel,
  the device's busy share of the frame's wall time, and the kernels
  launched per frame;
* with --fma-sites, every call of ops/fp.py's fma (dot3's included) by
  the line of the port that made it: calls, host ms (host clock, no
  profiler) and device kernel launches (torch.profiler) per frame.

Every number names the card it ran on. Needs one card.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch

from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops import fp
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.config import RenderConfig

STAGES = ("shade_bounce", "ranges_and_key", "permute_planes",
          "inrow_permute", "trace_bounce", "bounce_fused", "tex_index",
          "light_visibility", "scene_intersect_full_tex",
          "scene_intersect_full", "sparse_gather")
# the flags that select each engine on every scene
ENGINES = {"sorted": dict(sort_rays=True),
           "whole_path": dict(sort_rays=False),
           "bounce_fused": dict(fuse_path=False, sort_rays=False),
           "bounce_split": dict(fuse_path=False, fuse_bounce=False)}
# the camera speeds of --moving
MOVING = {"anim_slow": dict(camera_speed_theta=0.4, camera_speed_phi=0.08),
          "room_1080p": dict(camera_speed_x=0.02, camera_speed_theta=0.01,
                             camera_speed_phi=0.015)}
PKG = os.path.dirname(os.path.abspath(__file__))


def timed_stages(r, frames: int):
    """Mean device ms per frame of each stage, from CUDA events recorded
    around every call (the events do not synchronize)."""
    events = collections.defaultdict(list)
    real = {k: getattr(W, k) for k in STAGES if hasattr(W, k)}

    def wrap(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return call
    for k, fn in real.items():
        setattr(W, k, wrap(k, fn))
    try:
        for _ in range(frames):
            r.render_frame()
        torch.cuda.synchronize()
    finally:
        for k, fn in real.items():
            setattr(W, k, fn)
    return {k: sum(s.elapsed_time(e) for s, e in events[k]) / frames
            for k in STAGES if events[k]}


def _launches(evt) -> int:
    """Device kernels launched under a profiler event: its kernels and
    its children's, or its runtime launch calls where the profiler
    links no kernel to the operator."""
    kernels = calls = 0
    todo = [evt]
    while todo:
        e = todo.pop()
        kernels += len(getattr(e, "kernels", ()) or ())
        calls += "LaunchKernel" in e.name
        todo.extend(e.cpu_children)
    return max(kernels, calls)


def profiled(r, frames: int):
    """(device ms per frame by kernel name, wall ms per frame, kernels
    launched per frame, profiler events) from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            r.render_frame()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    by_kernel, launched = {}, 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0)
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and us > 0:
            by_kernel[evt.key] = us / 1e3 / frames
            launched += evt.count
    return by_kernel, wall, launched / frames, prof.events()


def _caller() -> str:
    """file:line of the first frame outside ops/fp.py."""
    f = sys._getframe(2)
    while f.f_code.co_filename.endswith(os.path.join("ops", "fp.py")):
        f = f.f_back
    return (f"{os.path.relpath(f.f_code.co_filename, os.path.dirname(PKG))}"
            f":{f.f_lineno}")


def fma_sites(r, frames: int):
    """Per call site of fp.fma: (calls, host ms, launches) per frame.
    Host ms is the host clock around each call in a pass without the
    profiler (the calls queue their kernels and return); the launches
    come from a second pass under torch.profiler, with one
    record_function span per call."""
    from torch.profiler import record_function

    real = fp.fma
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("ptdn_tpu_torch") and
            getattr(m, "fma", None) is real]
    calls = collections.Counter()
    host = collections.Counter()
    spans = [False]

    def timed(a, b, c):
        site = _caller()
        calls[site] += 1
        if spans[0]:
            with record_function("fma@" + site):
                return real(a, b, c)
        t0 = time.perf_counter()
        out = real(a, b, c)
        host[site] += time.perf_counter() - t0
        return out
    for m in mods:
        m.fma = timed
    try:
        for _ in range(frames):
            r.render_frame()
        torch.cuda.synchronize()
        spans[0] = True
        _, _, _, events = profiled(r, frames)
    finally:
        for m in mods:
            m.fma = real
    launches = collections.Counter()
    for e in events:
        if e.name.startswith("fma@"):
            launches[e.name[4:]] += _launches(e)
    return {k: (calls[k] / (2 * frames), host[k] * 1e3 / frames,
                launches[k] / frames) for k in calls}


def profile_one(scene: str, engine, a, card: str):
    """Print the stages, the profile and, with --fma-sites, the fma call
    sites of `scene` through `engine` (None: the scene's own)."""
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
    stages = timed_stages(r, a.frames)
    for k, ms in stages.items():
        print(f"stage {k}: {ms:.3f} ms/frame ({ms / 8:.3f} per bounce) "
              f"{tag}")
    by_kernel, wall, launched, _ = profiled(r, a.frames)
    busy = sum(by_kernel.values())
    print(f"profile: wall {wall:.3f} ms/frame, device busy "
          f"{busy:.3f} ms/frame, idle share "
          f"{(1 - busy / wall) if busy else float('nan'):.3f}, "
          f"{launched:.1f} kernels/frame {tag}")
    for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]:
        print(f"kernel {ms:8.3f} ms/frame  {k[:110]}")
    if a.fma_sites:
        sites = fma_sites(r, a.frames)
        tot = [sum(v[i] for v in sites.values()) for i in range(3)]
        print(f"fma sites: {tot[0]:.1f} calls, {tot[1]:.3f} host ms, "
              f"{tot[2]:.1f} launches per frame {tag}")
        for k, (n, ms, la) in sorted(sites.items(), key=lambda kv: -kv[1][1]):
            print(f"fma site {k}: {n:.1f} calls, {ms:.3f} host ms, "
                  f"{la:.1f} launches per frame")


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
    ap.add_argument("--fma-sites", action="store_true",
                    help="split the glue's fp.fma calls by call site")
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
