"""Drive the port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the headline frame of the JAX package's bench.py:
scenes/cornell.txt at 800x800, 1 spp, trace depth 8, static camera,
temporal SVGF with a 5-level à-trous filter. Phases, one line each:

0. the card (name and power limit from nvidia-smi); TF32 off;
1. build every kernel of the path from ptdn_tpu_torch/csrc with nvcc;
2. each kernel against its plain PyTorch version on the card, on the
   main path's shapes and a mid-sequence state;
3. 32 frames through ptdn_tpu_torch's Renderer with every launch count
   checked, finite outputs, and the denoised RMSE against the converged
   ground truth (benchmarks/gt/cornell_800x800_d8.npz) below half the raw
   1-spp RMSE;
4. CUDA-event times: ms/frame of the path and each kernel beside its
   plain version.

The line before the last is a JSON object with every kernel's numbers;
the last is {"ok": true, "device": {...}}. Any failed check raises, so
the exit code is not 0 and no result line is printed. Needs one card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ptdn_tpu_torch.denoise.reproject import motion_bounds  # noqa: E402
from ptdn_tpu_torch.engine import Renderer  # noqa: E402
from ptdn_tpu_torch.ops.camera import generate_camera_rays  # noqa: E402
from ptdn_tpu_torch.ops.cuda import _lib  # noqa: E402
from ptdn_tpu_torch.ops.cuda import atrous as D  # noqa: E402
from ptdn_tpu_torch.ops.cuda import path as B  # noqa: E402
from ptdn_tpu_torch.ops.cuda import reproject as C  # noqa: E402
from ptdn_tpu_torch.ops.cuda import scene_intersect as A  # noqa: E402
from ptdn_tpu_torch.scene import Scene  # noqa: E402
from ptdn_tpu_torch.utils.assets import scene_path  # noqa: E402
from ptdn_tpu_torch.utils.config import RenderConfig  # noqa: E402

DEVICE = "cuda"
RES = (800, 800)
DEPTH = 8
FRAMES = 32
CFG = RenderConfig(trace_depth=DEPTH, denoise_enable=True,
                   temporal_enable=True, spatial_enable=True, atrous_nlevel=5)
WRAPPERS = (A.scene_intersect_full, B.path_trace, B.deferred_radiance,
            C.back_projection_stencil, D.atrous_level)
KERNELS = [
    ("scene_intersect_full", "ptdn_tpu_torch/csrc/scene_intersect.cu",
     "ptdn_tpu/ops/pallas/scene_intersect.py:1478"),
    ("path_trace", "ptdn_tpu_torch/csrc/path.cu",
     "ptdn_tpu/ops/pallas/path.py:258"),
    ("deferred_radiance", "ptdn_tpu_torch/csrc/path.cu",
     "ptdn_tpu/ops/pallas/path.py:239"),
    ("back_projection_stencil", "ptdn_tpu_torch/csrc/reproject.cu",
     "ptdn_tpu/ops/pallas/reproject.py:194"),
    ("atrous_level", "ptdn_tpu_torch/csrc/atrous.cu",
     "ptdn_tpu/ops/pallas/atrous.py:275"),
]


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2,
            hide_host: bool = False) -> float:
    """Mean CUDA-event time of fn over reps calls. hide_host queues the
    calls behind a ~0.1 s device spin, so that a call whose host side
    (Python, argument checks, launch) outlasts its kernel is timed by its
    device work alone; without it the time is the frame's end to end."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hide_host:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(log: str):
    """'<kernel>: N registers, S bytes spilled' per entry function of
    nvcc's -Xptxas -v report."""
    out, name, spill = [], "?", "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z][a-z_]*_kernel)",
                      ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name} {m.group(1)} registers, {spill} B spilled")
    return out


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def main():
    # ---- phase 0: the card ----
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    log = _lib.build(force=True)
    _lib.kernels()
    print(f"phase 1: built {len(list(_lib.CSRC.glob('*.cu')))} sources for "
          f"sm_90a in {time.perf_counter() - t0:.1f} s; ptxas: "
          + "; ".join(ptxas_summary(log)))

    # ---- phase 2: kernels against their plain versions ----
    dev = torch.device(DEVICE)
    scene = Scene(scene_path("cornell"))
    warm = Renderer(scene, CFG, resolution=RES, device=dev)
    for _ in range(3):
        warm.render_frame()
    tr = warm.step.tracer
    ds, gi = tr.ds, tr.gi
    cam, view = warm._cam
    o, d = generate_camera_rays(cam, RES)
    stats = {}

    ka = A._scene_intersect_full_kernel(ds, gi, o, d)
    pa = A.scene_intersect_full_plain(ds, gi, o, d)
    agree = ka["geom_id"] == pa["geom_id"]
    frac = float(agree.float().mean())
    close = all(torch.allclose(ka[k][agree], pa[k][agree], rtol=1e-5,
                               atol=1e-5) for k in ("t", "normal", "uv"))
    stats["scene_intersect_full"] = max(
        max_abs(ka[k][agree], pa[k][agree]) for k in ("t", "normal", "uv"))
    check(frac >= 0.999 and close, f"A: geom agreement {frac}")
    print(f"phase 2: A geom_id agreement {frac:.6f}, max |d| on agreeing "
          f"lanes {stats['scene_intersect_full']:.3g}")

    prim = dict({k: getattr(tr, "pcache_" + k) for k in
                 ("t", "normal", "uv", "mat_id", "geom_id", "hit",
                  "albedo")}, o=o, d=d)
    light = dict(tr.light, radius=float(CFG.light_radius),
                 intensity=float(CFG.shadow_intensity))
    bargs = (ds, gi, prim, 3, 0, DEPTH, light, tr.flags)
    kc, kt = B._path_trace_kernel(*bargs)
    pc, pt = B.path_trace_plain(ds, gi, prim, frame=3, lane0=0, depth=DEPTH,
                                light=light, flags=tr.flags)
    krad = B._deferred_radiance_kernel(ds, kc, kt, DEPTH)
    prad = B.deferred_radiance_plain(ds, pc, pt, DEPTH)
    diff = (krad - prad).abs().max(dim=-1).values
    bfrac = float((diff > 1e-3).float().mean())
    brmse = float(((krad - prad) ** 2).mean().sqrt())
    stats["path_trace"] = max_abs(kc, pc)
    stats["deferred_radiance"] = max_abs(
        B._deferred_radiance_kernel(ds, pc, pt, DEPTH), prad)
    check(bfrac < 0.01 and brmse < 0.012, f"B1+B2: frac {bfrac} rmse {brmse}")
    print(f"phase 2: B1+B2 pixels |d|>1e-3 {bfrac:.6f}, RMSE {brmse:.3g}; "
          f"texel indices equal {float((kt == pt).float().mean()):.6f}; "
          f"B2 alone max |d| {stats['deferred_radiance']:.3g}")

    w, h = RES
    st = warm.step.frame_state()
    rad, gb = tr(cam, warm._params, 3, False)
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    raw = rad.reshape(h, w, 3)
    prev = {"position": st["prev_position"], "normal": st["prev_normal"],
            "geom_id": st["prev_geom_id"]}
    cargs = (RES, raw, gb, prev, st["prev_view"], st["color_history"],
             st["moment_history"], st["history_length"],
             float(CFG.color_alpha), float(CFG.moment_alpha))
    check(bool(motion_bounds(RES, gb, st["prev_view"])),
          "C: a static camera is in the stencil domain")
    kcr = C._back_projection_stencil_kernel(*cargs)
    pcr = C.back_projection_stencil_plain(*cargs)
    stats["back_projection_stencil"] = max(max_abs(a, b)
                                           for a, b in zip(kcr, pcr))
    check(all(torch.allclose(a.double(), b.double(), rtol=1e-5, atol=1e-5)
              for a, b in zip(kcr, pcr)), "C: allclose 1e-5")
    print(f"phase 2: C max |d| {stats['back_projection_stencil']:.3g}")

    src, var = pcr[1], pcr[0]
    dmax = 0.0
    sig = (float(CFG.sigma_l), float(CFG.sigma_n), float(CFG.sigma_x))
    for level in range(1, CFG.atrous_nlevel + 1):
        dargs = (src, var, gb["position"], gb["normal"], None, level, *sig,
                 CFG.blur_variance)
        kd = D._atrous_level_kernel(*dargs)
        pd = D.atrous_level_plain(*dargs)
        check(all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                  for a, b in zip(kd, pd)), f"D level {level}: allclose 1e-5")
        dmax = max(dmax, max_abs(kd[0], pd[0]), max_abs(kd[1], pd[1]))
        src, var = pd
    stats["atrous_level"] = dmax
    print(f"phase 2: D levels 1-{CFG.atrous_nlevel} max |d| {dmax:.3g}")
    torch.cuda.synchronize()

    # ---- phase 3: the main path, every launch counted ----
    r = Renderer(scene, CFG, resolution=RES, device=dev)
    for fn in WRAPPERS:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        left, right = r.render_frame()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for (name, _, _), fn in zip(KERNELS,
                                                             WRAPPERS)}
    check(launches["scene_intersect_full"] >= 1, "A launched")
    check(launches["path_trace"] == FRAMES, "B1 once per frame")
    check(launches["deferred_radiance"] == FRAMES, "B2 once per frame")
    check(launches["back_projection_stencil"] >= FRAMES - 1,
          "C on every frame after the first")
    check(launches["atrous_level"] == FRAMES * CFG.atrous_nlevel,
          "D per level per frame")
    check(bool(torch.isfinite(left).all()) and bool(torch.isfinite(right).all()),
          "finite outputs")
    gt = np.clip(np.load(os.path.join(ROOT, "benchmarks", "gt",
                                      "cornell_800x800_d8.npz"))["gt"], 0, 1)
    raw_np = np.clip(left.cpu().numpy(), 0, 1).astype(np.float64)
    dn_np = np.clip(right.cpu().numpy(), 0, 1).astype(np.float64)
    e_raw = float(np.sqrt(np.mean((raw_np - gt) ** 2)))
    e_dn = float(np.sqrt(np.mean((dn_np - gt) ** 2)))
    check(e_dn < 0.5 * e_raw, f"denoised RMSE {e_dn} < raw RMSE {e_raw} / 2")
    print(f"phase 3: {FRAMES} frames in {wall:.2f} s wall; launches "
          f"{json.dumps(launches)}; RMSE vs GT denoised {e_dn:.5f} raw "
          f"{e_raw:.5f}")

    # ---- phase 4: times ----
    n_steady = 20
    frame_ms = cuda_ms(r.render_frame, reps=n_steady, warmup=2)
    times = {
        "scene_intersect_full": (
            lambda: A._scene_intersect_full_kernel(ds, gi, o, d),
            lambda: A.scene_intersect_full_plain(ds, gi, o, d)),
        "path_trace": (
            lambda: B._path_trace_kernel(*bargs),
            lambda: B.path_trace_plain(ds, gi, prim, frame=3, lane0=0,
                                       depth=DEPTH, light=light,
                                       flags=tr.flags)),
        "deferred_radiance": (
            lambda: B._deferred_radiance_kernel(ds, pc, pt, DEPTH),
            lambda: B.deferred_radiance_plain(ds, pc, pt, DEPTH)),
        "back_projection_stencil": (
            lambda: C._back_projection_stencil_kernel(*cargs),
            lambda: C.back_projection_stencil_plain(*cargs)),
        "atrous_level": (
            lambda: D._atrous_level_kernel(pcr[1], pcr[0], gb["position"],
                                           gb["normal"], None, 1, *sig,
                                           CFG.blur_variance),
            lambda: D.atrous_level_plain(pcr[1], pcr[0], gb["position"],
                                         gb["normal"], None, 1, *sig,
                                         CFG.blur_variance)),
    }
    out = []
    for name, source, replaces in KERNELS:
        kfn, pfn = times[name]
        reps = 3 if name == "path_trace" else 10
        ms = cuda_ms(kfn, reps=reps, hide_host=True)
        plain_ms = cuda_ms(pfn, reps=reps, warmup=1, hide_host=True)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": stats[name], "ms": ms,
                    "plain_ms": plain_ms})
        print(f"phase 4: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"[{card}]")
    print(f"phase 4: frame {frame_ms:.3f} ms/frame over {n_steady} "
          f"steady-state frames (cornell {w}x{h}, depth {DEPTH}, SVGF "
          f"{CFG.atrous_nlevel} levels) [{card}]")
    print(json.dumps({"kernels": out, "frame_ms": frame_ms,
                      "rmse_denoised": e_dn, "rmse_raw": e_raw}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
