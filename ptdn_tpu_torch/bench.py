"""Benchmark harness of the port — prints ONE JSON line with the headline
metric, the JAX package's bench.py on the card.

    python3 -m ptdn_tpu_torch.bench [--all] [--quality]

Headline: cornell.txt 800x800, 1 spp, 8 bounces, static camera,
5-iteration à-trous SVGF, on one NVIDIA card. `value` is the mean
ms/frame over --frames consecutive frames after --warmup, each frame
ended by torch.cuda.synchronize(): what a loop that shows every frame
pays. vs_baseline is value / 16.0 (the north-star budget): < 1.0 beats
it. It is a BUDGET ratio, not a comparison with a measured reference.
The line also names the card and its power limit (`device`). Without a
card the bench exits with card_name's message.

--all adds diamond, bunny, room and terrain30k at their RES and room at
1920x1080 with bench.py's animated camera. Every configuration's numbers
go to out/bench_results_torch.json (never bench_results.json, which holds
the TPU's), with the card's name: extra_ms (the synced ms/frame of each
configuration but the headline), ms_pipelined (utils/card.py:cuda_ms of
--frames frames, host not hidden: the frames queued back to back, the
figure chip_smoke.py's phase 4 prints for still cornell), rays_per_sec_M,
and with --quality quality_rmse.

--quality reports the denoised RMSE against the committed converged
ground truths (benchmarks/gt/*.npz, read-only; app/eval.py renders new
ones) after 32 1-spp SVGF frames, per still configuration. A frame's
stages are profile_frame.py's.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

TARGET_MS = 16.0
REPO = pathlib.Path(__file__).resolve().parents[1]
GT_DIR = REPO / "benchmarks" / "gt"
EXTRAS = REPO / "out" / "bench_results_torch.json"
DEPTH = 8
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            atrous_nlevel=5)
# bench.py's room_1080p_animated camera
MOVING = dict(automate_camera=True, camera_speed_x=0.02,
              camera_speed_theta=0.01, camera_speed_phi=0.015)


@functools.cache
def load_scene(path: str):
    from ptdn_tpu_torch.scene import Scene

    return Scene(path)


def time_frames(frame, frames: int, warmup: int) -> float:
    """Mean ms/frame of `frames` calls of frame() after `warmup`, each
    ended by a device sync."""
    for _ in range(warmup):
        frame()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        frame()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / frames


def run_config(scene_path, resolution, frames, warmup, cfg):
    """(synced ms/frame, pipelined ms/frame) of one configuration; the
    camera moves where cfg automates it."""
    from ptdn_tpu_torch.app.automate import CameraAutomation
    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.utils.card import cuda_ms

    r = Renderer(load_scene(scene_path), cfg, resolution=resolution)
    auto = CameraAutomation(cfg)

    def frame():
        if auto.step(r.camera):
            r.cam_changed = True
        return r.render_frame()

    ms = time_frames(frame, frames, max(warmup, 2))
    return ms, cuda_ms(frame, reps=frames)


def rays_per_sec(resolution, depth, ms):
    """Bounce rays only (primary + depth-1 scatters), excluding NEE
    visibility rays — the conservative throughput figure."""
    w, h = resolution
    return w * h * depth * 1000.0 / ms if ms else 0.0


def _gt_path(name, resolution, depth, gt_dir=GT_DIR):
    return os.path.join(gt_dir, f"{name}_{resolution[0]}x{resolution[1]}"
                                f"_d{depth}.npz")


def _scene_sha(scene_path):
    """Content hash of the scene file + any OBJ models it references
    (bench.py's), so that a changed scene cannot pass a stale ground
    truth."""
    h = hashlib.sha256(open(scene_path, "rb").read())
    sdir = os.path.dirname(os.path.abspath(scene_path))
    for line in open(scene_path):
        tok = line.split()
        # mesh objects name their .obj on a bare line (parser.py:20)
        if tok and tok[0].endswith(".obj"):
            mp = os.path.join(sdir, "Models", tok[0])
            if os.path.isfile(mp):
                h.update(open(mp, "rb").read())
    return h.hexdigest()[:16]


def ground_truth(scene_path, name, resolution, depth, gt_dir=GT_DIR):
    """(converged image, its frame count) from the committed ground truth,
    read-only. A stored scene hash that differs raises; a file without
    one (rendered before bench.py stored hashes) is trusted as it is. A
    missing file raises: app/eval.py renders ground truths."""
    path = _gt_path(name, resolution, depth, gt_dir)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no ground truth {path}; render one with "
            f"python3 -m ptdn_tpu_torch.app.eval")
    with np.load(path, allow_pickle=False) as z:
        stored = str(z["scene_sha"]) if "scene_sha" in z.files else None
        sha = _scene_sha(scene_path)
        if stored is not None and stored != sha:
            raise RuntimeError(f"{path} is stale: scene hash {stored} != "
                               f"{sha}")
        return z["gt"], int(z["gt_frames"])


def quality_rmse(scene_path, name, resolution, depth, cfg, svgf_frames=32,
                 gt_dir=GT_DIR):
    """BASELINE.json metric: denoised RMSE vs converged GT after
    svgf_frames 1-spp SVGF frames (temporal history warmed up)."""
    from ptdn_tpu_torch.engine import Renderer

    gt, gt_frames = ground_truth(scene_path, name, resolution, depth, gt_dir)
    gt = np.clip(gt, 0, 1)
    r = Renderer(load_scene(scene_path), cfg, resolution=resolution)
    left, right = r.render(svgf_frames)
    raw = np.clip(left, 0, 1)
    dn = np.clip(right, 0, 1)
    e_raw = float(np.sqrt(np.mean((raw.astype(np.float64) - gt) ** 2)))
    e_dn = float(np.sqrt(np.mean((dn.astype(np.float64) - gt) ** 2)))
    return {"rmse_denoised": round(e_dn, 5), "rmse_raw_1spp": round(e_raw, 5),
            "gt_frames": gt_frames, "svgf_frames": svgf_frames}


def bench_configs(scenes_dir):
    """(scene file, name, resolution override) of --all's still
    configurations (bench.py's); resolution None = the scene file's
    RES."""
    from ptdn_tpu_torch.utils.assets import REPO_SCENES

    return [
        (f"{scenes_dir}/diamond.txt", "diamond", None),
        (f"{scenes_dir}/bunny.txt", "bunny", None),
        (f"{scenes_dir}/room.txt", "room", None),
        # ~30k-tri scale benchmark (the reference demonstrated a
        # 30k-tri room as real-time, slides/MS3.pdf p.6)
        (os.path.join(REPO_SCENES, "terrain30k.txt"), "terrain30k", None),
    ]


def configs(scenes_dir, all_configs: bool):
    """(scene file, name, resolution or None, camera moves) of every
    configuration the bench runs: the headline, then with --all
    bench_configs and room at 1920x1080 with the animated camera."""
    head = [(f"{scenes_dir}/cornell.txt", "cornell", (800, 800), False)]
    if not all_configs:
        return head
    return (head + [c + (False,) for c in bench_configs(scenes_dir)]
            + [(f"{scenes_dir}/room.txt", "room_1080p_animated",
                (1920, 1080), True)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--all", action="store_true",
                    help="also run the non-headline BASELINE.json configs")
    ap.add_argument("--quality", action="store_true",
                    help="also report denoised RMSE vs the committed GT")
    ap.add_argument("--scenes-dir", default=None,
                    help="scene dir (default: PTDN_SCENES_DIR or the "
                         "vendored <repo>/scenes)")
    args = ap.parse_args(argv)

    from ptdn_tpu_torch.utils.card import card_name
    from ptdn_tpu_torch.utils.config import RenderConfig

    card = card_name()      # exits without a card
    if args.scenes_dir is None:
        from ptdn_tpu_torch.utils.assets import scenes_dir
        args.scenes_dir = str(scenes_dir())

    result, extras, pipelined, rays, quality = None, {}, {}, {}, {}
    for path, name, res, moving in configs(args.scenes_dir, args.all):
        cfg = RenderConfig(trace_depth=DEPTH, **SVGF,
                           **(MOVING if moving else {}))
        res = res or load_scene(path).resolution
        ms, ms_pipe = run_config(path, res, args.frames, args.warmup, cfg)
        if result is None:
            result = {
                "metric": "ms/frame (cornell 800x800, 1spp, depth 8, "
                          "SVGF 5-level)",
                "value": round(ms, 3),
                "unit": "ms",
                "vs_baseline": round(ms / TARGET_MS, 4),
                "device": card,
            }
        else:
            extras[name] = round(ms, 3)
        pipelined[name] = round(ms_pipe, 3)
        rays[name] = round(rays_per_sec(res, DEPTH, ms) / 1e6, 1)
        # no ground truth for the moving camera: it never converges
        if args.quality and not moving:
            quality[name] = quality_rmse(path, name, res, DEPTH, cfg)
        print(f"[bench] {name} {res[0]}x{res[1]}: {ms:.3f} ms/frame synced, "
              f"{ms_pipe:.3f} pipelined [{card}]", file=sys.stderr,
              flush=True)

    out = {"device": card, "headline": result, "ms_pipelined": pipelined}
    if extras:
        out["extra_ms"] = extras
    out["rays_per_sec_M"] = rays
    if quality:
        out["quality_rmse"] = quality
    EXTRAS.parent.mkdir(exist_ok=True)
    EXTRAS.write_text(json.dumps(out, indent=2))
    print(json.dumps(out), file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
