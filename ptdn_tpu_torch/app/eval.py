"""Quality evaluation harness: denoised RMSE vs accumulated reference, the
JAX package's ptdn_tpu/app/eval.py on the port.

This is the BASELINE.json metric: render a ground-truth image by
accumulating many unfiltered frames (the reference's converged mode,
pathtrace.cu:398), then render K 1-spp SVGF frames and report RMSE of the
denoised output against the ground truth. --compare-devices also renders
the SVGF frames on the CPU, through the kernels' plain versions, and
reports the card-vs-plain RMSE of the raw and denoised frames.

Usage:
  python -m ptdn_tpu_torch.app.eval scenes/cornell.txt --gt-frames 2000 \
      --frames 32 --depth 8 [--width 800 --height 800] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def render_ground_truth(scene, resolution, frames: int, depth: int,
                        device: str = "cuda"):
    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(denoise_enable=False, trace_depth=depth)
    r = Renderer(scene, cfg, resolution=resolution, device=device)
    left, _ = r.render(frames)
    return left


def render_denoised(scene, resolution, frames: int, depth: int,
                    device: str = "cuda", **denoise_overrides):
    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.utils.config import RenderConfig

    kw = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
              atrous_nlevel=5)
    kw.update(denoise_overrides)
    cfg = RenderConfig(trace_depth=depth, **kw)
    r = Renderer(scene, cfg, resolution=resolution, device=device)
    left, right = r.render(frames)
    return left, right


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--gt-frames", type=int, default=2000)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--compare-devices", action="store_true",
                    help="also report the RMSE of --device's frames "
                         "against the CPU's (the plain versions)")
    ap.add_argument("--save-prefix", default="")
    args = ap.parse_args(argv)

    from ptdn_tpu_torch.scene import Scene
    from ptdn_tpu_torch.utils.image_io import save_png

    scene = Scene(args.scene)
    res = ((args.width, args.height)
           if args.width and args.height else scene.resolution)

    gt = render_ground_truth(scene, res, args.gt_frames, args.depth,
                             args.device)
    raw, dn = render_denoised(scene, res, args.frames, args.depth,
                              args.device)
    gt_c = np.clip(gt, 0, 1)
    result = {
        "scene": args.scene,
        "resolution": list(res),
        "gt_frames": args.gt_frames,
        "svgf_frames": args.frames,
        "rmse_raw_1spp_vs_gt": rmse(np.clip(raw, 0, 1), gt_c),
        "rmse_denoised_vs_gt": rmse(np.clip(dn, 0, 1), gt_c),
    }
    if args.compare_devices:
        raw2, dn2 = render_denoised(scene, res, args.frames, args.depth,
                                    "cpu")
        result["rmse_cuda_vs_cpu_denoised"] = rmse(dn, dn2)
        result["rmse_cuda_vs_cpu_raw"] = rmse(raw, raw2)
    if args.save_prefix:
        save_png(args.save_prefix + "_gt.png", gt_c)
        save_png(args.save_prefix + "_denoised.png", dn)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
