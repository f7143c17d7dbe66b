"""The closest-hit kernels' times on the card, on random rays.

    python3 -m ptdn_tpu_torch.trace_bench [--reps N]

The port of benchmarks/trace_bench.py: cornell, 800 x 800 random rays
(numpy seed 0: origins normal * 0.1 around the scene's centre of
coordinates, directions normal and normalized), and three kernels timed
with CUDA events over N launches each (default 20, after a warm-up):

* A, the fully resolved closest hit (scene_intersect_full);
* M, the unmerged analytic and mesh bests alone (scene_intersect);
* I, the visibility of light geom 0 (light_visibility).

One line per kernel, each with the card's name and power limit
(nvidia-smi). Needs one card.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path

RES = (800, 800)
LIGHT_GEOM = 0


def random_rays(n: int, seed: int = 0):
    """benchmarks/trace_bench.py's rays: (o, d) float32 (n, 3) arrays."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def setup(device="cuda"):
    """The cornell scene on `device` and the bench's rays there: the
    arguments (ds, gi, o, d) of every timed kernel."""
    scene = Scene(scene_path("cornell"))
    ds = scene.device(device)
    gi = A.geom_info(scene, device)
    o, d = random_rays(RES[0] * RES[1])
    return (ds, gi, torch.from_numpy(o).to(device),
            torch.from_numpy(d).to(device))


def calls(ds, gi, o, d):
    """name -> a call of that kernel's wrapper on the bench's rays."""
    return {
        "scene_intersect_full": lambda: A.scene_intersect_full(ds, gi, o, d),
        "scene_intersect": lambda: A.scene_intersect(ds, gi, o, d),
        "light_visibility": lambda: A.light_visibility(ds, gi, o, d,
                                                       LIGHT_GEOM),
    }


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn over reps calls, after two warm-ups."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(reps: int = 20):
    """name -> ms per launch of each kernel on the card."""
    return {name: event_ms(fn, reps)
            for name, fn in calls(*setup("cuda")).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_bench needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n = RES[0] * RES[1]
    for name, ms in run(args.reps).items():
        print(f"{name}: {ms:.4f} ms for {n} rays [{card}]")


if __name__ == "__main__":
    main()
