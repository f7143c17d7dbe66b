"""One sharded frame step of cornell at 64 x 16n, depth 2, SVGF with 5
à-trous levels (the JAX package's __graft_entry__.py:dryrun_multichip),
checked against the whole image's frame bit for bit.

    python3 -m ptdn_tpu_torch.parallel.dryrun N [--ranks] [--device cpu]

runs N shards in this process, one after another on one device (the
card by default), or with --ranks as N torch.distributed ranks over
gloo on that device (one shard a rank, the exchanged rows staged through
host memory). At 16 rows a shard, level 5's 64-row halo spans four hops.
Prints one JSON line; exits 1 if a frame differs.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.parallel.mesh import DistGroup, InProcessGroup
from ptdn_tpu_torch.parallel.sharded import ShardedRenderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.config import RenderConfig

CFG = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
           trace_depth=2, atrous_nlevel=5)
# seconds the --ranks run may take, process starts included
RANKS_TIMEOUT = 600


def render(renderer, frames: int):
    """The last of `frames` frames, (left, right) as numpy."""
    left = right = None
    for _ in range(frames):
        left, right = renderer.render_frame()
    return left.cpu().numpy(), right.cpu().numpy()


def _rank_main(rank: int, n: int, init: str, out: str, name: str,
               cfg_kw: dict, res, frames: int, device: str):
    """One rank of run_ranks: its shard of the frames; rank 0 saves the
    stitched last frame to `out`."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        r = ShardedRenderer(Scene(scene_path(name)), RenderConfig(**cfg_kw),
                            res, DistGroup(), device=device)
        left, right = render(r, frames)
        if rank == 0:
            np.savez(out, left=left, right=right)
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, name: str, cfg_kw: dict, res, frames: int,
              device: str, timeout: float, tmp: Optional[str] = None):
    """The stitched last frame of `frames` frames of scene `name` rendered
    by n gloo ranks, each a process holding one shard on `device`,
    rendezvousing through a file in `tmp`. Raises if a rank fails or the
    ranks outlast `timeout` seconds (and stops them)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        init = "file://" + os.path.join(d, "rendezvous")
        out = os.path.join(d, "frame.npz")
        procs = [ctx.Process(target=_rank_main,
                             args=(k, n, init, out, name, cfg_kw, tuple(res),
                                   frames, device)) for k in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
                if p.is_alive():
                    raise TimeoutError(f"rank {procs.index(p)} outlasted "
                                       f"{timeout} s")
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {procs.index(p)} exited "
                                       f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        got = np.load(out)
        return got["left"], got["right"]


def dryrun_multichip(n: int, device: str = "cuda",
                     ranks: bool = False) -> dict:
    """One step of n shards of cornell at 64 x 16n against the whole
    image's. Returns what it prints."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun on 'cuda' needs a CUDA device")
    res = (64, 16 * n)
    scene = Scene(scene_path("cornell"))
    cfg = RenderConfig(**CFG)
    want = render(Renderer(scene, cfg, res, device=device), 1)
    if ranks:
        got = run_ranks(n, "cornell", CFG, res, 1, str(device),
                        RANKS_TIMEOUT)
    else:
        got = render(ShardedRenderer(scene, cfg, res, InProcessGroup(n),
                                     device=device), 1)
    equal = all(np.array_equal(a, b) for a, b in zip(got, want))
    finite = all(bool(np.isfinite(a).all()) for a in got)
    return {"shards": n, "ranks": ranks, "device": str(device),
            "resolution": list(res), "bit_equal": equal, "finite": finite,
            "shape": list(got[1].shape)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="shards")
    ap.add_argument("--ranks", action="store_true",
                    help="one gloo rank a shard instead of one process")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.n, args.device, args.ranks)
    print(json.dumps(out))
    return 0 if out["bit_equal"] and out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
