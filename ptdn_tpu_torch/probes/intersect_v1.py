"""Kernel P's times on the card, beside kernel A's on the same rays: the
port of the superseded first mesh kernel's probe,
benchmarks/pallas_intersect_v1.py (mesh_intersect_pallas).

    python3 -m ptdn_tpu_torch.probes.intersect_v1 [--reps N] [--count]

Three ray sets of 640,000 rays: bunny's camera rays at 800 x 800 (4,968
triangles in 39 chunks), cornell's camera rays at 800 x 800 (its back
wall's triangles in one chunk), and the trace bench's random rays in
cornell (ptdn_tpu_torch/trace_bench.py:random_rays, numpy seed 0). Per
set: kernel P's rough closest triangle hit with its chunk cull (by the
warp) on and off (checked equal: the cull changes the work, not the
answer), and kernel A, the renderer's fully resolved closest hit of the
whole scene, on the same rays. One line per set and kernel with the
card's name and power limit. --count runs on the CPU instead: the
lane-triangle tests a cull by groups of 1, 32, 128 and 512 rays leaves
on each set (P's plain version's counts).
"""

from __future__ import annotations

import argparse
import json

import torch

from ptdn_tpu_torch import trace_bench
from ptdn_tpu_torch.ops.camera import OrbitCamera, generate_camera_rays
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.ops.cuda.intersect_v1 import (mesh_intersect_v1,
                                                  mesh_intersect_v1_plain,
                                                  plane_table)
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.card import card_name, cuda_ms

RES = (800, 800)


def camera_rays(scene, device, res=RES):
    """The scene camera's primary rays at `res`: o, d (N, 3)."""
    cam = OrbitCamera(scene.camera, resolution=res).frame().as_tensors(device)
    return generate_camera_rays(cam, res)


def cases(device="cuda", res=RES):
    """label -> (scene, its plane table, its GeomInfo, o, d)."""
    out = {}
    for name in ("bunny", "cornell"):
        scene = Scene(scene_path(name))
        out[f"{name} camera"] = (scene, plane_table(scene, device),
                                 A.geom_info(scene, device),
                                 *camera_rays(scene, device, res))
    scene, pt, gi = out["cornell camera"][:3]
    o, d = trace_bench.random_rays(res[0] * res[1])
    out["cornell random"] = (scene, pt, gi, torch.from_numpy(o).to(device),
                             torch.from_numpy(d).to(device))
    return out


def run(reps: int = 10, device="cuda", res=RES):
    """label -> {n, chunks, hits, ms (cull on), ms_nocull, a_ms}."""
    res_ = {}
    for label, (scene, pt, gi, o, d) in cases(device, res).items():
        ds = scene.device(device)
        t, tri = mesh_intersect_v1(pt, o, d, cull=True)
        t2, tri2 = mesh_intersect_v1(pt, o, d, cull=False)
        if not (torch.equal(tri, tri2) and torch.equal(t, t2)):
            raise RuntimeError(f"intersect_v1 {label}: the cull changed "
                               f"the answer")
        res_[label] = {
            "n": o.shape[0], "chunks": int(pt.tri_mm.shape[0]),
            "hits": int((tri >= 0).sum()),
            "ms": cuda_ms(lambda: mesh_intersect_v1(pt, o, d, True), reps,
                          hide_host=True),
            "ms_nocull": cuda_ms(
                lambda: mesh_intersect_v1(pt, o, d, False), reps,
                hide_host=True),
            "a_ms": cuda_ms(lambda: A.scene_intersect_full(ds, gi, o, d),
                            reps, hide_host=True)}
    return res_


def count(res=RES):
    """label -> the work of each cull design on the probe's rays, counted
    by P's plain version on the CPU (mesh_intersect_v1_plain's counts=:
    the tests of a cull by groups of 1, 32, 128 and 512 rays)."""
    out = {}
    for label, (_, pt, _, o, d) in cases("cpu", res).items():
        out[label] = {}
        mesh_intersect_v1_plain(pt, o, d, True, counts=out[label])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--count", action="store_true",
                    help="count each cull design's work on the CPU instead")
    args = ap.parse_args(argv)
    if args.count:
        for label, c in count().items():
            print(f"{label}: {json.dumps(c)}")
        return
    card = card_name()
    for label, r in run(args.reps).items():
        print(f"{label}: {r['n']} rays, {r['chunks']} chunks, {r['hits']} "
              f"mesh hits: mesh_intersect_v1 cull {r['ms']:.4f} ms, no cull "
              f"{r['ms_nocull']:.4f} ms; scene_intersect_full (A) "
              f"{r['a_ms']:.4f} ms [{card}]")


if __name__ == "__main__":
    main()
