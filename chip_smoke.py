"""Drive the port's main paths once on one NVIDIA card and check them.

    python3 chip_smoke.py

Four engines, all at bench.py's headline settings (1 spp, trace depth
8, static camera, temporal SVGF with a 5-level à-trous filter, each
scene at its own resolution):

* cornell (800x800) through the whole-path engine: kernels A, B1, B2, C
  and D;
* the mesh scenes through the sorted wavefront: A, E, F, C and D, and G
  on diamond (at most 8 chunks); diamond, bunny and terrain30k at
  800x800, room at 600x600;
* cornell, room and bunny through the unsorted fused per-bounce engine
  (fuse_path=False, sort_rays=False): A, H, K on the textured scenes, C,
  D;
* cornell, bunny and room through the split per-bounce engine
  (fuse_path=False, fuse_bounce=False): A, E, I, then J and K on cornell
  and room (textured) or A on bunny, C, D;
* the camera-motion runs: cornell with fuse_reproject_l1 (L on every
  frame after the first, C's band mode then D on frame 0), cornell with
  tests/test_golden.py's cornell_svgf_anim_slow camera speeds with the
  flag off and on (C's band mode on every frame), and bench.py's
  room_1080p_animated (room at 1920x1080 with a moving camera, the flag
  on: its gate keeps L off at that width);
* the trace bench (ptdn_tpu_torch/trace_bench.py): A, M and I on 800x800
  random rays in cornell (M on the block scan, with the chunk cull on
  and off);
* a generated scene past kernel B1's per-scene build (cornell plus 55
  cubes, 65 geoms, at 800x800) through the whole-path engine: A, B1's
  table build (csrc/path_trace_table.cu), B2, C and D;
* the ports of the benchmarks/ probes (ptdn_tpu_torch/probes): N
  (texgather), G at the in-row regroup's K = 29 (regroup), P with A beside
  it (intersect_v1) and O (dyngather), and reproj_bench (C's two modes
  beside the PyTorch window, packed and packed2 variants).

Every frame's reprojection branch (C's stencil mode or L where the
motion is within a pixel, else C's band mode) is read from motion_bounds,
which each run wraps; C's band mode runs on frame 0 of every run, whose
previous view is the identity.

Phases, one line or more each, with their wall time:

0. the card (name and power limit from nvidia-smi); TF32 off;
1. build every kernel from ptdn_tpu_torch/csrc (one nvcc per source, all
   at once, B1's table build and the library builds of F, H, A, J, I and
   M among them), then kernels B1, F, H, A, J, I and M for each scene's
   constants (csrc/scene/*.cu, every scene at once), with each kernel's
   registers, shared memory and spills;
2. each kernel against its plain PyTorch version on the card, on its
   path's shapes and a mid-sequence state: A, B1 + B2, C, D, L (and L
   against C then D) on cornell, B1 and D (every level, on the frame's
   packed and unpacked layouts) equal bit for bit; C's band mode on a
   moving cornell camera; E and G on diamond (equal); F on diamond,
   bunny and room; H on cornell, bunny and room; F and H there plane by
   plane, through the scene's build and the kernel library's, no plane
   with more lanes off their plain versions than the per-lane scan they
   replaced had (LANES_OFF_ALLOWED); I, J (and J against A) and K on
   cornell and room; A, J and I output by output the same way, A on
   cornell's camera rays and bunny's bounce 2, J and I on cornell's and
   room's bounce 2 (the split engine), with I's lanes off its plain
   version counted; M output by output through both builds, the chunk
   cull on and off, on the trace bench's rays and on bunny's camera
   rays, and I on the trace bench's rays; B1's table build equal bit for
   bit to the per-scene build and the plain version on cornell, plane by
   plane; N, G at K = 29, O and P's rough (t, tri) equal bit for bit on
   the probes' inputs (O also to the numpy chain, through its staged
   kernel and, on two arrays of lines too long to stage, its global-load
   kernel; P with the cull on and off, its tests counted under the
   kernel's warp cull and the TPU's 512-ray block cull);
3. 32 frames per scene and engine (16 of room at 1920x1080) through
   ptdn_tpu_torch's Renderer with every launch count checked, finite
   outputs, and, where the camera is still, the RMSE against the
   converged ground truth (benchmarks/gt): denoised below half the raw
   1-spp RMSE on cornell and diamond, below the raw one elsewhere; the
   trace bench's three launches; 4 frames of the 65-geom scene, every
   one through B1's table build, finite, and the table build equal bit
   for bit to its plain version on that scene's primary state, plane by
   plane (geom indices up to 64), and so on the first frame of cornell
   with 1,025 materials and with a non-finite material constant (the
   build's other two causes); each probe script and
   reproj_bench run once, with its launches and its times (reproj_bench's
   parity printouts 0);
4. CUDA-event times: each kernel beside its plain version (G beside
   torch.gather, K beside torch.take) and its bound, D at level 1 and
   at each level of the frame; ms/frame of cornell
   (still, with fuse_reproject_l1, and moving with the flag off and on)
   and bunny through each of their engines, of diamond through the sort
   and through B1 (sort_rays=False), of room 600x600 through the sort and
   the fused and the split engines, and of room at 1920x1080 moving, in
   turns; F at bounce 2 of bunny and of room at 1920x1080, H at bounce 2
   of bunny and room, J at bounce 2 of cornell and room, A at bounce 2 of
   bunny and on room's primary hit at 1920x1080, I at bounce 2 of
   cornell, bunny and room (ptdn_tpu_torch/bounce_bench.py), each build
   in turns, with bound and launches; L on cornell in turns beside C
   alone and D at level 1 alone, with its pixels off C's then D's
   kernels; the trace bench's kernel times; B1's table build on the
   65-geom scene (its JSON line) and on cornell beside the per-scene
   build, and M on the trace bench's rays with the cull on and off and
   on bunny's camera rays, each build in turns (bounce_bench's cases);
   the 65-geom scene's ms/frame; an empty launch (the floor beside O's
   bound) and P's bound from the TPU's 512-ray block cull's tests beside
   the JSON line's, from the warp cull's (the work the kernel does).

The line before the last is a JSON object with every kernel's numbers;
the last is {"ok": true, "device": {...}}. Any failed check raises, so
the exit code is not 0 and no result line is printed. Needs one card.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ptdn_tpu_torch import bounce_bench as BB  # noqa: E402
from ptdn_tpu_torch import reproj_bench, trace_bench  # noqa: E402
from ptdn_tpu_torch.app.automate import CameraAutomation  # noqa: E402
from ptdn_tpu_torch.denoise import reproject, svgf  # noqa: E402
from ptdn_tpu_torch.engine import Renderer  # noqa: E402
from ptdn_tpu_torch.engine import wavefront as W  # noqa: E402
from ptdn_tpu_torch.ops.camera import generate_camera_rays  # noqa: E402
from ptdn_tpu_torch.ops.cuda import _lib  # noqa: E402
from ptdn_tpu_torch.ops.cuda import atrous as D  # noqa: E402
from ptdn_tpu_torch.ops.cuda import bounce as F  # noqa: E402
from ptdn_tpu_torch.ops.cuda import compact as K  # noqa: E402
from ptdn_tpu_torch.ops.cuda import dyngather as O  # noqa: E402
from ptdn_tpu_torch.ops.cuda import inrow as G  # noqa: E402
from ptdn_tpu_torch.ops.cuda import intersect_v1 as P  # noqa: E402
from ptdn_tpu_torch.ops.cuda import path as B  # noqa: E402
from ptdn_tpu_torch.ops.cuda import reproject as C  # noqa: E402
from ptdn_tpu_torch.ops.cuda import reproject_atrous as L  # noqa: E402
from ptdn_tpu_torch.ops.cuda import scene_intersect as A  # noqa: E402
from ptdn_tpu_torch.ops.cuda import shade as E  # noqa: E402
from ptdn_tpu_torch.ops.cuda import texgather as N  # noqa: E402
from ptdn_tpu_torch.probes import dyngather as probe_o  # noqa: E402
from ptdn_tpu_torch.probes import intersect_v1 as probe_p  # noqa: E402
from ptdn_tpu_torch.probes import regroup as probe_g  # noqa: E402
from ptdn_tpu_torch.probes import texgather as probe_n  # noqa: E402
from ptdn_tpu_torch.scene import Scene  # noqa: E402
from ptdn_tpu_torch.utils.assets import (scene_path,  # noqa: E402
                                         write_cornell_plus)
from ptdn_tpu_torch.utils.card import (ANALYTIC_OPS,  # noqa: E402
                                       MOLLER_OPS, REFINE_OPS, SHADE_OPS,
                                       bound, cuda_ms, nbytes,
                                       ptxas_summary)
from ptdn_tpu_torch.utils.config import RenderConfig  # noqa: E402

DEVICE = "cuda"
DEPTH = 8
FRAMES = 32
NLEVEL = 5
CFG = RenderConfig(trace_depth=DEPTH, denoise_enable=True,
                   temporal_enable=True, spatial_enable=True,
                   atrous_nlevel=NLEVEL)
# scene, resolution, ground truth; cornell takes the whole-path engine
SCENES = {"cornell": ((800, 800), "cornell_800x800_d8"),
          "diamond": ((800, 800), "diamond_800x800_d8"),
          "bunny": ((800, 800), "bunny_800x800_d8"),
          "room": ((600, 600), "room_600x600_d8"),
          "terrain30k": ((800, 800), "terrain30k_800x800_d8")}
# the flags of the two per-bounce engines (the JAX engines bounce_fused
# and bounce_pallas)
FUSED = dict(fuse_path=False, sort_rays=False)
SPLIT = dict(fuse_path=False, fuse_bounce=False)
# phase 3: (scene, flags); the defaults take the whole path on cornell
# and the sort on the mesh scenes
RUNS = ([(name, {}) for name in SCENES]
        + [(name, FUSED) for name in ("cornell", "room", "bunny")]
        + [(name, SPLIT) for name in ("cornell", "bunny", "room")])
# the camera-motion runs of phase 3: label -> (scene, flags, frames,
# resolution or None for the scene's own). ANIM_SLOW is
# tests/test_golden.py's cornell_svgf_anim_slow camera, ROOM_1080 bench.py's
# room_1080p_animated one (there with the flag off; on here, where its
# gate keeps L off all the same)
FUSE_L1 = dict(fuse_reproject_l1=True)
ANIM_SLOW = dict(automate_camera=True, camera_speed_theta=0.4,
                 camera_speed_phi=0.08)
ROOM_1080 = dict(automate_camera=True, camera_speed_x=0.02,
                 camera_speed_theta=0.01, camera_speed_phi=0.015)
MOTION_RUNS = {
    "fuse_l1": ("cornell", FUSE_L1, FRAMES, None),
    "anim_slow": ("cornell", ANIM_SLOW, FRAMES, None),
    "anim_slow_fuse_l1": ("cornell", dict(ANIM_SLOW, **FUSE_L1), FRAMES,
                          None),
    "1080p_animated": ("room", dict(ROOM_1080, **FUSE_L1), 16,
                            (1920, 1080)),
}
KERNELS = {  # name: (wrapper, source, TPU kernel it replaces)
    # A, J and M run one closest-hit chunk scan per block
    # (csrc/closest_hit.cuh over csrc/chunk_scan.cuh), their per-scene
    # build (the kernel library's, csrc/scene_intersect.cu, past its
    # limits)
    "scene_intersect_full": (A.scene_intersect_full,
                             "csrc/scene/scene_intersect.cu",
                             "ptdn_tpu/ops/pallas/scene_intersect.py:1478"),
    "path_trace": (B.path_trace, "csrc/scene/path_trace.cu",
                   "ptdn_tpu/ops/pallas/path.py:258"),
    "deferred_radiance": (B.deferred_radiance, "csrc/path.cu",
                          "ptdn_tpu/ops/pallas/path.py:239"),
    "back_projection_stencil": (C.back_projection_stencil,
                                "csrc/reproject.cu",
                                "ptdn_tpu/ops/pallas/reproject.py:194"),
    # C's band mode: the far branch, XLA code in the JAX package
    "back_projection_banded": (C.back_projection_banded,
                               "csrc/reproject.cu",
                               "ptdn_tpu/denoise/reproject.py:406"),
    "back_projection_atrous1": (
        L.back_projection_atrous1, "csrc/reproject_atrous.cu",
        "ptdn_tpu/ops/pallas/reproject_atrous.py:298"),
    "atrous_level": (D.atrous_level, "csrc/atrous.cu",
                     "ptdn_tpu/ops/pallas/atrous.py:275"),
    "shade_bounce": (E.shade_bounce, "csrc/shade.cu",
                     "ptdn_tpu/ops/pallas/shade.py:345"),
    # on textured scenes F also does the albedo fetch's texel route,
    # the TPU kernel uncompact_tiles_pallas. F and H run their per-scene
    # build (the kernel library's, csrc/bounce.cu, past its limits)
    "trace_bounce": (F.trace_bounce, "csrc/scene/bounce.cu",
                     "ptdn_tpu/ops/pallas/bounce.py:376, "
                     "ptdn_tpu/ops/pallas/path.py:239"),
    "inrow_permute": (G.inrow_permute, "csrc/inrow.cu",
                      "ptdn_tpu/ops/pallas/inrow.py:34"),
    "bounce_fused": (F.bounce_fused, "csrc/scene/bounce.cu",
                     "ptdn_tpu/ops/pallas/bounce.py:161"),
    # I: the any-hit half of the chunk scan alone (csrc/chunk_scan.cuh,
    # csrc/light_visibility.cuh), built with A and J
    "light_visibility": (A.light_visibility, "csrc/scene/scene_intersect.cu",
                         "ptdn_tpu/ops/pallas/scene_intersect.py:452"),
    # J: A's chunk scan and build, then the texel index
    "scene_intersect_full_tex": (
        A.scene_intersect_full_tex, "csrc/scene/scene_intersect.cu",
        "ptdn_tpu/ops/pallas/scene_intersect.py:1429"),
    "sparse_gather": (K.sparse_gather, "csrc/compact.cu",
                      "ptdn_tpu/ops/pallas/compact.py:181, "
                      "ptdn_tpu/ops/pallas/compact.py:207"),
    "scene_intersect": (A.scene_intersect, "csrc/scene/scene_intersect.cu",
                        "ptdn_tpu/ops/pallas/scene_intersect.py:1526"),
    # B1 built once into the library, its rows from tables (a path per
    # geom, a per-geom cull): the scenes past the per-scene build's
    # limits (counted in table_launches)
    "path_trace_table": (B.path_trace, "csrc/path_trace_table.cu",
                         "ptdn_tpu/ops/pallas/path.py:258"),
    # the TPU probes of benchmarks/, whose scripts are the only callers
    "gather_u32": (N.gather_u32, "csrc/texgather.cu",
                   "benchmarks/pallas_texgather.py:83"),
    # the probe's Pallas kernel computes G's function: G at its shape
    "inrow_permute_k29": (G.inrow_permute, "csrc/inrow.cu",
                          "benchmarks/micro_regroup.py:85"),
    "mesh_intersect_v1": (P.mesh_intersect_v1, "csrc/intersect_v1.cu",
                          "benchmarks/pallas_intersect_v1.py:109"),
    "take_chain": (O.take_chain, "csrc/dyngather.cu",
                   "benchmarks/micro_dyngather.py:19"),
}
# the counter of a kernel whose wrapper counts it apart from .launches
COUNTER = {"path_trace_table": "table_launches"}
# the run whose launch counts the kernels' JSON line reports
LAUNCH_RUN = {"scene_intersect_full": ("cornell", "whole_path"),
              "path_trace": ("cornell", "whole_path"),
              "deferred_radiance": ("cornell", "whole_path"),
              "back_projection_stencil": ("cornell", "whole_path"),
              "back_projection_banded": ("cornell", "anim_slow"),
              "back_projection_atrous1": ("cornell", "fuse_l1"),
              "atrous_level": ("cornell", "whole_path"),
              "shade_bounce": ("diamond", "sorted"),
              "trace_bounce": ("diamond", "sorted"),
              "inrow_permute": ("diamond", "sorted"),
              "bounce_fused": ("cornell", "bounce_fused"),
              "light_visibility": ("cornell", "bounce_split"),
              "scene_intersect_full_tex": ("cornell", "bounce_split"),
              "sparse_gather": ("cornell", "bounce_fused"),
              "scene_intersect": ("cornell", "trace_bench"),
              "path_trace_table": ("cornell65", "whole_path"),
              "gather_u32": ("probe", "texgather"),
              "inrow_permute_k29": ("probe", "regroup"),
              "mesh_intersect_v1": ("probe", "intersect_v1"),
              "take_chain": ("probe", "dyngather")}
# the one PyTorch call timed beside a kernel, where one computes its gather
LIBRARY = {"inrow_permute": "torch.gather", "sparse_gather": "torch.take",
           "gather_u32": "torch.take", "inrow_permute_k29": "torch.gather"}
# the generated scene past B1's per-scene build: cornell plus 55 cubes
# (65 geoms), rendered this many frames at cornell's resolution; the
# build's other causes, cornell's geoms with 1,025 materials or with a
# material constant that is not finite (utils/assets.py)
CUBES, CUBE_FRAMES = 55, 4
CAUSES = {"1,025 materials": dict(materials=1016),
          "a non-finite constant": dict(materials=1, refrior="inf")}
# float operations of one plane-form lane-triangle test of kernel P: six
# 4-term dots, a division, two FMAs, the compares (the other counts and
# the card's peaks are utils/card.py's)
PLANE_OPS = 60
# lanes of F, H, A, J and I that differ from their plain versions on any
# one output: what the per-lane scans they replaced counted at bounce 2
# of diamond, bunny and room (F), cornell, bunny and room (H), cornell
# and room (J), bunny (A) and cornell, bunny and room (I), and on the
# camera rays of cornell and room (A) (bounce_bench, PERF.md), the most
# the per-output checks allow
LANES_OFF_ALLOWED = 0


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nonzero(c):
    """The launch counts of c that are not 0."""
    return {k: v for k, v in c.items() if v}


def printable(x):
    """x with every dict key a string, for json.dumps."""
    if isinstance(x, dict):
        return {str(k): printable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [printable(v) for v in x]
    return x


def max_abs(a, b) -> float:
    """The largest |a - b| over the lanes where it is finite."""
    d = (a.double() - b.double()).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def same(a, b) -> bool:
    """Equal lane for lane, NaN where NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def floats_close(a, b) -> bool:
    """Each float tensor of a within 1e-6 (absolute and relative) of b's,
    D's agreement with its plain version."""
    return all(torch.allclose(x, y, rtol=1e-6, atol=1e-6)
               for x, y in zip(a, b))


def n_analytic(gi) -> int:
    return sum(1 for t in gi.types if t != 2)


@functools.cache
def scene(name):
    return Scene(scene_path(name))


def renderer(name, res=None, **kw):
    return Renderer(scene(name), dataclasses.replace(CFG, **kw),
                    resolution=res or SCENES[name][0], device=DEVICE)


def renderer_of(path, **kw):
    """A renderer of the scene file `path` at cornell's resolution."""
    return Renderer(Scene(str(path)), dataclasses.replace(CFG, **kw),
                    resolution=SCENES["cornell"][0], device=DEVICE)


class Motion:
    """Drives a renderer's frames, moving its camera by CameraAutomation
    where its config says so, and records each frame's reprojection
    branch as motion_bounds decides it (read after the run: the wrap adds
    no host read)."""

    def __init__(self, r):
        self.r, self.auto = r, CameraAutomation(r.cfg)
        self.calls, self.moved = [], []

    def frame(self):
        moved = self.auto.step(self.r.camera)
        if moved:
            self.r.cam_changed = True
        self.moved.append(moved or self.r.cam_changed)
        real = svgf.motion_bounds

        def spy(*args):
            out = real(*args)
            self.calls.append((len(self.moved) - 1, out))
            return out
        svgf.motion_bounds = spy
        try:
            return self.r.render_frame()
        finally:
            svgf.motion_bounds = real

    def near_frames(self):
        """Per frame, whether it took the near branch (the last decision
        made up to it)."""
        decided = {k: bool(b[0]) for k, b in self.calls}
        near, out = None, []
        for k in range(len(self.moved)):
            near = decided.get(k, near)
            out.append(near)
        return out


def reset_counts():
    for name, (wrapper, _, _) in KERNELS.items():
        setattr(wrapper, COUNTER.get(name, "launches"), 0)


def counts():
    return {name: getattr(k[0], COUNTER.get(name, "launches"))
            for name, k in KERNELS.items()}


def b1_args(r, frame: int = 3):
    """Kernel B1's arguments on renderer r's primary state (its last
    frame's primary-hit cache and camera rays), as the whole-path engine
    passes them: (ds, gi, prim, frame, lane0, depth, light, flags)."""
    tr = r.step.tracer
    o, d = generate_camera_rays(r._cam[0], r.resolution)
    prim = dict({k: getattr(tr, "pcache_" + k) for k in W.PCACHE_KEYS},
                o=o, d=d)
    light = dict(tr.light, radius=float(r.cfg.light_radius),
                 intensity=float(r.cfg.shadow_intensity))
    return (tr.ds, tr.gi, prim, frame, 0, r.cfg.trace_depth, light, tr.flags)


def b1_plain(args):
    """B1's plain version on b1_args' arguments."""
    ds, gi, prim, frame, lane0, depth, light, flags = args
    return B.path_trace_plain(ds, gi, prim, frame=frame, lane0=lane0,
                              depth=depth, light=light, flags=flags)


def expected_launches(r, motion):
    """The launches of every kernel over the frames that `motion` (a
    Motion) drove renderer r through: the primary hit on every frame
    whose camera moved (frame 0 among them), the engine's bounces, C's
    stencil mode (or L, with fuse_reproject_l1 through its gate) on the
    near frames and C's band mode on the others, and D at every level
    but the first that L takes."""
    tr, frames = r.step.tracer, len(motion.moved)
    near = sum(motion.near_frames())
    fused = r.step.denoiser.fuse_l1
    want = dict.fromkeys(KERNELS, 0)
    want["scene_intersect_full"] = sum(motion.moved)
    want["back_projection_banded"] = frames - near
    want["back_projection_atrous1" if fused
         else "back_projection_stencil"] = near
    want["atrous_level"] = frames * NLEVEL - (near if fused else 0)
    bounces, below_last = frames * DEPTH, frames * (DEPTH - 1)
    tex = tr.flags["show_tex"]
    if tr.engine == "whole_path":
        # the per-scene build where the scene has one, else the table's
        b1 = "path_trace" if tr.gi.path_scene else "path_trace_table"
        want[b1] = want["deferred_radiance"] = frames
    elif tr.engine == "sorted":
        want["shade_bounce"] = want["trace_bounce"] = bounces
        want["inrow_permute"] = bounces if tr.regroup > 1 else 0
    elif tr.engine == "bounce_fused":
        want["bounce_fused"] = bounces
        want["sparse_gather"] = below_last if tex else 0
    else:
        want["shade_bounce"] = want["light_visibility"] = bounces
        if tex:
            want["scene_intersect_full_tex"] = below_last
            want["sparse_gather"] = below_last
        else:
            want["scene_intersect_full"] += below_last
    # G at the regroup probe's shape is G: the two rows share its counter
    want["inrow_permute_k29"] = want["inrow_permute"]
    return want


def rmse_vs_gt(name, left, right):
    gt = np.clip(np.load(os.path.join(ROOT, "benchmarks", "gt",
                                      SCENES[name][1] + ".npz"))["gt"], 0, 1)
    raw = np.clip(left.cpu().numpy(), 0, 1).astype(np.float64)
    dn = np.clip(right.cpu().numpy(), 0, 1).astype(np.float64)
    return (float(np.sqrt(np.mean((dn - gt) ** 2))),
            float(np.sqrt(np.mean((raw - gt) ** 2))))


def plane_check(kernel, label, args, kw, got, ref):
    """Kernel F, H, A, J or I (bounce_bench's `kernel`) against its plain
    version's output `ref` plane by plane (A's, J's and I's: output by
    output), through both builds (`got`: the scene's own, from the
    wrapper; then the kernel library's, launched here): no plane may have
    more differing lanes than the per-lane scan had. Returns the
    per-plane counts of the two builds."""
    ds, gi, *rest = args
    lib = BB.kernel_fn(kernel)(ds, gi._replace(path_scene=None), *rest,
                               **kw)
    ref = BB.out_planes(kernel, ref)
    out = {build: BB.plane_diffs(BB.out_planes(kernel, g), ref)
           for build, g in (("scene", got), ("library", lib))}
    for build, diffs in out.items():
        check(max(diffs.values()) <= LANES_OFF_ALLOWED,
              f"{label}, {build} build: lanes differing by plane {diffs} "
              f"(per-lane scan: at most {LANES_OFF_ALLOWED})")
    print(f"phase 2: {label}: lanes differing from the plain version on "
          f"any of {len(ref)} planes: scene build "
          f"{max(out['scene'].values())}, library build "
          f"{max(out['library'].values())} (per-lane scan: "
          f"{LANES_OFF_ALLOWED})")
    return out


def f_agreement(kf, pf):
    """Lanes where F and its plain version hit the same material with the
    same liveness; the max |d| of t, normal and uv there; and the share
    of lanes whose lit radiance agrees."""
    agree = (kf[F.B_MAT] == pf[F.B_MAT]) & (kf[F.B_ACT] == pf[F.B_ACT])
    err = max(max_abs(kf[k][agree], pf[k][agree])
              for k in (F.B_T, F.B_NX, F.B_NY, F.B_NZ, F.B_UU, F.B_VV))
    lit = ((kf[F.B_RR:F.B_RB + 1] == pf[F.B_RR:F.B_RB + 1])
           | torch.isnan(pf[F.B_RR:F.B_RB + 1])).all(dim=0)
    return float(agree.float().mean()), err, float(lit.float().mean())


def main():
    t_all = time.perf_counter()
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
    regs = ptxas_summary(log)
    # O has two kernels: the staged one and the global-load one
    check(len(regs) == 20, f"20 kernels in the library, got {regs}")
    # kernels B1, F, H, A, J, I and M (with and without the cull) are
    # built per scene, with the scene's constants (csrc/scene/*.cu), every
    # scene's at once
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SCENES)) as pool:
        scene_logs = dict(zip(SCENES, pool.map(
            lambda name: _lib.build_scene(A.geom_info(
                scene(name), DEVICE).path_scene, force=True)[1], SCENES)))
    t_scene = time.perf_counter() - t1
    scene_regs = {name: ptxas_summary(lg) for name, lg in scene_logs.items()}
    check(all(len(r) == 8 for r in scene_regs.values()),
          f"8 kernels per scene, got {scene_regs}")
    print(f"phase 1: built {len(list(_lib.CSRC.glob('*.cu')))} sources for "
          f"sm_90a in {t1 - t0:.1f} s, then B1, F, H, A, J, I and M for "
          f"each of {len(SCENES)} scenes (csrc/scene/path_trace.cu, "
          f"bounce.cu, scene_intersect.cu) in {t_scene:.1f} s; ptxas, the "
          f"library: "
          + "; ".join(regs))
    for name, r in scene_regs.items():
        print(f"phase 1: ptxas, {name}'s build: " + "; ".join(r))

    # ---- phase 2: kernels against their plain versions ----
    t0 = time.perf_counter()
    stats, work = {}, {}
    warm = renderer("cornell")
    for _ in range(3):
        warm.render_frame()
    tr = warm.step.tracer
    ds, gi = tr.ds, tr.gi
    res = warm.resolution
    cam, view = warm._cam
    o, d = generate_camera_rays(cam, res)
    n = res[0] * res[1]

    ka = A._scene_intersect_full_kernel(ds, gi, o, d)
    A.mesh_best.tri_tests = 0
    pa = A.scene_intersect_full_plain(ds, gi, o, d)
    a_tests = A.mesh_best.tri_tests
    agree = ka["geom_id"] == pa["geom_id"]
    frac = float(agree.float().mean())
    close = all(torch.allclose(ka[k][agree], pa[k][agree], rtol=1e-5,
                               atol=1e-5) for k in ("t", "normal", "uv"))
    stats["scene_intersect_full"] = max(
        max_abs(ka[k][agree], pa[k][agree]) for k in ("t", "normal", "uv"))
    check(frac >= 0.999 and close, f"A: geom agreement {frac}")
    work["scene_intersect_full"] = bound(
        nbytes(o, d, *ka.values()),
        n * (n_analytic(gi) * ANALYTIC_OPS + REFINE_OPS)
        + a_tests * MOLLER_OPS)
    print(f"phase 2: A geom_id agreement {frac:.6f}, max |d| on agreeing "
          f"lanes {stats['scene_intersect_full']:.3g}")
    plane_check("scene_intersect_full", "A on cornell's camera rays",
                (ds, gi, o, d), {}, ka, pa)

    bargs = b1_args(warm)
    kc, kt = B._path_trace_kernel(*bargs)
    A.mesh_best.tri_tests = A.light_visible.tri_tests = 0
    pc, pt = b1_plain(bargs)
    b_tests = A.mesh_best.tri_tests + A.light_visible.tri_tests
    krad = B._deferred_radiance_kernel(ds, kc, kt, DEPTH)
    prad = B.deferred_radiance_plain(ds, pc, pt, DEPTH)
    diff = (krad - prad).abs().max(dim=-1).values
    bfrac = float((diff > 1e-3).float().mean())
    brmse = float(((krad - prad) ** 2).mean().sqrt())
    stats["path_trace"] = max_abs(kc, pc)
    stats["deferred_radiance"] = max_abs(
        B._deferred_radiance_kernel(ds, pc, pt, DEPTH), prad)
    check(bfrac < 0.01 and brmse < 0.012, f"B1+B2: frac {bfrac} rmse {brmse}")
    check(same(kc, pc) and torch.equal(kt, pt),
          f"B1 equals its plain version: max |d| {stats['path_trace']}")
    b_kw = dict(zip(("frame", "lane0", "depth", "light", "flags"),
                    bargs[3:]))
    work["path_trace"] = BB.b1_work(bargs[:3], b_kw, kc, kt, b_tests)
    textured = int((kt >= 0).sum())
    work["deferred_radiance"] = bound(nbytes(kc, kt, krad) + 4 * textured,
                                      n * DEPTH * 15)
    print(f"phase 2: B1+B2 pixels |d|>1e-3 {bfrac:.6f}, RMSE {brmse:.3g}; "
          f"B1 contributions max |d| {stats['path_trace']:.3g}; texel "
          f"indices equal {float((kt == pt).float().mean()):.6f}; B2 alone "
          f"max |d| {stats['deferred_radiance']:.3g}")

    w, h = res
    st = warm.step.frame_state()
    rad, gb = tr(cam, warm._params, 3, False)
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    raw = rad.reshape(h, w, 3)
    prev = {"position": st["prev_position"], "normal": st["prev_normal"],
            "geom_id": st["prev_geom_id"]}
    cargs = (res, raw, gb, prev, st["prev_view"], st["color_history"],
             st["moment_history"], st["history_length"],
             float(CFG.color_alpha), float(CFG.moment_alpha))
    check(bool(reproject.motion_bounds(res, gb, st["prev_view"])[0]),
          "C: a static camera is in the stencil domain")
    kcr = C._back_projection_stencil_kernel(*cargs)
    pcr = C.back_projection_stencil_plain(*cargs)
    stats["back_projection_stencil"] = max(max_abs(a, b)
                                           for a, b in zip(kcr, pcr))
    check(all(torch.allclose(a.double(), b.double(), rtol=1e-5, atol=1e-5)
              for a, b in zip(kcr, pcr)), "C: allclose 1e-5")
    work["back_projection_stencil"] = bound(
        nbytes(raw, gb["position"], gb["normal"], gb["geom_id"],
               *prev.values(), st["color_history"], st["moment_history"],
               st["history_length"], *kcr), n * 200)
    print(f"phase 2: C max |d| {stats['back_projection_stencil']:.3g}")

    # D at every level as the frame runs it: the packed G-buffer, level 1
    # on C's output and feeding the color history, levels 2-4 passing
    # their color and variance on packed, the last level with the albedo
    # back to the SVGF layout
    sig = (float(CFG.sigma_l), float(CFG.sigma_n), float(CFG.sigma_x))
    static = D.pack_static_planes(gb["position"], gb["normal"])
    albedo = ((gb["albedo"] * gb["ialbedo"]).contiguous()
              if CFG.sep_color and CFG.add_color else None)
    d_args, src, var, dmax = [], pcr[1], pcr[0], 0.0
    for level in range(1, NLEVEL + 1):
        last = level == NLEVEL
        dargs = (src, var, static, albedo if last else None, level, *sig,
                 CFG.blur_variance, not (last or level == CFG.history_level))
        kd = D._atrous_level_kernel(*dargs)
        pd = D.atrous_level_plain(*dargs)
        check(same(kd[0], pd[0]) and same(kd[1], pd[1]),
              f"D level {level} equals its plain version: max |d| "
              f"{max_abs(kd[0], pd[0])}, {max_abs(kd[1], pd[1])}")
        dmax = max(dmax, max_abs(kd[0], pd[0]), max_abs(kd[1], pd[1]))
        d_args.append(dargs)
        src, var = pd
    stats["atrous_level"] = dmax
    # the work of one level, counted on the SVGF layout whatever the
    # kernel's: color, variance, position and normal in, color and
    # variance out, 25 taps of ~40 operations a pixel
    work["atrous_level"] = bound(
        nbytes(pcr[1], pcr[0], gb["position"], gb["normal"], pcr[1],
               pcr[0]), n * 25 * 40)
    print(f"phase 2: D levels 1-{NLEVEL} max |d| {dmax:.3g} (packed "
          f"levels {[a[4] for a in d_args if a[-1]]})")

    # L on the same state: against its plain version, and against C's
    # then D's kernels (the same code, so equal bit for bit)
    largs = cargs + (*sig, CFG.blur_variance, static)
    kl = L._back_projection_atrous1_kernel(*largs)
    pl_ = L.back_projection_atrous1_plain(*largs)
    kd1 = D._atrous_level_kernel(kcr[1], kcr[0], static, None, 1, *sig,
                                 CFG.blur_variance)
    stats["back_projection_atrous1"] = max(max_abs(a, b)
                                           for a, b in zip(kl, pl_))
    check(floats_close(kl[:3], pl_[:3]) and torch.equal(kl[3], pl_[3]),
          f"L against its plain version: max |d| "
          f"{stats['back_projection_atrous1']}")
    check(all(same(a, b) for a, b in zip(kl, kd1 + kcr[2:])),
          "L equals C's then D's kernels")
    work["back_projection_atrous1"] = BB.l_work(largs, kl)
    print(f"phase 2: L max |d| {stats['back_projection_atrous1']:.3g}, "
          f"equal to C then D (kernels) on every pixel")

    # C's band mode on a moving camera: the last of the first four frames
    # of cornell_svgf_anim_slow's camera that takes it, its arguments
    # captured from the frame
    mov = Motion(renderer("cornell", **ANIM_SLOW))
    real_banded, got = reproject.back_projection_banded, []
    reproject.back_projection_banded = (
        lambda *a, starts: got.append(a + (starts, reproject.BAND_ROWS,
                                           reproject.BAND_MARGIN))
        or real_banded(*a, starts=starts))
    try:
        for _ in range(4):
            mov.frame()
    finally:
        reproject.back_projection_banded = real_banded
    check(len(got) > 1, "C's band mode runs on a moving camera's frames")
    bargs_c = got[-1]
    kb = C._back_projection_banded_kernel(*bargs_c)
    pb = C.back_projection_banded_plain(*bargs_c)
    stats["back_projection_banded"] = max(max_abs(a, b)
                                          for a, b in zip(kb, pb))
    rejected = int((kb[3] == 1).sum())
    check(floats_close(kb[:3], pb[:3]) and torch.equal(kb[3], pb[3]),
          f"C's band mode against its plain version: max |d| "
          f"{stats['back_projection_banded']}")
    cur_gb, prev_gb = bargs_c[2], bargs_c[3]
    work["back_projection_banded"] = bound(
        nbytes(bargs_c[1], cur_gb["position"], cur_gb["normal"],
               cur_gb["geom_id"], prev_gb["normal"], prev_gb["geom_id"],
               *bargs_c[5:8], bargs_c[10], *kb), n * 200)
    print(f"phase 2: C band mode on a moving camera max |d| "
          f"{stats['back_projection_banded']:.3g}, histories equal; "
          f"{rejected} pixels restart their history")

    # M on the trace bench's rays and on bunny's camera rays, with and
    # without the chunk cull, output by output through both builds
    tb_args = trace_bench.setup(DEVICE)
    cam_r = renderer("bunny")
    cam_r.render_frame()
    m_cases = {"the trace bench's rays": tb_args,
               "bunny's camera rays": (cam_r.step.tracer.ds,
                                       cam_r.step.tracer.gi,
                                       *generate_camera_rays(
                                           cam_r._cam[0], cam_r.resolution))}
    for label, m_args in m_cases.items():
        for cull in (True, False):
            km = A._scene_intersect_kernel(*m_args, cull)
            A.mesh_best.tri_tests = 0
            pm = A.scene_intersect_plain(*m_args, cull)
            m_tests = A.mesh_best.tri_tests
            plane_check("scene_intersect", f"M on {label}, cull {cull}",
                        m_args, {"cull": cull}, km, pm)
            if cull and m_args is tb_args:
                stats["scene_intersect"] = max(
                    max_abs(km[k], pm[k]) for k in ("t_a", "normal_a",
                                                    "t_m"))
                work["scene_intersect"] = bound(
                    nbytes(*tb_args[2:], *km.values()),
                    tb_args[2].shape[0] * n_analytic(tb_args[1])
                    * ANALYTIC_OPS + m_tests * MOLLER_OPS)
            print(f"phase 2: M on {m_args[2].shape[0]} of {label}, cull "
                  f"{cull}: {m_tests} lane-triangle tests in the plain "
                  f"scan, {int((km['tri_m'] >= 0).sum())} mesh hits")
    # I on the same rays (light geom 0), through both builds
    tb_i = tb_args + (trace_bench.LIGHT_GEOM,)
    A.light_visible.tri_tests = 0
    p_tb = A.light_visibility_plain(*tb_i)
    plane_check("light_visibility", "I on the trace bench's rays", tb_i, {},
                A._light_visibility_kernel(*tb_i), p_tb)
    print(f"phase 2: I on {tb_args[2].shape[0]} trace-bench rays: "
          f"{int(p_tb.sum())} lit, {A.light_visible.tri_tests} "
          f"lane-triangle tests in the plain scan")

    # the sorted wavefront, mid-sequence: bounce 2 of frame 4
    mesh = {}
    for name in ("diamond", "bunny", "room"):
        r = renderer(name)
        for _ in range(3):
            r.render_frame()
        mesh[name] = (r, BB.capture_bounce(
            r, 2, ("shade_bounce", "trace_bounce", "inrow_permute")))
    dr, cap = mesh["diamond"]
    (e_planes, e_mats), e_kw = cap["shade_bounce"]
    ke = E._shade_bounce_kernel(e_planes, e_mats, **e_kw)
    pe = E.shade_bounce_plain(e_planes, e_mats, **e_kw)
    stats["shade_bounce"] = max_abs(ke, pe)
    check(same(ke, pe), "E equals its plain version")
    work["shade_bounce"] = bound(nbytes(e_planes, ke),
                                 ke[0].numel() * SHADE_OPS)
    (g_planes, g_order), _ = cap["inrow_permute"]
    kg = G._inrow_permute_kernel(g_planes, g_order)
    pg = G.inrow_permute_plain(g_planes, g_order)
    stats["inrow_permute"] = max_abs(kg, pg)
    check(same(kg, pg), "G equals its plain version")
    work["inrow_permute"] = bound(nbytes(g_planes, g_order, kg), 0)
    print(f"phase 2: diamond bounce 2: E equal on "
          f"{tuple(e_planes.shape)} planes; G equal on "
          f"{tuple(g_planes.shape)} planes")
    for name, (r, cap) in mesh.items():
        (fds, fgi, f_planes), f_kw = cap["trace_bounce"]
        check(f_kw["show_tex"] == (name == "room"),
              f"F takes textures on room only, not on {name}")
        kf, kalb = F._trace_bounce_kernel(fds, fgi, f_planes, **f_kw)
        A.mesh_best.tri_tests = A.light_visible.tri_tests = 0
        pf, palb = F.trace_bounce_plain(fds, fgi, f_planes, **f_kw)
        f_tests = A.mesh_best.tri_tests + A.light_visible.tri_tests
        agree, err, lit = f_agreement(kf, pf)
        alb_eq = float((kalb == palb).all(dim=0).float().mean())
        check(agree >= 0.999 and err <= 1e-5 and lit >= 0.999
              and alb_eq >= 0.999, f"F on {name}: agree {agree} err {err} "
              f"lit {lit} albedo {alb_eq}")
        if name == "diamond":
            stats["trace_bounce"] = max(err, max_abs(
                kf[F.B_RR:F.B_RB + 1], pf[F.B_RR:F.B_RB + 1]))
            lanes = kf[0].numel()
            work["trace_bounce"] = bound(
                nbytes(f_planes, kf, kalb),
                lanes * (2 * n_analytic(fgi) * ANALYTIC_OPS + REFINE_OPS)
                + f_tests * MOLLER_OPS)
        print(f"phase 2: F on {name} bounce 2: hits agree {agree:.6f}, "
              f"max |d| there {err:.3g}, lit agree {lit:.6f}, next albedo "
              f"equal on {alb_eq:.6f} of lanes, {f_tests} lane-triangle "
              f"tests in the plain scan")
        plane_check("trace_bounce", f"F on {name} bounce 2",
                    (fds, fgi, f_planes), f_kw, (kf, kalb), (pf, palb))

    # the per-bounce engines, mid-sequence: bounce 2 of frame 4. H on
    # cornell (the textured wall), bunny (39 chunks, every lane scans
    # every chunk its rays cross) and room (22 chunks, two textures)
    shading = (F.B_SPX, F.B_SPY, F.B_SPZ, F.B_DX, F.B_DY, F.B_DZ, F.B_TR,
               F.B_TG, F.B_TB, F.B_DIF)
    h_cases = {}
    for name in ("cornell", "bunny", "room"):
        r = renderer(name, **FUSED)
        for _ in range(3):
            r.render_frame()
        (hds, hgi, h_planes), h_kw = BB.capture_bounce(
            r, 2, ("bounce_fused",))["bounce_fused"]
        kh = F._bounce_fused_kernel(hds, hgi, h_planes, **h_kw)
        A.mesh_best.tri_tests = A.light_visible.tri_tests = 0
        ph = F.bounce_fused_plain(hds, hgi, h_planes, **h_kw)
        h_tests = A.mesh_best.tri_tests + A.light_visible.tri_tests
        agree, err, lit = f_agreement(kh, ph)
        shade_eq = all(same(kh[k], ph[k]) for k in shading)
        check(shade_eq and agree >= 0.999 and err <= 1e-5 and lit >= 0.999,
              f"H on {name}: shading equal {shade_eq} agree {agree} err "
              f"{err} lit {lit}")
        if name == "cornell":
            stats["bounce_fused"] = max(err, max_abs(
                kh[F.B_RR:F.B_RB + 1], ph[F.B_RR:F.B_RB + 1]))
            work["bounce_fused"] = bound(
                nbytes(h_planes, kh),
                kh[0].numel() * (SHADE_OPS + 2 * n_analytic(hgi)
                                 * ANALYTIC_OPS + REFINE_OPS)
                + h_tests * MOLLER_OPS)
            h_args = (hds, hgi, h_planes, h_kw)
        print(f"phase 2: H on {name} bounce 2: shading planes equal, hits "
              f"agree {agree:.6f}, max |d| there {err:.3g}, lit agree "
              f"{lit:.6f}, {h_tests} lane-triangle tests in the plain scan")
        plane_check("bounce_fused", f"H on {name} bounce 2",
                    (hds, hgi, h_planes), h_kw, kh, ph)
        h_cases[name] = ((hds, hgi, h_planes), h_kw)

    # I, J (and J against A) and K on cornell and room, through the split
    # engine's bounce 2
    j_cases, i_cases = {}, {}
    for name in ("cornell", "room"):
        r = renderer(name, **SPLIT)
        for _ in range(3):
            r.render_frame()
        scap = BB.capture_bounce(r, 2, ("light_visibility",
                                        "scene_intersect_full_tex"))
        i_args = tuple(scap["light_visibility"][0])
        k_i = A._light_visibility_kernel(*i_args)
        A.light_visible.tri_tests = 0
        p_i = A.light_visibility_plain(*i_args)
        i_tests = A.light_visible.tri_tests
        i_off = int((k_i != p_i).sum())
        j_args = tuple(scap["scene_intersect_full_tex"][0])
        kj, jt = A._scene_intersect_full_tex_kernel(*j_args)
        A.mesh_best.tri_tests = 0
        pj, pjt = A.scene_intersect_full_tex_plain(*j_args)
        j_tests = A.mesh_best.tri_tests
        ka2 = A._scene_intersect_full_kernel(*j_args)
        j_is_a = all(same(kj[k], ka2[k]) for k in ka2)
        j_agree = kj["geom_id"] == pj["geom_id"]
        j_err = max(max_abs(kj[k][j_agree], pj[k][j_agree])
                    for k in ("t", "normal", "uv"))
        t_eq = bool(torch.equal(jt[j_agree], pjt[j_agree]))
        jds_ = j_args[0]
        table = jds_.tex_flat_u32.view(torch.int32)
        k_args = (table, jt, kj["mat_id"], jds_.mat_attr)
        kk = K._sparse_gather_kernel(*k_args)
        pk = K.sparse_gather_plain(*k_args)
        k_eq = same(kk, pk)
        frac = float(j_agree.float().mean())
        check(j_is_a and frac >= 0.999 and j_err <= 1e-5 and t_eq and k_eq,
              f"J, K on {name}: J is A {j_is_a} J agree {frac} "
              f"err {j_err} texel index {t_eq} K {k_eq}")
        if name == "cornell":
            stats["light_visibility"] = float((k_i != p_i).any())
            stats["scene_intersect_full_tex"] = j_err
            stats["sparse_gather"] = max_abs(kk, pk)
            rays = kj["t"].numel()
            work["light_visibility"] = bound(
                nbytes(*i_args[2:4], k_i),
                rays * n_analytic(i_args[1]) * ANALYTIC_OPS
                + i_tests * MOLLER_OPS)
            work["scene_intersect_full_tex"] = bound(
                nbytes(*j_args[2:4], kj["t"], kj["normal"], kj["uv"],
                       kj["mat_id"], kj["geom_id"], jt),
                rays * (n_analytic(j_args[1]) * ANALYTIC_OPS + REFINE_OPS)
                + j_tests * MOLLER_OPS)
            work["sparse_gather"] = bound(
                nbytes(jt, kj["mat_id"], kk) + 4 * int((jt >= 0).sum()),
                rays * 6)
            ijk_args = (i_args, j_args, k_args)
            take_idx = jt.clamp(min=0).to(torch.int64)
        print(f"phase 2: {name} split bounce 2: I off its plain version on "
              f"{i_off} of {k_i.numel()} shadow rays ({i_tests} "
              f"lane-triangle tests, {int(p_i.sum())} lit); "
              f"J equals A on every lane, agrees with its plain version on "
              f"{frac:.6f} (max |d| {j_err:.3g}, texel index equal there); "
              f"K equal on every lane, {int((jt >= 0).sum())} textured")
        plane_check("scene_intersect_full_tex", f"J on {name} bounce 2",
                    j_args, {}, (kj, jt), (pj, pjt))
        plane_check("light_visibility", f"I on {name} bounce 2", i_args, {},
                    k_i, p_i)
        j_cases[name] = (j_args, {})
        i_cases[name] = (i_args, {})
    # A on bunny's bounce 2 through the split engine (39 chunks)
    r = renderer("bunny", **SPLIT)
    for _ in range(3):
        r.render_frame()
    bcap = BB.capture_bounce(r, 2, ("scene_intersect_full",
                                    "light_visibility"))
    a_case = bcap["scene_intersect_full"]
    i_cases["bunny"] = bcap["light_visibility"]
    A.mesh_best.tri_tests = 0
    pab = A.scene_intersect_full_plain(*a_case[0])
    plane_check("scene_intersect_full", "A on bunny bounce 2 (split)",
                a_case[0], {}, A._scene_intersect_full_kernel(*a_case[0]),
                pab)
    print(f"phase 2: A on bunny bounce 2: {A.mesh_best.tri_tests} "
          f"lane-triangle tests in the plain scan, "
          f"{int((pab['geom_id'] >= 0).sum())} hits")

    # B1's table build on the same cornell state: equal to the per-scene
    # build and to the plain version (the same rows, from device memory);
    # phase 3 checks it on the 65-geom scene it serves
    gi_table = gi._replace(path_scene=None)
    tc, tt = B._path_trace_kernel(ds, gi_table, *bargs[2:])
    off = {ref: BB.plane_diffs(BB.out_planes("path_trace_table", (tc, tt)),
                               BB.out_planes("path_trace_table", planes))
           for ref, planes in (("per-scene", (kc, kt)), ("plain", (pc, pt)))}
    check(all(max(d.values()) == 0 for d in off.values()),
          f"B1's table build equals the per-scene build and the plain "
          f"version on cornell on every plane: lanes off {off}")
    print(f"phase 2: B1's table build equals the per-scene build and the "
          f"plain version on cornell on each of {len(off['plain'])} planes, "
          f"bit for bit")

    # N on the texgather probe's four tables and index orders
    n_cases = probe_n.cases(DEVICE)
    for label, (table, idx) in n_cases.items():
        kn = N._gather_u32_kernel(table, idx)
        check(torch.equal(kn.view(torch.int32), N.gather_u32_plain(
            table, idx).view(torch.int32)), f"N on {label} equals its "
              f"plain version")
    stats["gather_u32"] = 0.0
    n_args = n_cases["room random"]
    work["gather_u32"] = bound(
        nbytes(n_args[1], kn) + 4 * torch.unique(n_args[1]).numel(), 0)
    print(f"phase 2: N equal on {', '.join(n_cases)} "
          f"({probe_n.N} indices)")

    # G at the regroup probe's K = 29 planes of 5,120 rows
    g29_planes, g29_key, _, _ = probe_g.inputs(DEVICE)
    g29_order = probe_g.argsort_rows(g29_key)
    kg29 = G._inrow_permute_kernel(g29_planes, g29_order)
    check(same(kg29, G.inrow_permute_plain(g29_planes, g29_order)),
          "G at K = 29 equals its plain version")
    stats["inrow_permute_k29"] = 0.0
    work["inrow_permute_k29"] = bound(nbytes(g29_planes, g29_order, kg29), 0)
    print(f"phase 2: G equal on {tuple(g29_planes.shape)} planes")

    # O on the dyngather probe's 16 cases and its 4 timed chains (the
    # staged kernel), and on lines too long to stage (the global-load
    # kernel), against its plain version and the numpy chain
    for case in probe_o.LONG + probe_o.CASES + probe_o.TIMED:
        long_line = case in probe_o.LONG
        check((O.tile_plan(*case[:3])[0] == 0) == long_line,
              f"O on {case} takes the "
              f"{'global-load' if long_line else 'staged'} kernel")
        x_np, i_np = probe_o.inputs(*case[:3])
        o_x, o_idx = (torch.from_numpy(a).to(DEVICE) for a in (x_np, i_np))
        ko = O._take_chain_kernel(o_x, o_idx, *case[2:])
        check(torch.equal(ko, O.take_chain_plain(o_x, o_idx, *case[2:]))
              and np.array_equal(ko.cpu().numpy(), probe_o.numpy_chain(
                  x_np, i_np, *case[2:])), f"O on {case} equals its plain "
              f"version and the numpy chain")
    o_args = (o_x, o_idx, *probe_o.TIMED[-1][2:])
    stats["take_chain"] = 0.0
    work["take_chain"] = bound(nbytes(o_x, o_idx, ko), 0)
    print(f"phase 2: O equal on {len(probe_o.CASES)} cases, "
          f"{len(probe_o.TIMED)} chains of {probe_o.TIMED[0][3]} (staged "
          f"kernel) and {len(probe_o.LONG)} arrays of lines too long to "
          f"stage {[c[:3] for c in probe_o.LONG]} (global-load kernel)")

    # P's rough (t, tri) on the intersect_v1 probe's rays, cull on and
    # off; its bound from the tests of the kernel's warp cull (the JSON
    # line's: the work this run's rays need), and beside it from those of
    # the TPU's 512-ray block cull
    p_cases = probe_p.cases(DEVICE)
    for label, (_, ptab, _, p_o, p_d) in p_cases.items():
        for cull in (True, False):
            kt_p, ki_p = P._mesh_intersect_v1_kernel(ptab, p_o, p_d, cull)
            P.mesh_intersect_v1_plain.tri_tests = 0
            p_counts = {}
            pt_p, pi_p = P.mesh_intersect_v1_plain(ptab, p_o, p_d, cull,
                                                   counts=p_counts)
            tests = P.mesh_intersect_v1_plain.tri_tests
            tpu_tests = p_counts.get(P.RBLK, tests)
            check(same(kt_p, pt_p) and torch.equal(ki_p, pi_p),
                  f"P on {label} (cull {cull}) equals its plain version: "
                  f"max |d| {max_abs(kt_p, pt_p)}, "
                  f"{int((ki_p != pi_p).sum())} indices differ")
            if label == "bunny camera" and cull:
                stats["mesh_intersect_v1"] = max_abs(kt_p, pt_p)
                p_args = (ptab, p_o, p_d)
                p_io = nbytes(p_o, p_d, ptab.tri_mm, ptab.cmin, ptab.cmax,
                              kt_p, ki_p)
                work["mesh_intersect_v1"] = bound(p_io, tests * PLANE_OPS)
                p_tpu_bound = bound(p_io, tpu_tests * PLANE_OPS)
            print(f"phase 2: P on {label}, cull {cull}: (t, tri) equal, "
                  f"{int((ki_p >= 0).sum())} mesh hits, {tests} "
                  f"lane-triangle tests in the plain scan ({tpu_tests} "
                  f"under the TPU's 512-ray block cull)")
    torch.cuda.synchronize()
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3: the main paths, every launch counted ----
    t0 = time.perf_counter()
    rmse, runs, motion = {}, {}, {}
    plan = ([(f"{name} {{engine}}", name, flags, FRAMES, None)
             for name, flags in RUNS]
            + [(f"{name} {label}", name, flags, frames, res)
               for label, (name, flags, frames, res) in MOTION_RUNS.items()])
    for label, name, flags, frames, res in plan:
        r = renderer(name, res, **flags)
        tr = r.step.tracer
        label = label.format(engine=tr.engine)
        mov = Motion(r)
        reset_counts()
        for _ in range(frames):
            left, right = mov.frame()
        torch.cuda.synchronize()
        c = counts()
        runs[tuple(label.split(" ", 1))] = c
        want = expected_launches(r, mov)
        check({k: c[k] for k in want} == want,
              f"{label}: launches {c}, expected {want}")
        near = mov.near_frames()
        # frame 0 (previous view: the identity) is far; a still camera's
        # frames after it near; a moving camera reads motion_bounds once
        # on every frame
        if not r.cfg.automate_camera:
            check(near == [False] + [True] * (frames - 1)
                  and len(mov.calls) == 2,
                  f"{label}: far on frame 0 only, motion_bounds read on "
                  f"frames 0 and 1: {near}, {len(mov.calls)} reads")
        else:
            check(all(mov.moved) and len(mov.calls) == frames,
                  f"{label}: motion_bounds read once per moved frame")
        check(bool(torch.isfinite(left).all())
              and bool(torch.isfinite(right).all()), f"{label}: finite")
        line = (f"phase 3: {label} {r.resolution[0]}x{r.resolution[1]}: "
                f"{frames} frames ({frames - sum(near)} far), launches "
                f"{json.dumps(nonzero(c))}")
        if r.cfg.automate_camera:
            motion[label] = r
        else:
            e_dn, e_raw = rmse_vs_gt(name, left, right)
            rmse[label] = {"denoised": e_dn, "raw": e_raw}
            limit = 0.5 if name in ("cornell", "diamond") else 1.0
            check(e_dn < limit * e_raw,
                  f"{label}: denoised RMSE {e_dn} < {limit} x raw {e_raw}")
            line += f"; RMSE vs GT denoised {e_dn:.5f} raw {e_raw:.5f}"
        print(line)
        if label == "cornell whole_path":
            cornell_r = r
    # the motion checks the task sets: L on every frame of the flagged
    # still cornell after the first, C's band mode on every frame of the
    # moving cornell, and the gate keeping L off at 1920 wide
    check(runs["cornell", "fuse_l1"]["back_projection_atrous1"] == FRAMES - 1
          and runs["cornell", "fuse_l1"]["back_projection_stencil"] == 0,
          "cornell fuse_l1: L on every frame after the first, C never")
    for label in ("anim_slow", "anim_slow_fuse_l1"):
        check(runs["cornell", label]["back_projection_banded"] == FRAMES,
              f"cornell {label}: C's band mode on every moved frame")
    room_r = motion["room 1080p_animated"]
    check(not room_r.step.denoiser.fuse_l1
          and runs["room", "1080p_animated"]["back_projection_atrous1"] == 0,
          "room 1920x1080: the gate keeps L off")
    # the trace bench: A, M and I once each on its rays
    reset_counts()
    for fn in trace_bench.calls(*tb_args).values():
        fn()
    torch.cuda.synchronize()
    runs["cornell", "trace_bench"] = c = counts()
    check(c["scene_intersect_full"] == c["scene_intersect"]
          == c["light_visibility"] == 1 and sum(c.values()) == 3,
          f"trace bench: launches {c}")
    print(f"phase 3: trace bench on {tb_args[2].shape[0]} rays: launches "
          f"{json.dumps(nonzero(c))}")
    # a scene past B1's per-scene build: every frame through its table
    # build (no ground truth: finite outputs and the launches)
    cubes = renderer_of(write_cornell_plus(_lib.BUILD / "scenes",
                                           cubes=CUBES))
    check(len(cubes.step.tracer.gi.types) == 10 + CUBES
          and cubes.step.tracer.gi.path_scene is None
          and cubes.step.tracer.engine == "whole_path",
          "the generated scene has 65 geoms, no per-scene B1 and the "
          "whole-path engine")
    mov = Motion(cubes)
    reset_counts()
    for _ in range(CUBE_FRAMES):
        left, right = mov.frame()
    torch.cuda.synchronize()
    runs["cornell65", "whole_path"] = c = counts()
    want = expected_launches(cubes, mov)
    check({k: c[k] for k in want} == want
          and c["path_trace_table"] == CUBE_FRAMES,
          f"cornell65: launches {c}, expected {want}")
    check(bool(torch.isfinite(left).all())
          and bool(torch.isfinite(right).all()), "cornell65: finite")
    print(f"phase 3: cornell plus {CUBES} cubes (65 geoms) "
          f"{cubes.resolution[0]}x{cubes.resolution[1]}: {CUBE_FRAMES} "
          f"frames through B1's table build, finite, launches "
          f"{json.dumps(nonzero(c))}")
    # the table build on that scene's primary state, every geom index up
    # to 64 in its row and geom tables: equal to its plain version
    targs = b1_args(cubes)
    tc, tt = B._path_trace_kernel(*targs)
    t_kw = dict(zip(("frame", "lane0", "depth", "light", "flags"),
                    targs[3:]))
    (pc65, pt65), t_tests, t_culls = BB.b1_plain_counted(targs[:3], t_kw)
    stats["path_trace_table"] = max_abs(tc, pc65)
    off = BB.plane_diffs(BB.out_planes("path_trace_table", (tc, tt)),
                         BB.out_planes("path_trace_table", (pc65, pt65)))
    check(max(off.values()) == 0,
          f"B1's table build equals its plain version on the 65-geom "
          f"scene on every plane: lanes off {off}")
    # the table build's work: the analytic tests its cull skips taken out
    work["path_trace_table"] = BB.b1_work(targs[:3], t_kw, tc, tt, t_tests,
                                          t_culls)
    print(f"phase 3: B1's table build equals its plain version on the "
          f"65-geom scene's primary state on each of {len(off)} planes, "
          f"bit for bit (contributions and texel indices, "
          f"{int((tt >= 0).sum())} textured)")
    # the table build's other two causes, cornell's geoms with more
    # materials than the per-scene build takes or with a material
    # constant that is not finite: equal to its plain version on the
    # primary state of each variant's first frame
    for cause, kw in CAUSES.items():
        r = renderer_of(write_cornell_plus(_lib.BUILD / "scenes", **kw))
        r.render_frame()
        check(r.step.tracer.gi.path_scene is None,
              f"{cause}: no per-scene B1")
        cargs_b = b1_args(r, 0)
        reset_counts()
        got = B._path_trace_kernel(*cargs_b)
        check(counts()["path_trace_table"] == 1, f"{cause}: table build")
        off = BB.plane_diffs(BB.out_planes("path_trace_table", got),
                             BB.out_planes("path_trace_table",
                                           b1_plain(cargs_b)))
        check(max(off.values()) == 0,
              f"B1's table build equals its plain version with {cause}: "
              f"lanes off {off}")
        print(f"phase 3: B1's table build equals its plain version on "
              f"each of {len(off)} planes with {cause}")
    # the probe scripts and reproj_bench, each run once as its script
    # runs it, with the launches it made
    probes = {}
    for name, run, kernel in (
            ("texgather", probe_n.run, "gather_u32"),
            ("regroup", probe_g.run, "inrow_permute_k29"),
            ("intersect_v1", probe_p.run, "mesh_intersect_v1"),
            ("dyngather", probe_o.run, "take_chain"),
            ("reproj_bench", reproj_bench.run, "back_projection_stencil")):
        reset_counts()
        probes[name] = run()
        torch.cuda.synchronize()
        runs["probe", name] = c = counts()
        check(c[kernel] > 0, f"{name} launched {kernel}: {c}")
        print(f"phase 3: {name} launches {json.dumps(nonzero(c))}; "
              f"{json.dumps(printable(probes[name]))} [{card}]")
    check(all(ok for ok in probes["dyngather"][0].values())
          and all(r["ok"] for r in probes["dyngather"][1].values()),
          "dyngather: every case OK")
    check(all(d == 0.0 for _, diffs in probes["reproj_bench"][1]
              for d in diffs), "reproj_bench: window equals C's band mode "
          "on the local motion and C's stencil mode on the still one")
    launches = {k: runs[LAUNCH_RUN[k]][k] for k in KERNELS}
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: times ----
    t0 = time.perf_counter()
    frame_ms = {"cornell": cuda_ms(cornell_r.render_frame, reps=20)}
    # each scene's engines in turns, there and back (a moving camera's
    # frames move it on every call)
    for group, name, res, reps, engines in (
            ("cornell", "cornell", None, 10,
             {"B1": {}, "fuse_l1": FUSE_L1, "fused": FUSED,
              "split": SPLIT}),
            ("cornell moving", "cornell", None, 10,
             {"B1": ANIM_SLOW, "fuse_l1": dict(ANIM_SLOW, **FUSE_L1)}),
            ("diamond", "diamond", None, 10,
             {"sort": {}, "B1": dict(sort_rays=False)}),
            ("bunny", "bunny", None, 10,
             {"sort": {}, "B1": dict(sort_rays=False), "fused": FUSED,
              "split": SPLIT}),
            ("room", "room", None, 10,
             {"sort": {}, "fused": FUSED, "split": SPLIT}),
            ("room 1920x1080 moving", "room", (1920, 1080), 4,
             {"sort": MOTION_RUNS["1080p_animated"][1]})):
        eng = {k: Motion(renderer(name, res, **kw)).frame
               for k, kw in engines.items()}
        for frame in eng.values():
            for _ in range(3):
                frame()
        ms = {k: [] for k in eng}
        order = list(eng) + list(eng)[::-1]
        for k in order:
            ms[k].append(cuda_ms(eng[k], reps=reps, warmup=1))
        frame_ms[group + " turns"] = ms
        print(f"phase 4: {group} ms/frame "
              + ", ".join(f"{k} {v}" for k, v in ms.items())
              + f" (turns {', '.join(order)}) [{card}]")
    bench_ms = trace_bench.run()
    frame_ms["trace bench"] = bench_ms
    print("phase 4: trace bench (cornell, 800x800 random rays) "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bench_ms.items())
          + f" [{card}]")
    (f_planes_d, f_kw_d) = mesh["diamond"][1]["trace_bounce"]
    i_args, j_args, k_args = ijk_args      # cornell's
    fds, fgi, f_planes = f_planes_d
    times = {
        "scene_intersect_full": (
            lambda: A._scene_intersect_full_kernel(ds, gi, o, d),
            lambda: A.scene_intersect_full_plain(ds, gi, o, d), None),
        "path_trace": (
            lambda: B._path_trace_kernel(*bargs), lambda: b1_plain(bargs),
            None),
        "deferred_radiance": (
            lambda: B._deferred_radiance_kernel(ds, pc, pt, DEPTH),
            lambda: B.deferred_radiance_plain(ds, pc, pt, DEPTH), None),
        "back_projection_stencil": (
            lambda: C._back_projection_stencil_kernel(*cargs),
            lambda: C.back_projection_stencil_plain(*cargs), None),
        "back_projection_banded": (
            lambda: C._back_projection_banded_kernel(*bargs_c),
            lambda: C.back_projection_banded_plain(*bargs_c), None),
        "back_projection_atrous1": (
            lambda: L._back_projection_atrous1_kernel(*largs),
            lambda: L.back_projection_atrous1_plain(*largs), None),
        "atrous_level": (
            lambda: D._atrous_level_kernel(*d_args[0]),
            lambda: D.atrous_level_plain(*d_args[0]), None),
        "shade_bounce": (
            lambda: E._shade_bounce_kernel(e_planes, e_mats, **e_kw),
            lambda: E.shade_bounce_plain(e_planes, e_mats, **e_kw), None),
        "trace_bounce": (
            lambda: F._trace_bounce_kernel(fds, fgi, f_planes, **f_kw_d),
            lambda: F.trace_bounce_plain(fds, fgi, f_planes, **f_kw_d),
            None),
        "inrow_permute": (
            lambda: G._inrow_permute_kernel(g_planes, g_order),
            lambda: G.inrow_permute_plain(g_planes, g_order),
            lambda: torch.gather(g_planes, 2, g_order.to(torch.int64)[None]
                                 .expand(g_planes.shape[0], -1, -1))),
        "bounce_fused": (
            lambda: F._bounce_fused_kernel(*h_args[:3], **h_args[3]),
            lambda: F.bounce_fused_plain(*h_args[:3], **h_args[3]), None),
        "light_visibility": (
            lambda: A._light_visibility_kernel(*i_args),
            lambda: A.light_visibility_plain(*i_args), None),
        "scene_intersect_full_tex": (
            lambda: A._scene_intersect_full_tex_kernel(*j_args),
            lambda: A.scene_intersect_full_tex_plain(*j_args), None),
        "sparse_gather": (
            lambda: K._sparse_gather_kernel(*k_args),
            lambda: K.sparse_gather_plain(*k_args),
            lambda: torch.take(k_args[0], take_idx)),
        "scene_intersect": (
            lambda: A._scene_intersect_kernel(*tb_args),
            lambda: A.scene_intersect_plain(*tb_args), None),
        "path_trace_table": (
            lambda: B._path_trace_kernel(*targs), lambda: b1_plain(targs),
            None),
        "gather_u32": (
            lambda: N._gather_u32_kernel(*n_args),
            lambda: N.gather_u32_plain(*n_args),
            lambda: torch.take(n_table32, n_idx64)),
        "inrow_permute_k29": (
            lambda: G._inrow_permute_kernel(g29_planes, g29_order),
            lambda: G.inrow_permute_plain(g29_planes, g29_order),
            lambda: probe_g.gather_rows(g29_planes, g29_order)),
        "mesh_intersect_v1": (
            lambda: P._mesh_intersect_v1_kernel(*p_args),
            lambda: P.mesh_intersect_v1_plain(*p_args), None),
        "take_chain": (
            lambda: O._take_chain_kernel(*o_args),
            lambda: O.take_chain_plain(*o_args), None),
    }
    n_table32, n_idx64 = n_args[0].view(torch.int32), n_args[1].to(
        torch.int64)
    check(same(times["inrow_permute"][2](), pg),
          "torch.gather computes G's function")
    check(same(times["inrow_permute_k29"][2](), kg29)
          and torch.equal(times["gather_u32"][2](), N._gather_u32_kernel(
              *n_args).view(torch.int32)),
          "torch.gather and torch.take compute G's and N's functions")
    tex = k_args[1] >= 0
    words = times["sparse_gather"][2]()[tex]
    check(torch.equal(torch.stack([((words >> (8 * c)) & 0xFF).float()
                                   * A.COLORDIVIDOR for c in range(3)]),
                      K._sparse_gather_kernel(*k_args)[:, tex]),
          "torch.take gathers K's texels")
    out = []
    for name, (_, source, replaces) in KERNELS.items():
        kfn, pfn, lfn = times[name]
        reps = 3 if name in ("path_trace", "path_trace_table") else 10
        ms = cuda_ms(kfn, reps=reps, hide_host=True)
        plain_ms = cuda_ms(pfn, reps=3, warmup=1, hide_host=True)
        lib_ms = cuda_ms(lfn, reps=reps, hide_host=True) if lfn else None
        bound_ms, bound_by = work[name]
        out.append({"name": name, "route": "cuda",
                    "source": "ptdn_tpu_torch/" + source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": stats[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
        print(f"phase 4: {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})"
              + (f", {LIBRARY[name]} {lib_ms:.4f} ms" if lib_ms else "")
              + f" [{card}]")
    # F, H, J, A and I where their users feel them most: F at bounce 2 of
    # bunny and of room at 1920x1080 (a still camera), H at bounce 2 of
    # bunny and room 600x600, J at bounce 2 of cornell and room, A at
    # bounce 2 of bunny and on the camera rays of room at 1920x1080 after
    # a move, I at bounce 2 of cornell, bunny and room; each build in
    # turns, with its bound and its launches in phase 3
    bounce_cases = {
        "F bunny bounce 2": ("trace_bounce", mesh["bunny"][1]["trace_bounce"],
                             ("bunny", "sorted")),
        "F room 1920x1080 bounce 2": (
            "trace_bounce", BB.capture("trace_bounce", "room", (1920, 1080)),
            ("room", "1080p_animated")),
        "H bunny bounce 2": ("bounce_fused", h_cases["bunny"],
                             ("bunny", "bounce_fused")),
        "H room bounce 2": ("bounce_fused", h_cases["room"],
                            ("room", "bounce_fused")),
        "J cornell bounce 2": ("scene_intersect_full_tex", j_cases["cornell"],
                               ("cornell", "bounce_split")),
        "J room bounce 2": ("scene_intersect_full_tex", j_cases["room"],
                            ("room", "bounce_split")),
        "A bunny bounce 2": ("scene_intersect_full", a_case,
                             ("bunny", "bounce_split")),
        "A room 1920x1080 primary": (
            "scene_intersect_full", BB.capture(
                "scene_intersect_full", "room", (1920, 1080), "primary"),
            ("room", "1080p_animated")),
        **{f"I {name} bounce 2": ("light_visibility", i_cases[name],
                                  (name, "bounce_split"))
           for name in ("cornell", "bunny", "room")},
        # B1's table build on the 65-geom scene's primary state and on
        # cornell's beside the per-scene build; M on the trace bench's
        # rays (the cull on and off) and on bunny's camera rays
        "B1 table cornell65": ("path_trace_table", (targs[:3], t_kw),
                               ("cornell65", "whole_path")),
        "B1 table cornell": ("path_trace_table", (bargs[:3], b_kw),
                             ("cornell65", "whole_path")),
        **{f"M {label}, cull {cull}": (
            "scene_intersect", (list(m_args), {"cull": cull}),
            ("cornell", "trace_bench"))
           for label, m_args in m_cases.items() for cull in (True, False)}}
    for label, (kernel, (b_args, b_kw), run) in bounce_cases.items():
        m = BB.measure(kernel, b_args, b_kw, reps=10)
        check(all(max(b["diffs"].values()) <= LANES_OFF_ALLOWED
                  for b in m["builds"].values()),
              f"{label}: lanes differing by plane "
              f"{ {k: b['diffs'] for k, b in m['builds'].items()} }")
        m["launches"] = runs[run][kernel]
        frame_ms["bounce " + label] = m
        print(f"phase 4: {label} ({m['lanes']} lanes): "
              + ", ".join(f"{k} build {v['ms']}" for k, v in
                          m["builds"].items())
              + f" ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}, "
              f"{m['tri_tests']} lane-triangle tests"
              + (f"; without the cull {m['bound_full_ms']:.4f} ms"
                 if "bound_full_ms" in m else "")
              + "), plain "
              f"{m['plain_ms']:.1f} ms; {m['launches']} launches in the "
              f"{' '.join(run)} run of phase 3 [{card}]")
    # L beside what it fuses, C (stencil mode) alone then D at level 1
    # alone on C's output, all in turns on the same state
    m = BB.measure_l(largs, {}, reps=10)
    check(all(max(b["diffs_c_then_d"].values()) == 0
              for b in m["builds"].values()),
          f"L equals C's then D's kernels: "
          f"{ {k: b['diffs_c_then_d'] for k, b in m['builds'].items()} }")
    m["launches"] = runs["cornell", "fuse_l1"]["back_projection_atrous1"]
    frame_ms["L beside C and D level 1"] = m
    print(f"phase 4: L on cornell ({m['lanes']} pixels): "
          + ", ".join(f"{k} {v}" for k, v in
                      [("L", m["builds"]["library"]["ms"])]
                      + list(m["parts"].items()))
          + f" ms (turns {', '.join(m['turns'])}), bound "
          f"{m['bound_ms']:.4f} ms ({m['bound_by']}); equal to C's then "
          f"D's kernels on every pixel; {m['launches']} launches in the "
          f"cornell fuse_l1 run of phase 3 [{card}]")
    # D at each level of the frame (the line above: level 1)
    d_ms = [cuda_ms(lambda a=a: D._atrous_level_kernel(*a), hide_host=True)
            for a in d_args]
    frame_ms["atrous_level by level"] = d_ms
    print("phase 4: atrous_level by level "
          + ", ".join(f"{a[4]} {t:.4f} ms" for a, t in zip(d_args, d_ms))
          + f", mean {sum(d_ms) / len(d_ms):.4f} ms [{card}]")
    print(f"phase 4: cornell {frame_ms['cornell']:.3f} ms/frame over 20 "
          f"steady-state frames (depth {DEPTH}, SVGF {NLEVEL} levels) "
          f"[{card}]")
    frame_ms["cornell65"] = cuda_ms(cubes.render_frame, reps=10)
    print(f"phase 4: cornell plus {CUBES} cubes (B1's table build) "
          f"{frame_ms['cornell65']:.3f} ms/frame over 10 frames [{card}]")
    # the floor no launch beats: an empty kernel behind the device spin
    launch_ms = cuda_ms(lambda: torch.cuda._sleep(0), reps=20,
                        hide_host=True)
    frame_ms["empty launch"] = launch_ms
    print(f"phase 4: an empty launch {launch_ms:.4f} ms (O's bound "
          f"{work['take_chain'][0]:.4f} ms); P's bound on bunny's camera "
          f"rays {work['mesh_intersect_v1'][0]:.4f} ms from the warp cull's "
          f"tests, {p_tpu_bound[0]:.4f} ms ({p_tpu_bound[1]}) from the TPU's "
          f"512-ray block cull's [{card}]")
    print(f"phase 4: {time.perf_counter() - t0:.1f} s; all phases "
          f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out, "frame_ms": frame_ms, "rmse": rmse}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
