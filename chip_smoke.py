"""Drive the port's main paths once on one NVIDIA card and check them.

    python3 chip_smoke.py

Four engines, all at bench.py's headline settings (1 spp, trace depth
8, static camera, temporal SVGF with a 5-level à-trous filter, each
scene at its own resolution):

* cornell (800x800) through the whole-path engine: kernels A, B1, B2, C
  and D;
* the mesh scenes through the sorted wavefront: A, E, Q (the range and
  key glue), F, C and D, and G on diamond (at most 8 chunks); diamond,
  bunny and terrain30k at 800x800, room at 600x600;
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
* native mode (compat=False: true barycentric mesh normals, the
  spatial variance of kernel R) and NEE toward a mesh light: cornell
  through the whole path (A, B1, B2, C, R, D), bunny through the sort
  (A, E, Q, F, C, R, D), cornell with temporal accumulation off (R on
  every frame, D), cornell with a mesh panel for its light in compat
  mode (the split engine: E, A as the shadow test, J and K, C, D) and
  the two-light scene in native mode (the split engine: E with its light
  table, A, C, R, D), each at 800x800;
* the ports of the benchmarks/ probes (ptdn_tpu_torch/probes): N
  (texgather), G at the in-row regroup's K = 29 (regroup), P with A beside
  it (intersect_v1) and O (dyngather), and reproj_bench (C's two modes
  beside the PyTorch window, packed and packed2 variants);
* the row-sharded frame step (ptdn_tpu_torch/parallel/): cornell split
  into 8 and 16 row shards in one process (kernel D's shard mode at
  every level of every shard, C's shard mode), room (sorted), diamond
  (G) and native cornell (R) in 8, and cornell in two torch.distributed
  ranks over gloo on the one card.

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
   kernel's warp cull and the TPU's 512-ray block cull); N also on an
   odd length, a slice at a misaligned offset and no index; Q (filling
   in place the allp whose first 21 planes E wrote) equal bit
   for bit, range planes and key, on every lane of bounce 2 of diamond,
   bunny, room, terrain30k (supergroups) and room at 1920x1080 with its
   moving camera, and of the shared edge inputs
   (ops/cuda/ranges.py:edge_inputs); R against its plain version on
   native cornell's spatial-only frame and its fallback frame (pixels
   off counted, within 1e-6), and where no pixel needs the taps (the
   temporal variance, bit for bit), E's light table on the two-light
   scene's bounce 2 (bit for bit), and the native builds of A, J, B1
   (per-scene and table), F and H on bunny's state, output by output
   through the scene's build and the library's, no lane off;
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
   parity printouts 0); 32 frames of each native and mesh-light run,
   launches checked, finite, native cornell's denoised RMSE below half
   its raw one, bunny's native raw frame off its compat one;
4. CUDA-event times: each kernel beside its plain version (G beside
   torch.gather, K beside torch.take) and its bound, D at level 1 and
   at each level of the frame; ms/frame of cornell
   (still, with fuse_reproject_l1, and moving with the flag off and on)
   through each of its engines, of diamond, bunny, room 600x600,
   terrain30k and room at 1920x1080 moving through the sort, B1
   (sort_rays=False) and the fused and the split engines, in turns; F
   at bounce 2 of bunny and of room at 1920x1080, H at bounce 2 of
   bunny and room, J at bounce 2 of cornell and room, A at bounce 2 of
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
   the JSON line's, from the warp cull's (the work the kernel does); Q
   at bounce 2 of each mesh scene and of room at 1920x1080 moving
   (diamond's in the JSON line) beside its plain version and bound, N
   on the texgather probe's four cases beside its plain version and
   torch.take; R beside its plain version and bound, and on the
   fallback frame and where no pixel needs the taps, E's light table,
   the native builds of F, H and A at bounce 2 of bunny, J on bunny's
   camera rays beside its compat build, B1 on bunny (per-scene and
   table builds, native and compat in turns; the native build's bound
   and plain version), and the ms/frame of each
   native and mesh-light run;
5. the entry points a user runs: `python3 -m ptdn_tpu_torch.bench --all
   --quality` (one JSON line naming the card; each still
   scene's denoised RMSE equal to phase 3's within 2e-5; cornell's
   ms_pipelined within 5% of phase 4's cornell ms/frame), each of its
   configurations with the denoiser, temporal accumulation, the à-trous
   levels or the shadow ray off (two frames, the camera still, every
   launch counted, untimed), `app.cli` (8
   frames of cornell with SVGF: 8 stats lines, every output file, a
   denoised PNG that is not uniform), `app.eval` (500 accumulated frames
   against 32 SVGF ones: denoised below raw), the viewer's watch loop in
   process (16 frames of cornell with an orbit, sigma_l 0.7 and the
   denoise toggle: renderer.step kept until the toggle, the launches of
   A, B1, B2, C and D counted), a checkpoint's resume (bit for bit), and
   benchmarks/gt/*.npz and bench_results.json hashed before and after;
6. the row-sharded frame step at cornell 800x800 with the same config:
   D's shard mode (its own rows and its halo rows read where they lie)
   against its plain version and the unsharded kernel at every level on
   4 shards (200 rows), 8 (100) and 16 (50 rows: level 5's 64-row halo
   two hops), bit for bit, and with row0 0 and no halo the unsharded D;
   C's shard mode (its own rows in place, its halo rows as the sharded
   denoiser packs and exchanges them) in both modes, still and moved, on
   4, 8 and 16 shards, against its plain version (no pixel off) and the
   unsharded kernel's rows, bit for bit, each count's sum and one shard
   timed beside the unsharded launch; the in-process group of 8 and of
   16 shards through 8 still then 8 anim_slow frames, every stitched
   left and right equal to the whole image's bit for bit, with each
   frame's launches (D in shard mode shards x 5 times) and exchanges
   counted (a Halo for the back-projection on every frame, never a
   whole-image exchange; its halo rows printed, 2 when still, under the
   image's when moved) and, at 8 shards, the back-projection's device
   kernels and torch.cat calls on a still and a moved frame
   (torch.profiler: a shard's halo_pack and kernel C, no window copy);
   4 frames each of room 600x600 (sorted, 75-row shards),
   diamond (G) and native cornell (R) in 8 shards, equal bit for bit; 2
   gloo ranks on the one card (a subprocess each, with a time limit),
   4 frames, the stitched frame equal; D's shard mode by level beside
   the unsharded level and the 8 and 16 shards' sum, the sharded still
   frame's ms beside the unsharded one, in turns, and the shard modes'
   entries of the JSON line (one shard's call, its bound from its rows
   and halo rows).

The last three lines are a JSON object with every kernel's numbers, the
card, and {"ok": true, "device": {...}}. Any failed check raises, so
the exit code is not 0 and no result line is printed. Needs one card.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ptdn_tpu_torch import bench  # noqa: E402
from ptdn_tpu_torch import bounce_bench as BB  # noqa: E402
from ptdn_tpu_torch import reproj_bench, trace_bench  # noqa: E402
from ptdn_tpu_torch.app.automate import CameraAutomation  # noqa: E402
from ptdn_tpu_torch.app.viewer import Viewer  # noqa: E402
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
from ptdn_tpu_torch.ops.cuda import ranges as Q  # noqa: E402
from ptdn_tpu_torch.ops.cuda import reproject as C  # noqa: E402
from ptdn_tpu_torch.ops.cuda import reproject_atrous as L  # noqa: E402
from ptdn_tpu_torch.ops.cuda import scene_intersect as A  # noqa: E402
from ptdn_tpu_torch.ops.cuda import shade as E  # noqa: E402
from ptdn_tpu_torch.ops.cuda import spatial_variance as R  # noqa: E402
from ptdn_tpu_torch.ops.cuda import texgather as N  # noqa: E402
from ptdn_tpu_torch.parallel.dryrun import run_ranks  # noqa: E402
from ptdn_tpu_torch.parallel.mesh import InProcessGroup  # noqa: E402
from ptdn_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedRenderer, back_projection_shards)
from ptdn_tpu_torch.probes import dyngather as probe_o  # noqa: E402
from ptdn_tpu_torch.probes import intersect_v1 as probe_p  # noqa: E402
from ptdn_tpu_torch.probes import regroup as probe_g  # noqa: E402
from ptdn_tpu_torch.probes import texgather as probe_n  # noqa: E402
from ptdn_tpu_torch.scene import Scene  # noqa: E402
from ptdn_tpu_torch.utils.assets import (scene_path,  # noqa: E402
                                         scenes_dir,
                                         write_cornell_plus,
                                         write_mesh_light, write_two_light)
from ptdn_tpu_torch.utils.card import (ANALYTIC_OPS,  # noqa: E402
                                       MOLLER_OPS, RANGE_OPS, REFINE_OPS,
                                       SHADE_OPS, bound,
                                       cuda_ms, in_turns, nbytes,
                                       ptxas_summary)
from ptdn_tpu_torch.utils.checkpoint import (restore_renderer,  # noqa: E402
                                             save_state)
from ptdn_tpu_torch.utils.config import RenderConfig  # noqa: E402
from ptdn_tpu_torch.utils.image_io import load_image_rgb  # noqa: E402

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
# native mode (compat=False) and NEE toward a mesh light, 32 frames each
# at 800x800: label -> (scene: a scene of SCENES, "mesh_light" or
# "twolight", native_scene's; flags; the engine the JAX choice gives)
# phase 5: a stage of the bench's configurations turned off
ABLATIONS = (dict(denoise_enable=False), dict(temporal_enable=False),
             dict(atrous_nlevel=0), dict(shadow_ray=False))
NATIVE = dict(compat=False)
NATIVE_RUNS = {
    "cornell native": ("cornell", NATIVE, "whole_path"),
    "bunny native": ("bunny", NATIVE, "sorted"),
    "cornell spatial_native": ("cornell", dict(NATIVE,
                                               temporal_enable=False),
                               "whole_path"),
    "mesh_light bounce_split": ("mesh_light", {}, "bounce_split"),
    "twolight native": ("twolight", NATIVE, "bounce_split"),
}
# R against its plain version: the largest |d| allowed (torch.exp and
# expf may differ in the last bit; tests/test_torch_native.py's bound)
SV_ATOL = 1e-6
# the per-scene builds of phase 1: each scene of SCENES in compat mode,
# and the headers these runs add
SCENE_BUILDS = ([(name, True) for name in SCENES]
                + [("cornell", False), ("bunny", False),
                   ("mesh_light", True), ("twolight", False)])
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
    # Q: the sorted wavefront's range and key glue, XLA code in the JAX
    # package (as C's band mode)
    "ranges_and_key": (Q.ranges_and_key, "csrc/ranges.cu",
                       "ptdn_tpu/engine/wavefront.py:617"),
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
    # R: native mode's spatial variance and its fallback, XLA code in the
    # JAX package (as C's band mode and Q)
    "spatial_variance": (R.spatial_variance_fallback,
                         "csrc/spatial_variance.cu",
                         "ptdn_tpu/denoise/variance.py:40"),
    # E's light-table entry: native multi-light NEE, the JAX oracle
    # bounce's XLA code (the Pallas E bakes one light)
    "shade_bounce_lights": (E.shade_bounce, "csrc/shade.cu",
                            "ptdn_tpu/engine/wavefront.py:1321"),
}
# the counter of a kernel whose wrapper counts it apart from .launches
COUNTER = {"path_trace_table": "table_launches",
           "shade_bounce_lights": "table_launches"}
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
              "ranges_and_key": ("diamond", "sorted"),
              "bounce_fused": ("cornell", "bounce_fused"),
              "light_visibility": ("cornell", "bounce_split"),
              "scene_intersect_full_tex": ("cornell", "bounce_split"),
              "sparse_gather": ("cornell", "bounce_fused"),
              "scene_intersect": ("cornell", "trace_bench"),
              "path_trace_table": ("cornell65", "whole_path"),
              "gather_u32": ("probe", "texgather"),
              "inrow_permute_k29": ("probe", "regroup"),
              "mesh_intersect_v1": ("probe", "intersect_v1"),
              "take_chain": ("probe", "dyngather"),
              "spatial_variance": ("cornell", "native"),
              "shade_bounce_lights": ("twolight", "native")}
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
# phase 4's engine A/B on the mesh scenes: the flags of each engine
ENGINE_AB = {"sort": {}, "B1": dict(sort_rays=False), "fused": FUSED,
             "split": SPLIT}
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
# phase 5's limits on the entry points run as subprocesses (seconds)
BENCH_TIMEOUT, CLI_TIMEOUT = 600, 180
# phase 6, the row-sharded frame step: the in-process groups' shard counts
# (cornell 800x800: 100 and 50 rows, level 5's 64-row halo two hops at
# 50), the still then moving frames of each, the other scenes' runs at 8
# shards (label -> scene, flags, resolution) and their frames, and the
# two gloo ranks' frames and time limit (seconds)
SHARDS = (8, 16)
# D's and C's shard modes are checked and timed at these (4: the 4-card
# shape, 200 rows)
D_SHARDS = C_SHARDS = (4, 8, 16)
SHARD_STILL = SHARD_MOVING = 8
SHARD_RUNS = {"room": ("room", {}, (600, 600)),
              "diamond": ("diamond", {}, (800, 800)),
              "cornell native": ("cornell", NATIVE, (800, 800))}
SHARD_RUN_FRAMES = 4
RANKS, RANKS_FRAMES, RANKS_TIMEOUT = 2, 4, 300
# the kernels' shard modes: name -> (wrapper, its counter of them, source,
# the TPU kernel (or XLA code) it replaces)
SHARD_KERNELS = {
    "atrous_level_shard": (D.atrous_level, "shard_launches",
                           "csrc/atrous.cu",
                           "ptdn_tpu/ops/pallas/atrous.py:275"),
    "back_projection_stencil_rows": (C.back_projection_stencil,
                                     "row_launches", "csrc/reproject.cu",
                                     "ptdn_tpu/ops/pallas/reproject.py:194"),
    "back_projection_banded_rows": (C.back_projection_banded,
                                    "row_launches", "csrc/reproject.cu",
                                    "ptdn_tpu/denoise/reproject.py:406"),
}


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


@functools.cache
def native_scene(name):
    """A scene of SCENES, or the generated mesh-light cornell or
    two-light scene (utils/assets.py, written into the build
    directory)."""
    if name == "mesh_light":
        return Scene(write_mesh_light(_lib.BUILD / "scenes"))
    if name == "twolight":
        return Scene(write_two_light(_lib.BUILD / "scenes"))
    return scene(name)


def native_renderer(name, **kw):
    """A renderer of native_scene(name) at 800x800 with CFG and `kw`."""
    return Renderer(native_scene(name), dataclasses.replace(CFG, **kw),
                    resolution=(800, 800), device=DEVICE)


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
    near frames and C's band mode on the others (none with temporal
    accumulation off), R on every frame in native mode but with L's
    gate (the JAX branch has no fallback), and D at every level but the
    first that L takes; none of C, L, R and D with the denoiser off, and
    no shadow test with shadow_ray off."""
    tr, frames = r.step.tracer, len(motion.moved)
    denoise = r.cfg.denoise_enable
    temporal = denoise and r.cfg.temporal_enable
    near = sum(motion.near_frames()) if temporal else 0
    fused = r.step.denoiser.fuse_l1
    levels = r.cfg.atrous_nlevel if denoise and r.cfg.spatial_enable else 0
    want = dict.fromkeys(KERNELS, 0)
    want["scene_intersect_full"] = sum(motion.moved)
    if temporal:
        want["back_projection_banded"] = frames - near
        want["back_projection_atrous1" if fused
             else "back_projection_stencil"] = near
    want["spatial_variance"] = (0 if r.cfg.compat or fused or not denoise
                                else frames)
    want["atrous_level"] = frames * levels - (near if fused else 0)
    bounces, below_last = frames * DEPTH, frames * (DEPTH - 1)
    tex = tr.flags["show_tex"]
    if tr.engine == "whole_path":
        # the per-scene build where the scene has one, else the table's
        b1 = "path_trace" if tr.gi.path_scene else "path_trace_table"
        want[b1] = want["deferred_radiance"] = frames
    elif tr.engine == "sorted":
        want["shade_bounce"] = want["trace_bounce"] = bounces
        want["ranges_and_key"] = bounces
        want["inrow_permute"] = bounces if tr.regroup > 1 else 0
    elif tr.engine == "bounce_fused":
        want["bounce_fused"] = bounces
        want["sparse_gather"] = below_last if tex else 0
    else:
        # E with its light table in native multi-light mode; A as the
        # shadow test where the light is a mesh or drawn per lane, I else
        want["shade_bounce_lights" if tr.multi_light
             else "shade_bounce"] = bounces
        if tr.shadow_closest:
            want["scene_intersect_full"] += bounces
        elif r.cfg.shadow_ray:
            want["light_visibility"] = bounces
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


def q_check(label, args, boxes):
    """Kernel Q against its plain version on ranges_and_key's arguments
    `args` (ds, allp, pix, n_chunks, do_vis, light_pos, light_radius,
    E's planes in allp's first 21, which Q fills in place) with its box
    table `boxes`: no lane may differ in any of the 26 planes (NaN where
    NaN) or in its key. Returns the bound of the work (bytes: the planes
    Q needs, the live flag and the pixel plane read and the 4 range
    planes, the pixel plane and the key written on every lane, the NEE
    flag, origin and next direction read on a live lane and the shadow
    direction on a lane with a shadow ray, Q.traffic; operations: a box
    test per box of each live lane's next ray and shadow ray)."""
    ref_p, ref_k = Q.ranges_and_key_plain(*args)
    p, k = Q._ranges_and_key_kernel(boxes, *args[1:])
    planes_eq = ((p == ref_p) | (p.isnan() & ref_p.isnan())).all(dim=0)
    off = int(((k != ref_k) | ~planes_eq.reshape(-1)).sum())
    check(off <= LANES_OFF_ALLOWED,
          f"Q on {label}: {off} lanes off its plain version")
    tests = Q.box_tests(args[1], boxes.shape[0])
    lanes, live, nee = Q.lane_counts(args[1])
    print(f"phase 2: Q on {label}: {lanes} lanes, {live / lanes:.4f} live, "
          f"{nee / lanes:.4f} with a shadow ray, {tests} box tests, "
          f"{boxes.shape[0]} boxes: range planes and key equal to the plain "
          f"version on every lane")
    return bound(Q.traffic(args[1]), tests * RANGE_OPS)


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


def run_module(module, *args, timeout):
    """python3 -m <module> <args> from the repo's root: its stdout's
    lines; raises unless it exits 0 within `timeout` seconds."""
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    check(proc.returncode == 0, f"{module} exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout.splitlines()


def file_hashes(paths):
    return {str(p): hashlib.sha256(pathlib.Path(p).read_bytes()).hexdigest()
            for p in paths}


def entry_points(card, rmse, frame_ms):
    """Phase 5: the entry points a user runs (ptdn_tpu_torch.bench,
    app.cli, app.eval, app.viewer) and a checkpoint's resume, on the card,
    held against phases 3 and 4 of this run."""
    t0 = time.perf_counter()
    guarded = sorted(pathlib.Path(ROOT, "benchmarks", "gt").glob("*.npz"))
    guarded.append(pathlib.Path(ROOT, "bench_results.json"))
    before = file_hashes(guarded)
    # the bench, every configuration with its quality
    bench.EXTRAS.unlink(missing_ok=True)
    lines = run_module("ptdn_tpu_torch.bench", "--all", "--quality",
                       timeout=BENCH_TIMEOUT)
    check(len(lines) == 1, f"the bench prints one line: {lines}")
    head = json.loads(lines[0])
    # vs_baseline is rounded from the unrounded ms: within 1e-4 of value's
    check(head["device"] == card and head["unit"] == "ms"
          and abs(head["vs_baseline"] - head["value"] / bench.TARGET_MS)
          <= 1e-4, f"the bench's line: {head}")
    res = json.loads(bench.EXTRAS.read_text())
    check(res["device"] == card and res["headline"] == head,
          f"the extras file names the card and the headline: {res}")
    print(f"phase 5: bench {json.dumps(head)}")
    for name, ms_pipe in res["ms_pipelined"].items():
        ms = head["value"] if name == "cornell" else res["extra_ms"][name]
        print(f"phase 5: bench {name}: {ms} ms/frame synced, {ms_pipe} "
              f"ms/frame pipelined, {res['rays_per_sec_M'][name]} M rays/s "
              f"[{card}]")
    # each still scene's quality: phase 3's 32 frames of the same
    # configuration (its first run of the scene, the default engine)
    for name in SCENES:
        label = next(k for k in rmse if k.split(" ")[0] == name)
        got = res["quality_rmse"][name]["rmse_denoised"]
        check(abs(got - rmse[label]["denoised"]) <= 2e-5,
              f"bench {name} RMSE {got} = phase 3's {rmse[label]}")
    print(f"phase 5: bench quality_rmse {json.dumps(res['quality_rmse'])} "
          f"equal to phase 3's within 2e-5")
    ratio = res["ms_pipelined"]["cornell"] / frame_ms["cornell"]
    check(abs(ratio - 1) <= 0.05,
          f"bench cornell ms_pipelined {res['ms_pipelined']['cornell']} "
          f"within 5% of phase 4's {frame_ms['cornell']}")
    print(f"phase 5: bench cornell ms_pipelined "
          f"{res['ms_pipelined']['cornell']} / phase 4's "
          f"{frame_ms['cornell']:.3f} = {ratio:.4f}")
    # the bench's configurations with a stage turned off (the denoiser,
    # temporal accumulation, the à-trous levels, the NEE shadow ray),
    # the camera held still: two frames each, the launches counted
    for path, name, res, _ in bench.configs(str(scenes_dir()), True):
        for flags in ABLATIONS:
            r = Renderer(bench.load_scene(path),
                         dataclasses.replace(CFG, **flags), resolution=res,
                         device=DEVICE)
            mov = Motion(r)
            reset_counts()
            frames = [mov.frame() for _ in range(2)]
            torch.cuda.synchronize()
            c = counts()
            want = expected_launches(r, mov)
            check({k: c[k] for k in want} == want
                  and all(bool(torch.isfinite(x).all())
                          for f in frames for x in f),
                  f"{name} {flags}: launches {nonzero(c)}, expected "
                  f"{nonzero(want)}, frames finite")
            print(f"phase 5: {name} {r.resolution[0]}x{r.resolution[1]} "
                  f"{r.step.tracer.engine} {json.dumps(flags)}: 2 frames, "
                  f"launches {json.dumps(nonzero(c))}")
    with tempfile.TemporaryDirectory() as tmp:
        # the CLI: 8 frames of cornell with SVGF, every output written
        out = {k: os.path.join(tmp, k) for k in (
            "dn.png", "raw.png", "side.png", "dn.hdr")}
        lines = run_module(
            "ptdn_tpu_torch.app.cli", "scenes/cornell.txt", "--frames", 8,
            "--depth", DEPTH, "--denoise", "--temporal", "--spatial",
            "--out", out["dn.png"], "--out-raw", out["raw.png"],
            "--side-by-side", out["side.png"], "--hdr", out["dn.hdr"],
            "--stats", timeout=CLI_TIMEOUT)
        frames = [json.loads(ln) for ln in lines]
        check([f["frame"] for f in frames] == list(range(8)),
              f"the CLI prints 8 stats lines: {lines}")
        check(all(os.path.getsize(p) > 0 for p in out.values()),
              "the CLI writes every file")
        dn = load_image_rgb(out["dn.png"])
        w, h = scene("cornell").resolution      # its RES: the CLI's size
        check(dn.shape == (h, w, 3) and np.ptp(dn) > 0,
              f"the denoised PNG, {dn.shape}, is not uniform")
        print(f"phase 5: cli 8 frames of cornell {w}x{h}, ms "
              f"{[f['ms'] for f in frames]}, files "
              f"{ {k: os.path.getsize(p) for k, p in out.items()} } [{card}]")
        # the evaluator: 32 SVGF frames against 500 accumulated ones
        lines = run_module("ptdn_tpu_torch.app.eval", "scenes/cornell.txt",
                              "--gt-frames", 500, "--frames", 32,
                              timeout=CLI_TIMEOUT)
        ev = json.loads(lines[-1])
        check(ev["rmse_denoised_vs_gt"] < ev["rmse_raw_1spp_vs_gt"],
              f"eval: denoised below raw: {ev}")
        print(f"phase 5: eval {json.dumps(ev)}")
        # the viewer in process: an orbit, a continuous change and the
        # denoise toggle in its watch loop, the launches counted
        r = renderer("cornell")
        step0, kept = r.step, []
        script = ([None, None, "."] + [None] * 3 + ["sigma_l 0.7"]
                  + [None] * 3 + ["D"] + [None] * 5)

        def poll():
            kept.append(r.step is step0)
            return script[len(kept) - 1]
        v = Viewer(r, out_path=os.path.join(tmp, "viewer.png"),
                   display="png")
        reset_counts()
        n = v.watch(max_frames=16, input_poll=poll, report=False)
        torch.cuda.synchronize()
        c = counts()
        svgf_frames = script.index("D")
        check(n == 16 and kept == [True] * (svgf_frames + 1)
              + [False] * (15 - svgf_frames)
              and r.cfg.sigma_l == 0.7
              and not r.cfg.denoise_enable,
              f"viewer: 16 frames, renderer.step kept until 'D': {kept}")
        check(c["scene_intersect_full"] == 3
              and c["path_trace"] == c["deferred_radiance"] == 16
              and c["back_projection_banded"] >= 2
              and c["back_projection_stencil"]
              + c["back_projection_banded"] == svgf_frames
              and c["atrous_level"] == NLEVEL * svgf_frames,
              f"viewer launches {nonzero(c)}: A on frame 0, the orbit and "
              f"the rebuild, B1 and B2 on each frame, C and D on the "
              f"{svgf_frames} SVGF frames")
        print(f"phase 5: viewer 16 frames of cornell (orbit, sigma_l 0.7, "
              f"D), renderer.step kept across the continuous changes, "
              f"launches {json.dumps(nonzero(c))}")
        # a checkpoint: 3 frames, saved, 2 more; a fresh renderer restored
        # from the file renders the same 2 frames bit for bit
        r = renderer("cornell")
        r.render(3)
        path = save_state(os.path.join(tmp, "state"), r.step.frame_state(),
                          r.frame, r.camera)
        want = [[t.clone() for t in r.render_frame()] for _ in range(2)]
        r2 = renderer("cornell")
        restore_renderer(r2, path)
        got = [r2.render_frame() for _ in range(2)]
        check(all(torch.equal(a, b) for x, y in zip(want, got)
                  for a, b in zip(x, y)),
              "the restored renderer renders the same 2 frames")
        print("phase 5: checkpoint of cornell at frame 3 resumed: the next "
              "2 frames equal bit for bit (raw and denoised)")
    check(file_hashes(guarded) == before,
          "benchmarks/gt/*.npz and bench_results.json untouched")
    print(f"phase 5: {len(guarded)} ground-truth and TPU result files "
          f"unchanged; {time.perf_counter() - t0:.1f} s")


def padded(x, halo: int):
    """x with `halo` zero rows above and below: the rows a shard's halo
    brings past the image."""
    pad = x.new_zeros((halo,) + tuple(x.shape[1:]))
    return torch.cat([pad, x, pad])


def shard_counts():
    """The launches of every kernel, and of the shard modes."""
    c = counts()
    c.update({name: getattr(k[0], k[1]) for name, k in SHARD_KERNELS.items()})
    return c


def reset_shard_counts():
    reset_counts()
    for wrapper, counter, _, _ in SHARD_KERNELS.values():
        setattr(wrapper, counter, 0)


def sharded_frames(label, one, many, frames, moving_from=None):
    """Drive the whole image's renderer `one` and the sharded `many`
    through `frames` frames (the camera moving by cornell_svgf_anim_slow's
    automation from frame `moving_from` on), each sharded frame with the
    launch and exchange counts set to 0 just before it and read just
    after: the stitched left and right equal the whole image's bit for
    bit on every frame. Returns the summed counts, the exchanges, and per
    frame whether the back-projection took the near branch and the halo
    rows it exchanged (the same on every shard)."""
    n = many.group.n
    autos = [CameraAutomation(dataclasses.replace(one.cfg, **ANIM_SLOW))
             for _ in range(2)]
    total, exchanges, near, halo = {}, {}, [], []
    for f in range(frames):
        if moving_from is not None and f >= moving_from:
            for r, auto in zip((one, many), autos):
                auto.step(r.camera)
                r.cam_changed = True
        want = one.render_frame()
        reset_shard_counts()
        many.group.exchanges.clear()
        got = many.render_frame()
        torch.cuda.synchronize()
        c = shard_counts()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{label}: frame {f} of {n} shards equals the whole image's "
              f"bit for bit")
        check(bool(torch.isfinite(got[1]).all()), f"{label}: finite")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        for k, v in many.group.exchanges.items():
            exchanges[k] = exchanges.get(k, 0) + v
        dn = [s.denoiser for s in many.step.steps]
        if one.cfg.temporal_enable:
            check(len({d.near for d in dn}) == 1,
                  f"{label}: the shards chose one branch")
            near.append(dn[0].near)
            k = {2 if d.near else d.moved_halo for d in dn}
            check(len(k) == 1, f"{label}: the shards' halos differ: {k}")
            halo.append(k.pop())
        if one.cfg.denoise_enable and one.cfg.spatial_enable:
            check(c["atrous_level_shard"] == c["atrous_level"]
                  == n * one.cfg.atrous_nlevel,
                  f"{label}: frame {f}: D in shard mode {n} x "
                  f"{one.cfg.atrous_nlevel} times, got {c['atrous_level']}, "
                  f"{c['atrous_level_shard']}")
    return total, exchanges, near, halo


def bp_launches(many):
    """(device kernels, aten::cat calls, halo rows) of the back-projection
    of every shard of `many`, as its denoisers run it
    (SVGFDenoiser.back_projection: svgf.shard_back_projection's halo_pack
    and Halo exchange, kernel C's shard mode) on the state its last frame
    left (its color history the frame's color, its previous G-buffer the
    frame's), its branch kept: counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    gens = []
    for step in many.step.steps:
        d = step.denoiser
        gb = {"position": d.prev_position, "normal": d.prev_normal,
              "geom_id": d.prev_geom_id}
        gens.append(d.back_projection(d.bp_args(d.color_history, gb,
                                                many._params)))
    d = many.step.steps[0].denoiser
    k = 2 if d.near else d.moved_halo
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        many.group.run(gens)
        torch.cuda.synchronize()
    kernels = cats = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and getattr(e, "self_device_time_total", 0) > 0:
            kernels += e.count
        cats += e.count if e.key == "aten::cat" else 0
    return kernels, cats, k


def sharded_phase(card, out, frame_ms):
    """Phase 6: the row-sharded frame step (ptdn_tpu_torch/parallel/) at
    the headline's width, cornell 800x800 with CFG: D's and C's shard
    modes against their plain versions and the unsharded kernels; the
    in-process group at 8 and 16 shards through still and moving frames,
    room, diamond and native cornell at 8, and two gloo ranks, each
    frame equal to the whole image's bit for bit; times.
    Appends the shard modes' entries to `out`."""
    t0 = time.perf_counter()
    stats, work, times = {}, {}, {}
    warm = renderer("cornell")
    for _ in range(3):
        warm.render_frame()
    cam = warm._cam[0]
    w, h = warm.resolution
    st = warm.step.frame_state()
    rad, gb = warm.step.tracer(cam, warm._params, 3, False)
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    raw = rad.reshape(h, w, 3)
    alphas = (float(CFG.color_alpha), float(CFG.moment_alpha))
    prev = [st["prev_normal"], st["prev_geom_id"], st["color_history"],
            st["moment_history"], st["history_length"]]
    moved = torch.eye(4, device=DEVICE)
    moved[0, 3] = 0.3

    # C's shard mode: both modes on 4, 8 and 16 shards, its own rows in
    # place and its halo rows packed and exchanged as the sharded
    # denoiser does (back_projection_shards), against its plain version
    # and the unsharded kernel's rows, bit for bit; each count's sum and
    # one shard of 8 timed beside the unsharded launch
    c_ms = {}
    for name, view in (("back_projection_stencil_rows", st["prev_view"]),
                       ("back_projection_banded_rows",
                        st["prev_view"] @ moved)):
        banded = name == "back_projection_banded_rows"
        bounds = reproject.motion_bounds((w, h), gb, view)
        check(bool(bounds[0]) != banded, f"{name}: the branch")
        args = ((w, h), raw, gb, {"normal": prev[0], "geom_id": prev[1]},
                view, *prev[2:], *alphas)
        starts = bounds[1:].tolist() if banded else None
        whole = ((lambda a=args, b=bounds: C._back_projection_banded_kernel(
            *a, b[1:], reproject.BAND_ROWS, reproject.BAND_MARGIN))
            if banded else functools.partial(
                C._back_projection_stencil_kernel, *args))
        want = whole()
        kfn, pfn = ((C._back_projection_banded_kernel,
                     C.back_projection_banded_plain) if banded else
                    (C._back_projection_stencil_kernel,
                     C.back_projection_stencil_plain))
        off, err, calls, halos = 0, 0.0, {}, {}
        for n in C_SHARDS:
            calls[n], halos[n] = back_projection_shards(args, n, starts)
            got = []
            for sargs, kw in calls[n]:
                k = kfn(*sargs, **kw)
                p = pfn(*sargs, **kw)
                hl = sargs[0][1]
                off += sum(int((~((a == b) | (torch.isnan(a)
                                              & torch.isnan(b))))
                               .reshape(hl * w, -1).any(-1).sum())
                           for a, b in zip(k, p))
                err = max([err] + [max_abs(a, b) for a, b in zip(k, p)])
                got.append(k)
            check(all(torch.equal(torch.cat([g[i] for g in got]), want[i])
                      for i in range(4)),
                  f"{name}, {n} shards: the shards' rows equal the "
                  f"unsharded kernel's")
        check(off <= LANES_OFF_ALLOWED,
              f"{name}: {off} pixels off the plain version")
        # the second shard of 8: timed, and its bound: its rows of the
        # current frame in (color, position, normal, geom), the previous
        # frame's rows that its taps read in this run (C.tap_rows, 40 B
        # a pixel) and its own rows' history lengths, its rows out; ~200
        # operations a pixel. Beside it, the bound on every row its taps
        # may read (its own and those of Rows.reach), which the halo
        # holds
        sargs, kw = calls[SHARDS[0]][1]
        hl, r0 = sargs[0][1], kw["rows"][0]
        times[name] = (functools.partial(kfn, *sargs, **kw),
                       functools.partial(pfn, *sargs, **kw))
        read = C.tap_rows(sargs[0], sargs[2], sargs[4], sargs[7],
                          kw["rows"], sargs[10:] or None)
        n_read, n_own = int(read.sum()), int(read[r0:r0 + hl].sum())
        io = nbytes(sargs[1], *(sargs[2][k_] for k_ in (
            "position", "normal", "geom_id")), *kfn(*sargs, **kw))
        work[name] = bound(io + (n_read * 40 + (hl - n_own) * 4) * w,
                           hl * w * 200)
        above, below = reproject.Rows.reach(r0, hl, h, starts)
        reach_ms = bound(io + (hl + above + below) * w * 40,
                         hl * w * 200)[0]
        c_ms[name] = {
            "unsharded": cuda_ms(whole, reps=10, hide_host=True),
            "one shard of 8": cuda_ms(times[name][0], reps=10,
                                      hide_host=True),
            **{f"{n} shards": cuda_ms(
                lambda c=calls[n]: [kfn(*a, **kw_) for a, kw_ in c],
                reps=10, hide_host=True) for n in C_SHARDS}}
        stats[name] = err
        print(f"phase 6: {name.replace('_rows', '')} in shard mode on "
              f"{C_SHARDS} shards (halo rows "
              f"{json.dumps({n: halos[n] for n in C_SHARDS})}): equal to "
              f"its plain version ({off} pixels off) and to the unsharded "
              f"kernel, bit for bit; ms "
              + ", ".join(f"{k_} {v:.4f}" for k_, v in c_ms[name].items())
              + f"; one shard of {SHARDS[0]}: its taps read {n_read} "
              f"previous rows (bound {work[name][0]:.4f} ms), may read "
              f"{hl + above + below} (bound {reach_ms:.4f} ms) [{card}]")
        if not banded:
            src, var = want[1], want[0]
    frame_ms["C shard mode"] = c_ms

    # D's shard mode at every level, 8 and 16 shards, against its plain
    # version and the unsharded kernel (the level before's output in);
    # with row0 = 0 and no halo, the unsharded call
    sig = (float(CFG.sigma_l), float(CFG.sigma_n), float(CFG.sigma_x))
    static = D.pack_static_planes(gb["position"], gb["normal"])
    albedo = (gb["albedo"] * gb["ialbedo"]).contiguous()
    sh = D.atrous_halo(NLEVEL)
    sext = padded(static, sh)
    d_ms = {}
    for level in range(1, NLEVEL + 1):
        last = level == NLEVEL
        alb = albedo if last else None
        want = D._atrous_level_kernel(src, var, static, alb, level, *sig,
                                      CFG.blur_variance)
        whole = D._atrous_level_kernel(src, var, static, alb, level, *sig,
                                       CFG.blur_variance, False, 0, h, None,
                                       0)
        check(torch.equal(whole[0], want[0])
              and torch.equal(whole[1], want[1]),
              f"D level {level} with row0 0 and no halo is the unsharded D")
        halo = D.atrous_halo(level)
        # the image's packed rows, `halo` zero rows above and below: a
        # shard's own rows and its halo rows are slices of it, apart
        ext = padded(torch.cat([src, var[..., None]], -1), halo)
        calls = {}
        for n in D_SHARDS:
            hl = h // n
            outs, calls[n] = [], []
            for r0 in range(0, h, hl):
                own = ext[halo + r0:halo + r0 + hl]
                rows = (ext[r0:r0 + halo],
                        ext[r0 + hl + halo:r0 + hl + 2 * halo])
                dargs = (own[..., :3], own[..., 3],
                         sext[r0:r0 + hl + 2 * sh],
                         None if alb is None else alb[r0:r0 + hl], level,
                         *sig, CFG.blur_variance, False, r0, h, rows, sh)
                k = D._atrous_level_kernel(*dargs)
                p = D.atrous_level_plain(*dargs)
                check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
                      f"D's shard mode, level {level}, {n} shards, row "
                      f"{r0}: equal to its plain version")
                outs.append(k)
                calls[n].append(dargs)
            check(torch.equal(torch.cat([o[0] for o in outs]), want[0])
                  and torch.equal(torch.cat([o[1] for o in outs]), want[1]),
                  f"D's shard mode, level {level}, {n} shards: the "
                  f"unsharded level's rows")
        one8 = calls[SHARDS[0]][1]
        d_ms[level] = {
            "unsharded": cuda_ms(lambda: D._atrous_level_kernel(
                src, var, static, alb, level, *sig, CFG.blur_variance),
                reps=10, hide_host=True),
            "one shard of 8": cuda_ms(lambda: D._atrous_level_kernel(*one8),
                                      reps=10, hide_host=True),
            **{f"{n} shards": cuda_ms(
                lambda: [D._atrous_level_kernel(*a) for a in calls[n]],
                reps=10, hide_host=True) for n in D_SHARDS}}
        d_ms[level].update({f"{n} shards / unsharded": d_ms[level][
            f"{n} shards"] / d_ms[level]["unsharded"] for n in D_SHARDS})
        if level == 1:
            hl = h // SHARDS[0]
            rows = hl + 2 * halo
            times["atrous_level_shard"] = (
                functools.partial(D._atrous_level_kernel, *one8),
                functools.partial(D.atrous_level_plain, *one8))
            # the shard's rows and halo rows of color, variance, position
            # and normal read, its rows written; 25 taps of ~40 operations
            work["atrous_level_shard"] = bound(
                rows * w * (16 + 24) + hl * w * 16, hl * w * 25 * 40)
        src, var = want
    stats["atrous_level_shard"] = 0.0
    frame_ms["D shard mode by level"] = d_ms
    print("phase 6: D's shard mode equals its plain version and the "
          f"unsharded level at every level on {D_SHARDS} shards, and with "
          "row0 0 and no halo the unsharded D; ms by level: "
          + "; ".join(f"{lv}: " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in m.items())
                      for lv, m in d_ms.items()) + f" [{card}]")

    # the main path: the in-process group, still then moving frames
    launches = {}
    for n in SHARDS:
        one = renderer("cornell")
        many = ShardedRenderer(scene("cornell"), CFG, (w, h),
                               InProcessGroup(n), device=DEVICE)
        frames = SHARD_STILL + SHARD_MOVING
        total, exch, near, halo = sharded_frames(
            f"cornell {n} shards", one, many, frames,
            moving_from=SHARD_STILL)
        far = near.count(False)
        check(near[:SHARD_STILL] == [False] + [True] * (SHARD_STILL - 1),
              f"{n} shards: far on frame 0 only while still: {near}")
        # a frame's halos: one a level, the previous frame's rows its
        # back-projection reads (2 when near, its bands' reach when far:
        # never the whole image), the G-buffer's when the camera moved
        halos = sum(NLEVEL + 1 + (f == 0 or f >= SHARD_STILL)
                    for f in range(frames))
        check(exch.get("Halo", 0) == halos and set(exch) <= {"Halo",
                                                              "Reduce"}
              and exch.get("Reduce", 0) == 2 * (2 + SHARD_MOVING),
              f"{n} shards: exchanges {exch}")
        # 2 rows when near; the moving frames' halos reach the bands'
        # slabs, not the whole image (frame 0's view is the identity)
        moving = [k_ for k_, nr in zip(halo[SHARD_STILL:],
                                       near[SHARD_STILL:]) if not nr]
        check(all(k_ == 2 for k_, nr in zip(halo, near) if nr)
              and all(0 < k_ < h - h // n for k_ in moving),
              f"{n} shards: back-projection halo rows {halo}")
        if n == SHARDS[0]:
            bp_moved = bp_launches(many)
        check(total["back_projection_banded_rows"] == n * far
              and total["back_projection_stencil_rows"]
              == n * (frames - far)
              and total["path_trace"] == total["deferred_radiance"]
              == n * frames
              and total["scene_intersect_full"] == n * (1 + SHARD_MOVING),
              f"{n} shards: launches {nonzero(total)}")
        print(f"phase 6: cornell {w}x{h} in {n} shards, the back-projection's "
              f"halo rows a frame (each shard sends its first and last "
              f"that many rows, at most its own): {halo}")
        if n == SHARDS[0]:
            launches = total
        print(f"phase 6: cornell {w}x{h} in {n} shards of {h // n} rows, "
              f"{SHARD_STILL} still then {SHARD_MOVING} moving frames "
              f"({far} far), every frame equal to the whole image's bit "
              f"for bit; launches {json.dumps(nonzero(total))}; exchanges "
              f"{json.dumps(exch)} (D {n} x {NLEVEL} a frame)")
        if n == SHARDS[0]:
            one, many = renderer("cornell"), ShardedRenderer(
                scene("cornell"), CFG, (w, h), InProcessGroup(n),
                device=DEVICE)
            for r in (one, many):
                for _ in range(3):
                    r.render_frame()
            ms = in_turns({"unsharded": one.render_frame,
                           f"{n} shards": many.render_frame}, reps=10)
            frame_ms["cornell sharded turns"] = ms
            for label, (kernels, cats, k) in (("still", bp_launches(many)),
                                              ("moved", bp_moved)):
                hl = h // n
                # a shard: halo_pack's two casts and one cat, kernel C;
                # the image's first and last rows' zero halo rows
                one_hop = k <= hl
                if label == "still" or one_hop:
                    check(kernels <= 4 * n + 2 and cats == n,
                          f"{n} shards, {label}: the back-projection "
                          f"launched {kernels} kernels, {cats} cats")
                print(f"phase 6: cornell {n} shards, a {label} frame's "
                      f"back-projection ({k} halo rows, "
                      f"{'one hop' if one_hop else 'several hops'}): "
                      f"{kernels} kernels, {cats} torch.cat (profiler), "
                      f"no window and no plane copy")
            print(f"phase 6: cornell {w}x{h} still, ms/frame in turns: "
                  + ", ".join(f"{k} {v}" for k, v in ms.items())
                  + f" (the shards one after another on one card) [{card}]")
    for label, (name, flags, res) in SHARD_RUNS.items():
        one = renderer(name, res, **flags)
        many = ShardedRenderer(scene(name), one.cfg, res,
                               InProcessGroup(SHARDS[0]), device=DEVICE)
        total, exch, _, _ = sharded_frames(f"{label} {SHARDS[0]} shards",
                                           one, many, SHARD_RUN_FRAMES)
        print(f"phase 6: {label} {res[0]}x{res[1]} "
              f"({many.step.steps[0].tracer.engine}) in {SHARDS[0]} shards "
              f"of {res[1] // SHARDS[0]} rows, {SHARD_RUN_FRAMES} frames "
              f"equal to the whole image's bit for bit; launches "
              f"{json.dumps(nonzero(total))}; exchanges {json.dumps(exch)}")

    # two torch.distributed ranks over gloo on the one card
    t1 = time.perf_counter()
    got = run_ranks(RANKS, "cornell", dataclasses.asdict(CFG), (w, h),
                    RANKS_FRAMES, DEVICE, RANKS_TIMEOUT)
    one = renderer("cornell")
    for _ in range(RANKS_FRAMES):
        want = one.render_frame()
    check(all(np.array_equal(g, x.cpu().numpy()) for g, x in zip(got, want)),
          f"{RANKS} gloo ranks: the stitched frame equals the whole image's")
    print(f"phase 6: {RANKS} gloo ranks on the one card, {h // RANKS} rows "
          f"each, {RANKS_FRAMES} frames: the stitched frame equals the "
          f"whole image's bit for bit ({time.perf_counter() - t1:.1f} s)")

    for name, (wrapper, counter, source, replaces) in SHARD_KERNELS.items():
        kfn, pfn = times[name]
        ms = cuda_ms(kfn, reps=10, hide_host=True)
        plain_ms = cuda_ms(pfn, reps=3, warmup=1, hide_host=True)
        bound_ms, bound_by = work[name]
        check(launches[name] > 0, f"{name} launched on the main path")
        out.append({"name": name, "route": "cuda",
                    "source": "ptdn_tpu_torch/" + source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": stats.get(name, 0.0), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
        print(f"phase 6: {name} (one shard of {h // SHARDS[0]} rows) "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}); {launches[name]} launches in the "
              f"{SHARDS[0]}-shard run [{card}]")
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")


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
    # O has two kernels (the staged one and the global-load one); B1's
    # table build, F, H, A and J have a native build each (compat=False),
    # E its light-table entry, R one kernel, D's shard mode two (one and
    # two row phases a block) and C's shard mode two (stencil, band; the
    # stencil one also takes the whole image), beside the whole image's
    # band mode
    check(len(regs) == 31, f"31 kernels in the library, got {regs}")
    # kernels B1, F, H, A, J, I and M (with and without the cull) are
    # built per scene, with the scene's constants (csrc/scene/*.cu), every
    # scene's at once, and the native runs' scenes in native mode
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SCENE_BUILDS)) as pool:
        scene_logs = dict(zip(
            (name + ("" if compat else " native")
             for name, compat in SCENE_BUILDS),
            pool.map(lambda b: _lib.build_scene(A.geom_info(
                native_scene(b[0]), DEVICE, b[1]).path_scene,
                force=True)[1], SCENE_BUILDS)))
    t_scene = time.perf_counter() - t1
    scene_regs = {name: ptxas_summary(lg) for name, lg in scene_logs.items()}
    check(all(len(r) == 8 for r in scene_regs.values()),
          f"8 kernels per scene, got {scene_regs}")
    print(f"phase 1: built {len(list(_lib.CSRC.glob('*.cu')))} sources for "
          f"sm_90a in {t1 - t0:.1f} s, then B1, F, H, A, J, I and M for "
          f"each of {len(SCENE_BUILDS)} scene headers "
          f"(csrc/scene/path_trace.cu, "
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
        lambda *a, starts, rows=None, halo=None: got.append(
            a + (starts, reproject.BAND_ROWS, reproject.BAND_MARGIN))
        or real_banded(*a, starts=starts, rows=rows, halo=halo))
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
            r, 2, ("shade_bounce", "trace_bounce", "inrow_permute",
                   "ranges_and_key")))
    dr, cap = mesh["diamond"]
    (e_planes, e_mats), e_kw = cap["shade_bounce"]
    # the frame's E wrote into its bounce's allp (out=); here into its own
    check(e_kw.pop("out").shape[0] == E.N_OUT,
          "E writes the sorted bounce's planes into allp")
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

    # Q on the same bounce-2 states, on terrain30k's (233 chunks: the
    # supergroups) and on room's at 1920x1080 with bench.py's moving
    # camera (a moved frame's), and on the shared edge inputs
    q_cases = {name: cap["ranges_and_key"] for name, (_, cap) in mesh.items()}
    r = renderer("terrain30k")
    for _ in range(3):
        r.render_frame()
    q_cases["terrain30k"] = BB.capture_bounce(
        r, 2, ("ranges_and_key",))["ranges_and_key"]
    r = renderer("room", (1920, 1080), **MOTION_RUNS["1080p_animated"][1])
    mov = Motion(r)
    for _ in range(3):
        mov.frame()
    check(mov.auto.step(r.camera), "room 1920x1080: the camera moves")
    r.cam_changed = True
    q_cases["room 1920x1080 moving"] = BB.capture_bounce(
        r, 2, ("ranges_and_key",))["ranges_and_key"]
    del r, mov
    q_work = {}
    for name, (q_args, q_kw) in q_cases.items():
        q_work[name] = q_check(f"{name} bounce 2", q_args, q_kw["boxes"])
    for label, case in Q.edge_inputs(0).items():
        e_args = Q.edge_call(case, DEVICE)
        q_check(f"edge inputs, {label}", e_args,
                Q.range_boxes(e_args[0], case["n_chunks"]))
    stats["ranges_and_key"] = 0.0
    work["ranges_and_key"] = q_work["diamond"]

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

    # native mode. R on native cornell's spatial-only frame (every pixel
    # runs the 49 taps: the JSON line's) and on the fourth frame of its
    # temporal run (the fallback: a pixel whose history has reached 4
    # frames passes its temporal variance through, the others, those the
    # back-projection keeps rejecting among them, run the taps); E's light
    # table on the two-light scene's bounce 2;
    # the native builds of F, H, A (bounce 2), J (the camera rays) and
    # B1 (per-scene and table builds) on bunny, output by output
    r_cases = {}
    for label, flags in (("spatial-only", dict(temporal_enable=False)),
                         ("temporal", {})):
        r = native_renderer("cornell", **NATIVE, **flags)
        for _ in range(3):
            r.render_frame()
        r_cases[label] = BB.capture_bounce(
            r, 1, ("spatial_variance_fallback",),
            svgf)["spatial_variance_fallback"][0]
    for label, r_args in r_cases.items():
        kr = R._spatial_variance_kernel(*r_args)
        pr = R.spatial_variance_plain(*r_args)
        err = max_abs(kr, pr)
        off = int((kr != pr).sum())
        rel = float(((kr - pr).abs() / pr.abs().clamp_min(1e-30)).max())
        taps = int(BB.r_need(r_args).sum())
        check(err <= SV_ATOL, f"R on cornell's {label} frame: max |d| "
              f"{err} > {SV_ATOL}, {off} pixels off its plain version")
        if label == "spatial-only":
            sv_args = r_args
            stats["spatial_variance"] = err
            work["spatial_variance"] = BB.r_work(r_args, kr,
                                                 BB.r_need(r_args))
        else:
            sv_pass_args, sv_pass_taps = r_args, taps
            sv_none_args = BB.r_none_needed(r_args)
            kn = R._spatial_variance_kernel(*sv_none_args)
            check(same(kn, r_args[5]), "R where no pixel needs the taps "
                  "gives the temporal variance bit for bit")
        print(f"phase 2: R on native cornell's {label} frame: {taps} of "
              f"{kr.numel()} pixels run the taps "
              f"({BB.r_blocks(BB.r_need(r_args).cpu().numpy())}); {off} "
              f"pixels off its plain version (max |d| {err:.3g}, largest "
              f"relative difference {rel:.3g})")
    tl = native_renderer("twolight", **NATIVE)
    for _ in range(3):
        tl.render_frame()
    (lt_planes, lt_mats), lt_kw = BB.capture_bounce(
        tl, 2, ("shade_bounce",))["shade_bounce"]
    check(lt_kw["lights"] is not None and tl.step.tracer.multi_light,
          "the two-light scene takes E's light table in native mode")
    klt = E._shade_bounce_kernel(lt_planes, lt_mats, **lt_kw)
    plt = E.shade_bounce_plain(lt_planes, lt_mats, **lt_kw)
    stats["shade_bounce_lights"] = max_abs(klt, plt)
    check(klt.shape[0] == E.N_OUT + 1 and same(klt, plt),
          f"E's light table equals its plain version: max |d| "
          f"{stats['shade_bounce_lights']}")
    work["shade_bounce_lights"] = bound(
        nbytes(lt_planes, klt, lt_kw["lights"]), klt[0].numel() * SHADE_OPS)
    drawn = klt[E.O_LI][klt[E.O_NEE] > 0.5]
    print(f"phase 2: E's light table on the two-light scene's bounce 2 "
          f"equal on {tuple(klt.shape)} planes; NEE lanes drawing light "
          f"0 / 1: {int((drawn == 0).sum())} / {int((drawn == 1).sum())}")
    nb_cases = {}
    for kernel, flags in (("trace_bounce", {}), ("bounce_fused", FUSED),
                          ("scene_intersect_full", SPLIT)):
        r = renderer("bunny", **NATIVE, **flags)
        for _ in range(3):
            r.render_frame()
        nb_cases[kernel] = BB.capture_bounce(r, 2, (kernel,))[kernel]
    nb1 = renderer("bunny", **NATIVE, sort_rays=False)
    for _ in range(3):
        nb1.render_frame()
    nb1_args = b1_args(nb1)
    o_nb, d_nb = generate_camera_rays(nb1._cam[0], nb1.resolution)
    nb_cases["scene_intersect_full_tex"] = (
        [nb1_args[0], nb1_args[1], o_nb, d_nb], {})
    nb_cases["path_trace_table"] = (list(nb1_args[:3]), dict(zip(
        ("frame", "lane0", "depth", "light", "flags"), nb1_args[3:])))
    for kernel, (n_args, n_kw) in nb_cases.items():
        check(not n_args[1].compat and n_args[1].path_scene is not None
              and "kCompat = false" in n_args[1].path_scene,
              f"{kernel} on native bunny: a native per-scene build")
        plane_check(kernel, f"{kernel} native on bunny", n_args, n_kw,
                    BB.kernel_fn(kernel)(*n_args, **n_kw),
                    BB.plain_fn(kernel)(*n_args, **n_kw))

    # N on the texgather probe's four tables and index orders
    n_cases = probe_n.cases(DEVICE)
    for label, (table, idx) in n_cases.items():
        kn = N._gather_u32_kernel(table, idx)
        check(torch.equal(kn.view(torch.int32), N.gather_u32_plain(
            table, idx).view(torch.int32)), f"N on {label} equals its "
              f"plain version")
    # an odd length, a slice at a misaligned offset (its head), no index
    n_table, n_idx = n_cases["room random"]
    for label, ix in (("an odd length", n_idx[:probe_n.N - 7]),
                      ("a misaligned slice", n_idx[1:probe_n.N - 2]),
                      ("no index", n_idx[1:1])):
        kn_ = N._gather_u32_kernel(n_table, ix)
        check(kn_.shape == ix.shape and torch.equal(
            kn_.view(torch.int32), N.gather_u32_plain(n_table, ix).view(
                torch.int32)), f"N on {label} equals its plain version")
    stats["gather_u32"] = 0.0
    n_args = n_cases["room random"]
    work["gather_u32"] = bound(
        nbytes(n_args[1], kn) + 4 * torch.unique(n_args[1]).numel(), 0)
    print(f"phase 2: N equal on {', '.join(n_cases)} "
          f"({probe_n.N} indices), and on room's with an odd length, a "
          f"misaligned slice and no index")

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
    rmse, runs, motion, lefts = {}, {}, {}, {}
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
        lefts[label] = left
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
    # native mode and NEE toward a mesh light: 32 frames each, launches
    # checked, finite; native cornell against the ground truth, and
    # bunny's native raw frame off its compat one (the normals' mode
    # reaches the kernels)
    native_r = {}
    for label, (name, flags, engine) in NATIVE_RUNS.items():
        r = native_renderer(name, **flags)
        check(r.step.tracer.engine == engine,
              f"{label}: engine {r.step.tracer.engine}, expected {engine}")
        mov = Motion(r)
        reset_counts()
        for _ in range(FRAMES):
            left, right = mov.frame()
        torch.cuda.synchronize()
        c = counts()
        runs[tuple(label.split(" ", 1))] = c
        want = expected_launches(r, mov)
        check({k: c[k] for k in want} == want,
              f"{label}: launches {c}, expected {want}")
        check(len(mov.calls) == (2 if r.cfg.temporal_enable else 0),
              f"{label}: motion_bounds read on frames 0 and 1 only")
        check(bool(torch.isfinite(left).all())
              and bool(torch.isfinite(right).all()), f"{label}: finite")
        line = (f"phase 3: {label} 800x800 ({engine}): {FRAMES} frames, "
                f"launches {json.dumps(nonzero(c))}")
        if label == "cornell native":
            e_dn, e_raw = rmse_vs_gt("cornell", left, right)
            rmse[label] = {"denoised": e_dn, "raw": e_raw}
            check(e_dn < 0.5 * e_raw, f"{label}: denoised RMSE {e_dn} < "
                  f"0.5 x raw {e_raw}")
            line += f"; RMSE vs GT denoised {e_dn:.5f} raw {e_raw:.5f}"
        if label == "bunny native":
            diff = float((left - lefts["bunny sorted"]).abs().max())
            check(diff > 1e-3, f"{label}: raw frame off compat's by {diff}")
            line += f"; raw frame off compat mode's by up to {diff:.4g}"
        native_r[label] = r
        print(line)
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
            # the engine A/B of the mesh scenes: the sort (each scene's
            # default), B1, the fused and the split per-bounce engines
            *((name, name, None, 10, ENGINE_AB)
              for name in ("diamond", "bunny", "room", "terrain30k")),
            ("room 1920x1080 moving", "room", (1920, 1080), 4,
             {k: dict(MOTION_RUNS["1080p_animated"][1], **kw)
              for k, kw in ENGINE_AB.items()})):
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
    q_args, q_boxes = q_cases["diamond"][0], q_cases["diamond"][1]["boxes"]
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
        "ranges_and_key": (
            lambda: Q._ranges_and_key_kernel(q_boxes, *q_args[1:]),
            lambda: Q.ranges_and_key_plain(*q_args), None),
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
        "spatial_variance": (
            lambda: R._spatial_variance_kernel(*sv_args),
            lambda: R.spatial_variance_plain(*sv_args), None),
        "shade_bounce_lights": (
            lambda: E._shade_bounce_kernel(lt_planes, lt_mats, **lt_kw),
            lambda: E.shade_bounce_plain(lt_planes, lt_mats, **lt_kw), None),
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
    # Q at bounce 2 of each scene, room at 1920x1080 moving its largest,
    # beside its plain version and its bound
    for name, (qa, qkw) in q_cases.items():
        ms = cuda_ms(lambda: Q._ranges_and_key_kernel(qkw["boxes"], *qa[1:]),
                     reps=10, hide_host=True)
        plain_ms = cuda_ms(lambda: Q.ranges_and_key_plain(*qa), reps=3,
                           warmup=1, hide_host=True)
        b_ms, b_by = q_work[name]
        frame_ms[f"Q {name} bounce 2"] = {"ms": ms, "plain_ms": plain_ms,
                                         "bound_ms": b_ms, "bound_by": b_by}
        print(f"phase 4: Q on {name} bounce 2 ({qa[1][0].numel()} lanes, "
              f"{qkw['boxes'].shape[0]} boxes): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
    # N on the texgather probe's four cases beside its plain version and
    # torch.take
    for label, (table, idx) in n_cases.items():
        t32, i64 = table.view(torch.int32), idx.to(torch.int64)
        ms = cuda_ms(lambda: N._gather_u32_kernel(table, idx), reps=20,
                     hide_host=True)
        take_ms = cuda_ms(lambda: torch.take(t32, i64), reps=20,
                          hide_host=True)
        plain_ms = cuda_ms(lambda: N.gather_u32_plain(table, idx), reps=20,
                           hide_host=True)
        b_ms, b_by = bound(nbytes(idx, idx) + 4 * torch.unique(idx).numel(),
                           0)
        frame_ms[f"N {label}"] = {"ms": ms, "take_ms": take_ms,
                                  "plain_ms": plain_ms, "bound_ms": b_ms}
        print(f"phase 4: N on {label}: {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, torch.take {take_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}) [{card}]")
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
           for label, m_args in m_cases.items() for cull in (True, False)},
        # the native builds (compat=False) on bunny beside the compat
        # rows above: F, H and A at bounce 2, J on the camera rays (and
        # its compat build there)
        "F bunny bounce 2 native": ("trace_bounce", nb_cases["trace_bounce"],
                                    ("bunny", "native")),
        "H bunny bounce 2 native": ("bounce_fused", nb_cases["bounce_fused"],
                                    ("bunny", "native")),
        "A bunny bounce 2 native": ("scene_intersect_full",
                                    nb_cases["scene_intersect_full"],
                                    ("bunny", "native")),
        "J bunny camera native": ("scene_intersect_full_tex",
                                  nb_cases["scene_intersect_full_tex"],
                                  ("bunny", "native")),
        "J bunny camera": ("scene_intersect_full_tex",
                           (list(m_cases["bunny's camera rays"]), {}),
                           ("bunny", "native"))}
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
    # B1 on bunny's primary state, native and compat, each through its
    # per-scene build and its table build, in turns
    cb1 = renderer("bunny", sort_rays=False)
    for _ in range(3):
        cb1.render_frame()
    cb1_args = b1_args(cb1)
    b1_fns = {}
    for mode, a in (("compat", cb1_args), ("native", nb1_args)):
        b1_fns[mode + " per-scene"] = lambda a=a: B._path_trace_kernel(*a)
        b1_fns[mode + " table"] = lambda a=a: B._path_trace_kernel(
            a[0], a[1]._replace(path_scene=None), *a[2:])
    frame_ms["B1 bunny native and compat"] = b1_ms = in_turns(b1_fns,
                                                              reps=3)
    print("phase 4: B1 on bunny's primary state, builds in turns: "
          + ", ".join(f"{k} {v}" for k, v in b1_ms.items())
          + f" ms [{card}]")
    # the native build's bound (the plain version's lane-triangle tests)
    # and its plain version's time on the same state
    nb_args, nb_kw = nb_cases["path_trace_table"]
    (nbc, nbt), nb_tests, _ = BB.b1_plain_counted(nb_args, nb_kw)
    nb_bound = BB.b1_work(nb_args, nb_kw, nbc, nbt, nb_tests)
    nb_plain_ms = cuda_ms(lambda: B.path_trace_plain(*nb_args, **nb_kw),
                          reps=1, warmup=0, hide_host=True)
    frame_ms["B1 bunny native bound and plain"] = [nb_bound[0], nb_plain_ms]
    print(f"phase 4: B1 native on bunny's primary state: bound "
          f"{nb_bound[0]:.4f} ms ({nb_bound[1]}, {nb_tests} lane-triangle "
          f"tests), plain {nb_plain_ms:.1f} ms [{card}]")
    # R on a still camera's steady frame (the fourth: the fallback), and
    # on it where no pixel needs the taps
    sv_pass_ms = cuda_ms(lambda: R._spatial_variance_kernel(
        *sv_pass_args), reps=20, hide_host=True)
    sv_none_ms = cuda_ms(lambda: R._spatial_variance_kernel(
        *sv_none_args), reps=20, hide_host=True)
    frame_ms["R fallback"] = sv_pass_ms
    frame_ms["R none needed"] = sv_none_ms
    sv_pass_bound = BB.r_work(sv_pass_args, sv_pass_args[5],
                              BB.r_need(sv_pass_args))
    sv_none_bound = BB.r_work(sv_none_args, sv_pass_args[5],
                              BB.r_need(sv_none_args))
    print(f"phase 4: R on native cornell's fourth temporal frame "
          f"({sv_pass_taps} of {sv_pass_args[0][..., 0].numel()} pixels "
          f"run the taps) {sv_pass_ms:.4f} ms (bound {sv_pass_bound[0]:.4f}"
          f" ms, {sv_pass_bound[1]}); where no pixel needs the taps "
          f"{sv_none_ms:.4f} ms (bound {sv_none_bound[0]:.4f} ms, "
          f"{sv_none_bound[1]}); on its spatial-only frame see its JSON "
          f"row [{card}]")
    # the native and mesh-light runs' frames, two turns each
    for label, r in native_r.items():
        ms = [cuda_ms(r.render_frame, reps=10) for _ in range(2)]
        frame_ms[label] = ms
        print(f"phase 4: {label} 800x800 ({r.step.tracer.engine}) {ms} "
              f"ms/frame [{card}]")
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

    # ---- phase 5: the entry points ----
    entry_points(card, rmse, frame_ms)
    print(f"phase 5: all phases {time.perf_counter() - t_all:.1f} s")

    # ---- phase 6: the row-sharded frame step ----
    sharded_phase(card, out, frame_ms)
    print(f"phase 6: all phases {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": out, "frame_ms": frame_ms, "rmse": rmse}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
