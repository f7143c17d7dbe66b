"""Kernels F (trace_bounce), H (bounce_fused), A (scene_intersect_full),
J (scene_intersect_full_tex), I (light_visibility), L
(back_projection_atrous1), M (scene_intersect), Q (ranges_and_key), R
(spatial_variance), B1's table build (path_trace_table) and the moved
frame's glue (S1, S2, T) on the card, on the calls of the scenes whose
users feel them.

    python3 -m ptdn_tpu_torch.bounce_bench [--reps N] [--cases LIST]
                                           [--variant NAME=DIR]...
                                           [--out FILE]

Each case renders three frames of a scene through its engine (depth 8,
RenderConfig's defaults otherwise) and captures the arguments of one
call of the kernel on the fourth frame: the bounce-2 call of F (the
sorted wavefront), of Q (the same), of H (the fused per-bounce
engine) or of A, J or I
(the split per-bounce engine), or A's primary hit, the camera rays of a
frame whose camera moved, or B1's call (the whole-path engine, its only
one in a frame). M takes the trace bench's rays (trace_bench.setup, the
chunk cull on and off) or a scene's camera rays. On them, for each build
of the kernel (the scene's own, csrc/scene/bounce.cu or
scene_intersect.cu, or for B1's table build the per-scene B1,
csrc/scene/path_trace.cu, where the scene has one, and the kernel
library's)

* counts, per output, the lanes where the kernel's value differs from
  its plain version's in any bit (two NaNs count as equal): H's 21 B_*
  planes, F's 23 next planes (its radiance by pixel on the last depth);
  A's t, normal, uv, material
  and geom, and J's texel index besides; I's lit flag; M's five
  outputs; Q's 26 planes and its key; B1's 6 x depth contribution
  planes and depth - 1 texel-index planes; and the same against the
  first build's output;
* times the kernel with CUDA events over N launches (default 20), the
  host hidden behind a device spin (utils/card.py:cuda_ms), the builds
  in turns there and back, and the plain version once;
* computes the kernel's bound: its inputs and outputs once over the HBM
  rate (F's 26 planes read through the sort's order and the int64 order
  itself among them), or its operations over the float32 rate, counting
  the analytic
  tests of every ray (both rays in F and H, and in B1 at every depth),
  the refine and, in H and B1, the shading of every lane, and the
  lane-triangle tests that the plain version's scan made; Q's bytes
  are the planes its live and NEE lanes need (ops/cuda/ranges.py:
  traffic, the shares printed) and its operations its box tests
  (ops/cuda/ranges.py:box_tests).

The F cases also time, in turns with the builds, the gather F's
ordered reads replaced (index_select of the bounce's 26 planes by the
order), this tree's F on those gathered planes through the identity
order, and for each variant whose F predates the order (its
csrc/bounce.cuh has no `order` in TraceArgs: an older tree's) that F on
the gathered planes as it ran (PlanesTraceArgs), alone and with the
gather and the cat of the next planes around it, each output counted
against this tree's.

The L case takes L's call on the fourth frame of cornell at 800x800
with fuse_reproject_l1 (a still camera: L on every frame after the
first), and times there, in turns, each build of L beside kernel C
(stencil mode) alone and kernel D at level 1 alone on C's output and
the packed G-buffer planes, as the frame without the flag runs them;
per output (color, variance, moments, history) it counts the pixels off
L's plain version and off C's then D's kernels.

The R cases take R's call on native cornell at 800x800 (temporal SVGF
with its 5-level filter, compat=False): "spatial-only" the fourth frame
with temporal accumulation off (every pixel runs the 49 taps),
"temporal" the fourth temporal frame (the pixels whose history is under
4 frames run them). Each build of R is timed on the frame's call, and
on the temporal frame also where no pixel needs the taps (the history
raised to 4 frames): 12 B a pixel. It counts the pixels off R's plain version and
off the first build, the pixels that run the taps, and the blocks with
none (ops/cuda/spatial_variance.py:sv_block_need) for the shipped
tile and each of R_TILES, and the (pixel, tap) pairs whose normal or
position distance is 0 (r_zero_pairs).

The glue case renders four frames of room at 1920x1080 with bench.py's
animated camera and the 5-level temporal SVGF, and captures the calls
of the fifth (its camera moved): the camera rays (S1), the primary
hit's finish after A (S2, and its position alone, a restored state's)
and the motion bounds (T). Each kernel is timed in turns beside its
plain version, the plain version also with its host (the launches it
queues), with its lanes off the plain version by output and its bound
(its inputs and outputs once).

Cases (CASES): F and Q on diamond at 800x800 and room at 1920x1080, F
also on bunny at 800x800, Q also on bunny and terrain30k at 800x800;
H on cornell and bunny at 800x800 and room at 600x600; J on cornell at
800x800 and room at 600x600; A on bunny at 800x800, and on the primary
hits of room at 1920x1080 and of cornell at 800x800; I on cornell and
bunny at 800x800 and room at 600x600; L on cornell at 800x800; M on the
trace bench's 640,000 rays, cull on and off, and on bunny's 800x800
camera rays; B1's table build on cornell and on cornell plus 55 cubes
(utils/assets.py:write_cornell_plus, 65 geoms) at 800x800; R on native
cornell at 800x800, spatial-only and temporal; the glue on room at
1920x1080.

--variant NAME=DIR (repeatable) builds DIR's copy of each timed kernel's
source (SOURCE: DIR/bounce.cu for F and H, DIR/scene_intersect.cu for A,
J, I and M, DIR/reproject_atrous.cu for L, DIR/ranges.cu for Q,
DIR/spatial_variance.cu for R, DIR/path_trace_table.cu for B1's table
build), a copy of csrc/ with
that source or its headers changed (an older tree's csrc, or a source
with one part of the work taken out), into a library of its own with the same C interface, and
runs every case's kernel from it too, on the same captured inputs, as
the wrappers run the kernel library's build, so that two designs are
compared in one process on one card. A variant of B1's table build reads
the tables of this tree (ops/cuda/scene_intersect.py:table_rows).

Prints one line per case and build with the card's name and power
limit, then each build's registers and spills as ptxas reported them
(the kernel library is built anew), and writes every number as JSON to
FILE where given. Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import pathlib

import numpy as np
import torch

from ptdn_tpu_torch import trace_bench
from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.denoise import svgf
from ptdn_tpu_torch.denoise.variance import HIST_THRESHOLD
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.camera import (generate_camera_rays,
                                       generate_camera_rays_plain)
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import camera as S
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import bounce as F
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.ops.cuda import ranges as Q
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import reproject_atrous as L
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.ops.cuda import spatial_variance as R
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path, write_cornell_plus
from ptdn_tpu_torch.utils.card import (ANALYTIC_OPS, BOX_OPS, MOLLER_OPS,
                                       RANGE_OPS, REFINE_OPS, SHADE_OPS,
                                       SPATIAL_TAP_OPS, bound, card_name,
                                       cuda_ms, in_turns, nbytes,
                                       ptxas_summary, sass, sass_loops)
from ptdn_tpu_torch.utils.config import RenderConfig

CFG = RenderConfig(trace_depth=8)
# the flags of each kernel's engine: the sort (the mesh scenes' default)
# for F and Q, the unsorted fused per-bounce engine for H, the split one for A,
# J and I; for L the headline frame's temporal SVGF with its 5-level
# filter and fuse_reproject_l1; for R the same filter in native mode
# (temporal accumulation on or off by case)
SPLIT = dict(fuse_path=False, fuse_bounce=False)
SVGF5 = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
             atrous_nlevel=5)
FUSE_L1 = dict(SVGF5, fuse_reproject_l1=True)
ENGINE = {"trace_bounce": {}, "ranges_and_key": {},
          "bounce_fused": dict(fuse_path=False, sort_rays=False),
          "scene_intersect_full": SPLIT, "scene_intersect_full_tex": SPLIT,
          "light_visibility": SPLIT, "back_projection_atrous1": FUSE_L1,
          "path_trace_table": {}, "scene_intersect": {},
          "spatial_variance": dict(SVGF5, compat=False)}
# each kernel's source in csrc/, which a variant rebuilds, and its C
# entry point
SOURCE = {"trace_bounce": ("bounce.cu", "ptdn_trace_bounce"),
          "bounce_fused": ("bounce.cu", "ptdn_bounce_fused"),
          "scene_intersect_full": ("scene_intersect.cu",
                                   "ptdn_scene_intersect_full"),
          "scene_intersect_full_tex": ("scene_intersect.cu",
                                       "ptdn_scene_intersect_full_tex"),
          "light_visibility": ("scene_intersect.cu", "ptdn_light_visibility"),
          "back_projection_atrous1": ("reproject_atrous.cu",
                                      "ptdn_back_projection_atrous1"),
          "scene_intersect": ("scene_intersect.cu", "ptdn_scene_intersect"),
          "ranges_and_key": ("ranges.cu", "ptdn_ranges_and_key"),
          "spatial_variance": ("spatial_variance.cu",
                               "ptdn_spatial_variance"),
          "path_trace_table": ("path_trace_table.cu",
                               "ptdn_path_trace_table")}
# the kernels with a per-scene build (csrc/scene/*.cu; B1's table build
# beside the per-scene B1, csrc/scene/path_trace.cu); the closest-hit
# kernels, which take rays (o, d) and return A's dict; the kernels that
# take rays
PER_SCENE = tuple(k for k, (_, entry) in SOURCE.items()
                  if any(entry in e for e in _lib.SCENE_ENTRIES.values())
                  ) + ("path_trace_table",)
HIT_KERNELS = ("scene_intersect_full", "scene_intersect_full_tex")
RAY_KERNELS = HIT_KERNELS + ("light_visibility", "scene_intersect")
# label -> (kernel, scene, resolution, call): the bounce-2 call of a
# still frame, or "primary", the primary hit of a frame whose camera
# moved (A, every engine), or L's or B1's call (its only one in a
# frame); M's: "cull" or "no cull" on the trace bench's rays (scene
# "trace bench"), "camera" on a scene's camera rays; R's: "spatial-only"
# or "temporal", its call on a frame with temporal accumulation off or on
CASES = {"F diamond": ("trace_bounce", "diamond", (800, 800), 2),
         "F bunny": ("trace_bounce", "bunny", (800, 800), 2),
         "F room 1920x1080": ("trace_bounce", "room", (1920, 1080), 2),
         "Q diamond": ("ranges_and_key", "diamond", (800, 800), 2),
         "Q bunny": ("ranges_and_key", "bunny", (800, 800), 2),
         "Q terrain30k": ("ranges_and_key", "terrain30k", (800, 800), 2),
         "Q room 1920x1080": ("ranges_and_key", "room", (1920, 1080), 2),
         "H cornell": ("bounce_fused", "cornell", (800, 800), 2),
         "H bunny": ("bounce_fused", "bunny", (800, 800), 2),
         "H room": ("bounce_fused", "room", (600, 600), 2),
         "J cornell": ("scene_intersect_full_tex", "cornell", (800, 800), 2),
         "J room": ("scene_intersect_full_tex", "room", (600, 600), 2),
         "A bunny": ("scene_intersect_full", "bunny", (800, 800), 2),
         "A room 1920x1080 primary": ("scene_intersect_full", "room",
                                      (1920, 1080), "primary"),
         "A cornell primary": ("scene_intersect_full", "cornell", (800, 800),
                               "primary"),
         "I cornell": ("light_visibility", "cornell", (800, 800), 2),
         "I bunny": ("light_visibility", "bunny", (800, 800), 2),
         "I room": ("light_visibility", "room", (600, 600), 2),
         "L cornell": ("back_projection_atrous1", "cornell", (800, 800), 1),
         "M trace bench": ("scene_intersect", "trace bench", (800, 800),
                           "cull"),
         "M trace bench no cull": ("scene_intersect", "trace bench",
                                   (800, 800), "no cull"),
         "M bunny camera": ("scene_intersect", "bunny", (800, 800),
                            "camera"),
         "B1 table cornell": ("path_trace_table", "cornell", (800, 800), 1),
         "B1 table cornell65": ("path_trace_table", "cornell65", (800, 800),
                                1),
         "R cornell spatial-only": ("spatial_variance", "cornell",
                                    (800, 800), "spatial-only"),
         "R cornell temporal": ("spatial_variance", "cornell", (800, 800),
                                "temporal"),
         "glue room 1920x1080": ("glue", "room", (1920, 1080), "moved")}
B_PLANES = ("spx", "spy", "spz", "dx", "dy", "dz", "t", "nx", "ny", "nz",
            "tr", "tg", "tb", "rr", "rg", "rb", "mat", "act", "dif", "uu",
            "vv")
ALB_PLANES = ("alb_r", "alb_g", "alb_b")
# the module whose attribute each kernel's caller calls, where it is not
# engine/wavefront.py, and that attribute's name, where it is not the
# kernel's
CALLER = {"back_projection_atrous1": svgf, "spatial_variance": svgf}
CALLED = {"path_trace_table": "path_trace",
          "spatial_variance": "spatial_variance_fallback"}
NEXT_PLANES = B_PLANES[:10] + ALB_PLANES + B_PLANES[10:19] + ("pix",)
# the generated scene past B1's per-scene build: cornell plus this many
# cubes (65 geoms)
CUBES = 55


class PlanesTraceArgs(ctypes.Structure):
    """csrc/bounce.cuh:TraceArgs before kernel F read through the sort's
    order: the 25 planes gathered into sorted order in, the 21 B_* planes
    and the (3, N) next albedo out."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("inp", "out", "alb")]
                + [(k, ctypes.c_int) for k in ("n", "light_geom", "do_vis",
                                               "do_next", "show_tex")]
                + [(k, ctypes.c_float) for k in ("emit_r", "emit_g",
                                                 "emit_b")])


def reads_through_order(src_dir) -> bool:
    """Whether src_dir's kernel F reads through the sort's order (this
    tree's contract) or takes planes gathered beforehand (an older
    tree's)."""
    text = (pathlib.Path(src_dir) / "bounce.cuh").read_text()
    return "order" in text[text.index("struct TraceArgs"):
                           text.index("struct BounceArgs")]


def _fresh(fn):
    """F's wrapper `fn` on a captured call, into a new output (the
    frame's call wrote into its carry)."""
    def call(*args, out=None, **kw):
        return fn(*args, **kw)
    return call


def f_parts(args, kw, libs=None):
    """The parts of an F case (args, kw its captured call): "gather", the
    index_select of the bounce's planes by the order that F's ordered
    reads replaced; "F on gathered planes", this tree's kernel library
    F on them through the identity order; and for each library of
    `libs` (an older tree's F) "F [name] on gathered planes", that F as
    it ran, and "gather + F [name] + cat", with the next planes' cat or
    the radiance's scatter it took. Returns name -> (fn, whether its
    output is F's, in this tree's layout)."""
    ds, gi, allp, order = args
    kw = {k: v for k, v in kw.items() if k != "out"}
    lib_gi = gi._replace(path_scene=None)
    n, shape, dev = allp[0].numel(), tuple(allp.shape[1:]), allp.device

    def gather():
        return allp.reshape(F.N_TIN, n).index_select(1, order).reshape(
            allp.shape)
    gathered = gather()
    ident = torch.arange(n, device=dev)

    def theirs(lib, planes):
        out = torch.empty((F.N_BOUT,) + shape, device=dev)
        alb = (torch.empty((3,) + shape, device=dev) if kw["do_next"]
               else None)
        p, emit = _lib.ptr, kw["emit"]
        targs = PlanesTraceArgs(
            inp=p(planes), out=p(out), alb=p(alb), n=n,
            light_geom=kw["light_geom"], do_vis=int(kw["do_vis"]),
            do_next=int(kw["do_next"]), show_tex=int(kw["show_tex"]),
            emit_r=emit[0], emit_g=emit[1], emit_b=emit[2])
        _lib.launch(A.entry(lib_gi, "ptdn_trace_bounce"),
                    A.scene_dev(ds, lib_gi, dev), targs, lib=lib)
        return out, alb

    def bounce(lib):
        planes = gather()
        out, alb = theirs(lib, planes)
        if kw["do_next"]:
            return torch.cat([out[0:10], alb, out[10:19], planes[-1:]])
        rad = torch.empty((n, 3), device=dev)
        rad[planes[-1].reshape(-1).to(torch.int64)] = (
            out[F.B_RR:F.B_RB + 1].reshape(3, n).T)
        return rad
    parts = {"gather": (gather, False),
             "F on gathered planes": (lambda: F._trace_bounce_kernel(
                 ds, lib_gi, gathered, ident, **kw), True)}
    for name, lib in (libs or {}).items():
        parts[f"F [{name}] on gathered planes"] = (
            functools.partial(theirs, lib, gathered), False)
        parts[f"gather + F [{name}] + cat"] = (
            functools.partial(bounce, lib), True)
    return parts


def capture_bounce(r, depth: int, names, module=W):
    """Render one frame of renderer r and return, for each function of
    `names` (attributes of `module`, engine/wavefront.py by default) that
    the frame calls, the arguments of its call on bounce `depth` (its
    depth-th call) as (args, kw) (each wrapper still runs, so the frame
    is unchanged)."""
    got, seen = {}, dict.fromkeys(names, 0)
    real = {k: getattr(module, k) for k in names}

    def spy(key, fn):
        def call(*args, **kw):
            seen[key] += 1
            if seen[key] == depth:
                got[key] = ([a.clone() if torch.is_tensor(a) else a
                             for a in args], kw)
            return fn(*args, **kw)
        return call
    for k in names:
        setattr(module, k, spy(k, real[k]))
    try:
        r.render_frame()
    finally:
        for k in names:
            setattr(module, k, real[k])
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    return got


def scene_file(scene: str) -> str:
    """The scene file of `scene`: a scene of scenes/, or "cornell65",
    cornell plus CUBES cubes, written into the build directory."""
    if scene == "cornell65":
        return write_cornell_plus(_lib.BUILD / "scenes", cubes=CUBES)
    return scene_path(scene)


def capture(kernel: str, scene: str, res, call=2, device="cuda"):
    """(args, kw) of `kernel`'s call on the fourth frame of `scene` at
    `res` through the kernel's engine: its bounce-2 call (call 2, the
    camera still), or with call "primary" its first call after the
    camera moved, or with "camera" kernel M on the fourth frame's camera
    rays; or with scene "trace bench" M on the trace bench's rays, call
    "cull" or "no cull"; R's call, "spatial-only" or "temporal", on the
    fourth frame with temporal accumulation off or on."""
    if scene == "trace bench":
        return list(trace_bench.setup(device)), {"cull": call == "cull"}
    flags = ENGINE[kernel]
    if kernel == "spatial_variance":
        flags = dict(flags, temporal_enable=call == "temporal")
        call = 1
    r = Renderer(Scene(scene_file(scene)), dataclasses.replace(CFG, **flags),
                 res, device)
    for _ in range(3):
        r.render_frame()
    if call == "camera":
        o, d = generate_camera_rays(r._cam[0], r.resolution)
        tr = r.step.tracer
        return [tr.ds, tr.gi, o, d], {"cull": True}
    if call == "primary":
        r.orbit(dphi=0.015, dtheta=0.01)
        call = 1
    name = CALLED.get(kernel, kernel)
    if kernel == "ranges_and_key":    # with E's call of the same bounce
        got = capture_bounce(r, call, (name, "shade_bounce"))
        args, kw = got[name]
        return args, dict(kw, shade=got["shade_bounce"])
    return capture_bounce(r, call, (name,), CALLER.get(kernel, W))[name]


def _ranges_and_key_kernel(ds, *args, boxes):
    """Kernel Q on ranges_and_key's captured call: in place on its allp
    (a clone; E's planes in its first 21)."""
    return Q._ranges_and_key_kernel(boxes, *args)


def _ranges_and_key_plain(*args, boxes):
    return Q.ranges_and_key_plain(*args)


def shade_and_ranges(shade, args, kw, libs=None):
    """E + Q as a sorted bounce runs them, on E's captured call `shade`
    and Q's (args, kw): "library", this tree's, E writing into the first
    21 planes of a new allp, then Q filling it in place; and for each
    variant of `libs` (an older tree's Q), E into a buffer of its own,
    then that Q reading it into a new allp, as the bounce did before E
    wrote into allp. Returns name -> a function giving (allp, key)."""
    (planes, mats), e_kw = shade
    e_kw = {k: v for k, v in e_kw.items() if k != "out"}
    _, allp, pix, *rest = args

    def mine():
        a = torch.empty_like(allp)
        E._shade_bounce_kernel(planes, mats, **e_kw, out=a[:Q.N_OUT])
        return Q._ranges_and_key_kernel(kw["boxes"], a, pix, *rest)

    def theirs(lib):
        sh = E._shade_bounce_kernel(planes, mats, **e_kw)
        a = torch.empty_like(allp)
        key = torch.empty(pix.numel(), dtype=torch.int32, device=a.device)
        _lib.launch("ptdn_ranges_and_key", Q.range_args(
            kw["boxes"], sh, pix, a, key, *rest), lib=lib)
        return a, key
    return {"library": mine,
            **{name: functools.partial(theirs, lib)
               for name, lib in (libs or {}).items()}}


def kernel_fn(kernel: str):
    return {"trace_bounce": _fresh(F._trace_bounce_kernel),
            "ranges_and_key": _ranges_and_key_kernel,
            "bounce_fused": F._bounce_fused_kernel,
            "scene_intersect_full": A._scene_intersect_full_kernel,
            "scene_intersect_full_tex":
                A._scene_intersect_full_tex_kernel,
            "light_visibility": A._light_visibility_kernel,
            "back_projection_atrous1":
                L._back_projection_atrous1_kernel,
            "scene_intersect": A._scene_intersect_kernel,
            "path_trace_table": B._path_trace_kernel}[kernel]


def plain_fn(kernel: str):
    return {"trace_bounce": _fresh(F.trace_bounce_plain),
            "ranges_and_key": _ranges_and_key_plain,
            "bounce_fused": F.bounce_fused_plain,
            "scene_intersect_full": A.scene_intersect_full_plain,
            "scene_intersect_full_tex":
                A.scene_intersect_full_tex_plain,
            "light_visibility": A.light_visibility_plain,
            "back_projection_atrous1":
                L.back_projection_atrous1_plain,
            "scene_intersect": A.scene_intersect_plain,
            "path_trace_table": B.path_trace_plain}[kernel]


def hit_planes(isect, tidx=None):
    """A's outputs by name (each a column of its dict), and J's texel
    index."""
    out = {"t": isect["t"], "mat": isect["mat_id"], "geom": isect["geom_id"]}
    out.update({"n" + k: isect["normal"][:, c] for c, k in enumerate("xyz")})
    out.update({k: isect["uv"][:, c] for c, k in enumerate("uv")})
    if tidx is not None:
        out["texel"] = tidx
    return out


def out_planes(kernel: str, out):
    """The output planes by name: F's next planes (or its radiance by
    pixel, on the last depth), H's B_* planes, A's outputs, J's and its
    texel index, I's lit flag, L's color, variance, moments and history,
    M's outputs, B1's contribution and texel-index planes, Q's 26 planes
    and its key."""
    if kernel == "ranges_and_key":
        allp, key = out
        return {**{f"plane{k}": p for k, p in enumerate(allp)}, "key": key}
    if kernel == "path_trace_table":
        contrib, texidx = out
        return {**{f"c{k}": c for k, c in enumerate(contrib)},
                **{f"texel{k}": t for k, t in enumerate(texidx)}}
    if kernel == "scene_intersect":
        planes = {k: out[k] for k in ("t_a", "geom_a", "t_m", "tri_m")}
        planes.update({"n" + k + "_a": out["normal_a"][:, c]
                       for c, k in enumerate("xyz")})
        return planes
    if kernel == "light_visibility":
        return {"lit": out.to(torch.int32)}
    if kernel == "back_projection_atrous1":
        color, var, mom, hist = out
        return {"r": color[..., 0], "g": color[..., 1], "b": color[..., 2],
                "var": var, "m1": mom[..., 0], "m2": mom[..., 1],
                "hist": hist}
    if kernel == "scene_intersect_full":
        return hit_planes(out)
    if kernel == "scene_intersect_full_tex":
        return hit_planes(*out)
    if kernel == "bounce_fused":
        return dict(zip(B_PLANES, out))
    if out.shape[0] == F.N_NEXT:
        return dict(zip(NEXT_PLANES, out))
    return dict(zip(("r", "g", "b"), out.T))


def plane_diffs(got, ref):
    """Per plane the lanes whose bits differ (NaN against NaN equal)."""
    out = {}
    for name, a in got.items():
        b = ref[name]
        differ = (a.view(torch.int32) != b.view(torch.int32)) & ~(
            torch.isnan(a) & torch.isnan(b))
        out[name] = int(differ.sum())
    return out


def n_lanes(kernel: str, args) -> int:
    """The lanes (rays, or B1's pixels) of a call's arguments."""
    if kernel == "path_trace_table":
        return args[2]["t"].shape[0]
    if kernel == "ranges_and_key":
        return args[1][0].numel()
    return args[2].shape[0] if kernel in RAY_KERNELS else args[2][0].numel()


def b1_work(args, kw, contrib, texidx, tri_tests: int, culls=(0, 0)):
    """Kernel B1's bound on its arguments (ds, gi, prim) and keywords
    (depth among them): its inputs and outputs once, and per pixel and
    depth the shading, the analytic geoms' tests of the bounce and
    shadow rays and the winner's refine, plus the lane-triangle tests the
    plain version counted; with `culls` (box tests, skipped tests) of
    b1_plain_counted, the table build's work: each skipped analytic test
    taken out, each box test added."""
    gi, prim = args[1], args[2]
    n_an = sum(1 for t in gi.types if t != 2)
    b_in = [prim[k] for k in ("o", "d", "t", "normal", "albedo", "mat_id",
                              "hit")]
    n = prim["t"].shape[0]
    box_tests, skipped = culls
    return bound(nbytes(*b_in, contrib, texidx),
                 n * kw["depth"] * (SHADE_OPS + 2 * n_an * ANALYTIC_OPS
                                    + REFINE_OPS) + tri_tests * MOLLER_OPS
                 - skipped * ANALYTIC_OPS + box_tests * BOX_OPS)


def b1_plain_counted(args, kw):
    """B1's plain version on (args, kw) and what it tested: (its output,
    the lane-triangle tests of its scans, (the box tests of the geoms
    B1's table build may skip, the analytic tests skipped where the ray
    misses the box)), the last counted per lane over every ray the plain
    version tests (the table build skips per lane; a warp runs a test
    while any of its lanes wants it)."""
    gi = args[1]
    culled = [int(g) for g in
              (gi.row_code[:, 0] & A.HEAD_CULL).nonzero().flatten()]
    real, box_tests, skipped = A.analytic_best, [0], [0]

    def counted(ds, types, o, d, static=False):
        for g in culled:
            box_tests[0] += o[0].numel()
            skipped[0] += int(A.table_box_missed(gi.row_coef[g, :2], o,
                                                 d).sum())
        return real(ds, types, o, d, static)
    A.mesh_best.tri_tests = A.light_visible.tri_tests = 0
    A.analytic_best = counted
    try:
        out = B.path_trace_plain(*args, **kw)
    finally:
        A.analytic_best = real
    return (out, A.mesh_best.tri_tests + A.light_visible.tri_tests,
            (box_tests[0], skipped[0]))


def work(kernel: str, args, kw, out, tri_tests: int, culls=(0, 0)):
    """The kernel's bound on these inputs (utils/card.py:bound); B1's
    table build's with `culls` (b1_plain_counted)."""
    if kernel == "path_trace_table":
        return b1_work(args, kw, *out, tri_tests, culls)
    if kernel == "ranges_and_key":
        return bound(Q.traffic(args[1]),
                     Q.box_tests(args[1], kw["boxes"].shape[0]) * RANGE_OPS)
    gi = args[1]
    n_an = sum(1 for t in gi.types if t != 2)
    if kernel == "scene_intersect":
        per_lane = n_an * ANALYTIC_OPS
        ins, outs = args[2:4], out.values()
    elif kernel == "light_visibility":
        per_lane = n_an * ANALYTIC_OPS
        ins, outs = args[2:4], (out,)
    elif kernel in HIT_KERNELS:
        per_lane = n_an * ANALYTIC_OPS + REFINE_OPS
        ins = args[2:4]
        outs = list(out_planes(kernel, out).values())
    else:
        per_lane = 2 * n_an * ANALYTIC_OPS + REFINE_OPS
        if kernel == "bounce_fused":
            per_lane += SHADE_OPS
        # F: the planes it reads through the order, and the order
        ins = args[2:4] if kernel == "trace_bounce" else args[2:3]
        outs = (out,)
    return bound(nbytes(*ins, *outs), n_lanes(kernel, args) * per_lane
                 + tri_tests * MOLLER_OPS)


def build_variant(name: str, src_dir, kernels=tuple(SOURCE)) -> tuple:
    """Compile src_dir's copy of the source of each of `kernels` (SOURCE)
    with the kernel library's flags into build/variant-<name>.so; returns
    (the library with their entry points declared, ptxas's report of
    it)."""
    sources = dict.fromkeys(SOURCE[k][0] for k in kernels)
    entries = [SOURCE[k][1] for k in kernels]
    return _lib.build_variant(
        name, [pathlib.Path(src_dir) / src for src in sources],
        {e: _lib.ENTRIES[e] for e in entries})


def measure(kernel: str, args, kw, libs=None, reps: int = 20,
            old_f=()):
    """The numbers of one case: lanes, the plain scan's lane-triangle
    tests, the plain version's ms, the bound, and per build the per-plane
    differing lanes (against the plain version, and against the first
    build) and the kernel's ms, all timed in turns there and back: the
    scene's own build ("scene", where the kernel and the scene have one),
    the kernel library's ("library"), and each library of `libs` (name ->
    library, built by build_variant), which the wrappers take as they
    take the kernel library's; F's parts (f_parts), the variants named in
    `old_f` (an older tree's F) among them and not among the builds."""
    ds, gi, *rest = args
    shade = kw.pop("shade", None)     # Q's case: E's call of its bounce
    # Q takes no geom info and has the library's build alone
    lib_args = (args if kernel == "ranges_and_key"
                else (ds, gi._replace(path_scene=None), *rest))
    builds = {"library": (None, lib_args)}
    if kernel in PER_SCENE and gi.path_scene is not None:
        builds = {"scene": (None, args), **builds}
    builds.update({name: (lib, lib_args)
                   for name, lib in (libs or {}).items()
                   if kernel != "trace_bounce" or name not in old_f})
    kfn, pfn = kernel_fn(kernel), plain_fn(kernel)
    culls = (0, 0)
    if kernel == "path_trace_table":
        ref, tests, culls = b1_plain_counted(args, kw)
    else:
        A.mesh_best.tri_tests = A.light_visible.tri_tests = 0
        ref = pfn(*args, **kw)
        tests = A.mesh_best.tri_tests + A.light_visible.tri_tests
    ref_planes = out_planes(kernel, ref)
    per, first = {}, None
    for name, (lib, a) in builds.items():
        got = out_planes(kernel, _lib.with_lib(lib, lambda: kfn(*a, **kw)))
        first = first or got
        per[name] = {"diffs": plane_diffs(got, ref_planes),
                     "diffs_first": plane_diffs(got, first)}
    order = list(builds) + list(builds)[::-1]
    ms = in_turns({name: (lambda lib=lib, a=a: _lib.with_lib(
        lib, lambda: kfn(*a, **kw))) for name, (lib, a) in builds.items()},
        reps)
    for name in per:
        per[name]["ms"] = ms[name]
    plain_ms = cuda_ms(lambda: pfn(*args, **kw), reps=1, warmup=0,
                       hide_host=True)
    bound_ms, bound_by = work(kernel, args, kw, ref, tests, culls)
    out = {"lanes": n_lanes(kernel, args), "tri_tests": tests,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "turns": order, "builds": per}
    if shade is not None:     # E + Q, each build's way, equal and timed
        pairs = shade_and_ranges(shade, args, kw, libs)
        got = {name: out_planes(kernel, fn()) for name, fn in pairs.items()}
        out["parts_off"] = {f"E + Q {name}": sum(plane_diffs(
            g, got["library"]).values()) for name, g in got.items()}
        ms = in_turns({f"E + Q {k}": v for k, v in pairs.items()}, reps)
        out["parts"] = ms
        _, out["live"], out["nee"] = Q.lane_counts(args[1])
    if kernel == "trace_bounce":   # the gather F replaced, older Fs
        parts = f_parts(args, kw, {k: v for k, v in (libs or {}).items()
                                   if k in old_f})
        ref_lib = out_planes(kernel, kfn(*lib_args, **kw))
        out["parts_off"] = {
            name: sum(plane_diffs(out_planes(kernel, fn()), ref_lib).values())
            for name, (fn, same_output) in parts.items() if same_output}
        out["parts"] = in_turns({name: fn for name, (fn, _) in
                                 parts.items()}, reps)
    if kernel == "path_trace_table":   # the work without the cull
        out["bound_full_ms"] = work(kernel, args, kw, ref, tests)[0]
        out["box_tests"], out["skipped_tests"] = culls
    return out


def l_work(args, out):
    """Kernel L's bound on its arguments `args` and outputs `out`: the
    current frame's color and G-buffer (position, normal, geom), the
    previous frame's normal and geom and the three histories in, its four
    outputs out, and per pixel C's ~200 operations and D's 25 taps of
    ~40."""
    res, raw, gb, prev, _, ch, mh, hl = args[:8]
    return bound(nbytes(raw, gb["position"], gb["normal"], gb["geom_id"],
                        prev["normal"], prev["geom_id"], ch, mh, hl, *out),
                 res[0] * res[1] * (200 + 25 * 40))


def measure_l(args, kw, libs=None, reps: int = 20):
    """The numbers of L's case, as measure()'s: per build of L (the
    kernel library's and each of `libs`) the pixels off its plain version,
    off the first build and off C's then D's kernels by output, and its
    ms; and in "parts", kernel C (stencil mode) alone and kernel D at
    level 1 alone on C's output and the packed G-buffer, as the frame
    without fuse_reproject_l1 runs them; all timed in turns there and
    back."""
    kernel = "back_projection_atrous1"
    cargs, (sl, sn, sx, blur, static) = args[:10], args[10:]
    ref = L.back_projection_atrous1_plain(*args, **kw)
    var, acc, mom, hist = C._back_projection_stencil_kernel(*cargs)
    d_args = (acc, var, static, None, 1, sl, sn, sx, blur)
    c_then_d = out_planes(kernel, D._atrous_level_kernel(*d_args)
                          + (mom, hist))
    ref_planes = out_planes(kernel, ref)

    def fused():
        return L._back_projection_atrous1_kernel(*args, **kw)
    runs = {name: (lib, fused)
            for name, lib in {"library": None, **(libs or {})}.items()}
    per, first = {}, None
    for name, (lib, fn) in runs.items():
        got = out_planes(kernel, _lib.with_lib(lib, fn))
        first = first or got
        per[name] = {"diffs": plane_diffs(got, ref_planes),
                     "diffs_first": plane_diffs(got, first),
                     "diffs_c_then_d": plane_diffs(got, c_then_d)}
    parts = {"C": (None, lambda: C._back_projection_stencil_kernel(*cargs)),
             "D level 1": (None, lambda: D._atrous_level_kernel(*d_args))}
    runs.update(parts)
    order = list(runs) + list(runs)[::-1]
    times = in_turns({name: (lambda lib=lib, fn=fn: _lib.with_lib(lib, fn))
                      for name, (lib, fn) in runs.items()}, reps)
    for name in per:
        per[name]["ms"] = times[name]
    plain_ms = cuda_ms(lambda: L.back_projection_atrous1_plain(*args, **kw),
                       reps=1, warmup=0, hide_host=True)
    bound_ms, bound_by = l_work(args, ref)
    return {"lanes": args[0][0] * args[0][1], "tri_tests": 0,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "turns": order, "builds": per,
            "parts": {k: times[k] for k in parts}}


def r_read(need):
    """The (H, W) pixels whose color, position and normal the taps of
    the pixels `need` (H, W) bool read: those within RADIUS of one."""
    k = 2 * R.RADIUS + 1
    return torch.nn.functional.max_pool2d(
        need[None, None].float(), k, 1, R.RADIUS)[0, 0] > 0


def r_work(args, out, need):
    """Kernel R's bound on its arguments `args` (color, G-buffer, sigmas
    and, with a history, the history and the temporal variance) and
    output `out`, the pixels `need` (H, W) bool running the 49 taps: the
    output, the history and the temporal variance once a pixel (12 B),
    color, position and normal (as (H, W, 3) planes, 36 B) once a pixel
    that a tap reads (r_read), SPATIAL_TAP_OPS a tap."""
    color, gb = args[:2]
    planes = nbytes(color, gb["position"], gb["normal"]) // need.numel()
    return bound(nbytes(*args[4:6], out) + planes * int(r_read(need).sum()),
                 int(need.sum()) * 49 * SPATIAL_TAP_OPS)


def r_need(args):
    """The (H, W) pixels of R's call that run the taps."""
    if len(args) <= 4:
        return torch.ones(args[0].shape[:2], dtype=torch.bool,
                          device=args[0].device)
    return args[4] < HIST_THRESHOLD


def r_none_needed(args):
    """R's call with a history with the history raised to HIST_THRESHOLD
    frames: no pixel runs the taps, each keeps its temporal variance."""
    return [*args[:4], args[4].clamp_min(HIST_THRESHOLD), *args[5:]]


def r_blocks(need: np.ndarray, tile=(R.TILE_W, R.TILE_H)) -> dict:
    """The blocks of kernel R's grid, with tiles of `tile` (width,
    height), on the pixels `need` (H, W) that run the taps: how many, how
    many have none, and the warps that run them."""
    n = R.sv_block_need(need, tile)
    return {"blocks": int(n.size), "idle_blocks": int((n == 0).sum()),
            "tap_warps": int(np.ceil(n / 32).sum())}


def r_zero_pairs(gb) -> dict:
    """The in-image (pixel, tap) pairs of R's 7x7 window over the
    G-buffer `gb`, and those whose squared normal distance, position
    distance or both are 0 (then the kernel takes no factor's division
    and exp)."""
    h, w = gb["normal"].shape[:2]
    out = dict.fromkeys(("pairs", "normal_zero", "position_zero",
                         "both_zero"), 0)
    rad = R.RADIUS
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            p = (slice(max(0, -dy), h - max(0, dy)),
                 slice(max(0, -dx), w - max(0, dx)))
            q = (slice(max(0, dy), h - max(0, -dy)),
                 slice(max(0, dx), w - max(0, -dx)))

            def zero(t):   # 0 iff every square is: fused or not
                d = t[p] - t[q]
                return (d * d).sum(-1) == 0
            n0, p0 = zero(gb["normal"]), zero(gb["position"])
            out["pairs"] += n0.numel()
            out["normal_zero"] += int(n0.sum())
            out["position_zero"] += int(p0.sum())
            out["both_zero"] += int((n0 & p0).sum())
    return out


# tile shapes (width, height) whose blocks measure_r counts: the
# candidates, and (32, 1), the warps of one thread a pixel at a width
# that is a multiple of 32
R_TILES = ((32, 8), (32, 16), (16, 16), (32, 1))


def measure_r(args, kw, libs=None, reps: int = 20):
    """The numbers of an R case, as measure()'s: per build of R (the
    kernel library's and each of `libs`) the pixels off its plain version
    and off the first build and its ms on the frame's call; in "parts",
    on a call with a history, every build where no pixel needs the taps
    (the history raised to 4 frames; then each equals the temporal
    variance); all timed in turns there and back. With the pixels that
    run the taps, r_blocks' counts for the shipped tile and in "tiles"
    for each of R_TILES, and r_zero_pairs' counts."""
    ref = R.spatial_variance_plain(*args, **kw)
    need = r_need(args)
    taps = int(need.sum())
    passing = r_none_needed(args) if len(args) > 4 else None
    runs = {name: (lib, args, kw)
            for name, lib in {"library": None, **(libs or {})}.items()}
    per, first = {}, None
    for name, (lib, a, k) in runs.items():
        got = _lib.with_lib(lib, lambda: R._spatial_variance_kernel(*a, **k))
        first = first if first is not None else got
        per[name] = {"diffs": plane_diffs({"var": got}, {"var": ref}),
                     "diffs_first": plane_diffs({"var": got},
                                                {"var": first})}
    parts = {}
    if passing is not None:
        parts = {f"{name} none needed": (lib, passing, kw)
                 for name, (lib, _, _) in runs.items()}
    checks = {}
    for name, (lib, a, k) in parts.items():
        got = _lib.with_lib(lib, lambda: R._spatial_variance_kernel(*a, **k))
        checks[name] = plane_diffs({"var": got}, {"var": passing[5]})["var"]
    runs.update(parts)
    order = list(runs) + list(runs)[::-1]
    times = in_turns({name: (lambda lib=lib, a=a, k=k: _lib.with_lib(
        lib, lambda: R._spatial_variance_kernel(*a, **k)))
        for name, (lib, a, k) in runs.items()}, reps)
    for name in per:
        per[name]["ms"] = times[name]
    plain_ms = cuda_ms(lambda: R.spatial_variance_plain(*args, **kw),
                       reps=1, warmup=0, hide_host=True)
    bound_ms, bound_by = r_work(args, ref, need)
    need_np = need.cpu().numpy()
    out = {"lanes": need.numel(), "tri_tests": 0, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "turns": order,
           "builds": per, "parts": {k: times[k] for k in parts},
           "parts_off": checks, "taps": taps,
           "read": int(r_read(need).sum()), **r_blocks(need_np),
           "tiles": {f"{tw}x{th}": r_blocks(need_np, (tw, th))
                     for tw, th in R_TILES},
           "zero_pairs": r_zero_pairs(args[1])}
    if passing is not None:
        out["none_needed_bound_ms"] = r_work(passing, ref,
                                             r_need(passing))[0]
    return out


# kernel R's history patterns at odd sizes (r_pattern_args)
R_SIZES = ((37, 23), (129, 65))
R_PATTERNS = ("no history", "all short", "none short", "clustered 17%",
              "random 17%", "one pixel")


def r_pattern_args(h: int, w: int, pattern: str, device="cuda"):
    """Seeded arguments of kernel R at h x w (numpy's generator): color,
    a G-buffer with a flat quarter (equal normals and positions: zero
    distances), a geometric edge and random normals elsewhere, the sigmas
    and, but for "no history", a history of `pattern` (R_PATTERNS) and a
    temporal variance."""
    rng = np.random.default_rng(h * 1000 + w)
    color = rng.random((h, w, 3), np.float32)
    pos = rng.random((h, w, 3), np.float32) * np.float32(0.5)
    pos[:, w // 2:, 2] += np.float32(100)
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, :w // 2] = np.float32([0, 0, 1])
    pos[:h // 3, :w // 3] = np.float32(1)
    hist = np.full((h, w), 9, np.int32)
    if pattern == "all short":
        hist[:] = rng.integers(0, 4, (h, w))
    elif pattern == "clustered 17%":
        hist[:max(1, h * 4 // 10), :max(1, w * 4 // 10)] = 1
    elif pattern == "random 17%":
        hist[rng.random((h, w)) < 0.17] = 2
    elif pattern == "one pixel":
        hist[:] = 4
        hist[h // 2, w // 2] = 3
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    gb = {"position": t(pos), "normal": t(nrm)}
    args = [t(color), gb, np.float32(0.2), np.float32(0.35)]
    if pattern != "no history":
        args += [t(hist), t(rng.random((h, w), np.float32) * 3)]
    return args


def r_patterns(libs=None) -> dict:
    """Kernel R on every pattern and size of r_pattern_args, for each
    build (the kernel library's and each of `libs`): per case and build
    the pixels off the first build in any bit, and the largest |d| from
    the plain version."""
    out = {}
    for h, w in R_SIZES:
        for pattern in R_PATTERNS:
            args = r_pattern_args(h, w, pattern)
            ref = R.spatial_variance_plain(*args)
            first, res = None, {}
            for name, lib in {"library": None, **(libs or {})}.items():
                got = _lib.with_lib(
                    lib, lambda: R._spatial_variance_kernel(*args))
                first = first if first is not None else got
                res[name] = (plane_diffs({"v": got}, {"v": first})["v"],
                             float((got - ref).abs().max()))
            out[f"{h}x{w} {pattern}"] = res
    return out


# bench.py's room_1080p_animated camera speeds, the glue case's orbit
ORBIT = dict(automate_camera=True, camera_speed_x=0.02,
             camera_speed_theta=0.01, camera_speed_phi=0.015)
# the glue's calls: the wrappers the frame calls (attributes of
# engine/wavefront.py and denoise/svgf.py) and their kernels' names
GLUE = {"generate_camera_rays": (W, "camera_rays_kernel"),
        "primary_finish": (W, "primary_finish_kernel"),
        "motion_bounds": (svgf, "motion_kernel"),
        "motion_parts": (svgf, "motion_kernel")}


def glue_renderer(scene: str, res, frames: int = 4, device: str = "cuda"):
    """A renderer of `scene` at `res` (depth 8, the 5-level temporal SVGF)
    after `frames` frames of the ORBIT camera, its camera moved again for
    the next frame."""
    cfg = dataclasses.replace(CFG, **SVGF5, **ORBIT)
    r = Renderer(Scene(scene_file(scene)), cfg, res, device)
    auto = CameraAutomation(cfg)
    for _ in range(frames):
        r.render_frame()
        auto.step(r.camera)
        r.cam_changed = True
    return r


def capture_glue(r):
    """Render one frame of renderer r and return the arguments (args, kw)
    of the first call of each of GLUE's wrappers that it makes (each
    still runs, so the frame is unchanged)."""
    got, real = {}, {k: getattr(m, k) for k, (m, _) in GLUE.items()}

    def spy(key, fn):
        def call(*args, **kw):
            got.setdefault(key, (args, kw))
            return fn(*args, **kw)
        return call
    for k, (m, _) in GLUE.items():
        setattr(m, k, spy(k, real[k]))
    try:
        r.render_frame()
    finally:
        for k, (m, _) in GLUE.items():
            setattr(m, k, real[k])
    torch.cuda.synchronize()
    return got


def glue_calls(got):
    """Kernels S1, S2 and T on the calls capture_glue captured: name ->
    (kernel call, plain call, the bytes the kernel must move), S2 on a
    moved frame's call and on its position alone (a restored state's),
    T on the whole image's bounds or a shard's parts."""
    out = {}
    (cam, res, *rest), _ = got["generate_camera_rays"]
    o, d = generate_camera_rays_plain(cam, res, *rest)
    out["camera_rays"] = (
        lambda: S._camera_rays_kernel(cam, res, *rest),
        lambda: generate_camera_rays_plain(cam, res, *rest), nbytes(o, d))
    (ds, o, d, t, isect, show), _ = got["primary_finish"]
    ref = S.primary_finish_plain(ds, o, d, t, isect, show)
    out["primary_finish"] = (
        lambda: S._primary_finish_kernel(ds, o, d, t, isect, show),
        lambda: S.primary_finish_plain(ds, o, d, t, isect, show),
        nbytes(t, o, d, isect["mat_id"], isect["uv"], isect["geom_id"],
               *ref))
    out["primary_finish position"] = (
        lambda: S._primary_finish_kernel(ds, o, d, t),
        lambda: S.primary_finish_plain(ds, o, d, t), nbytes(t, o, d, o))
    for name in ("motion_bounds", "motion_parts"):
        if name in got:
            args, kw = got[name]
            plain = getattr(trep, name + "_plain")
            out[name] = (lambda fn=getattr(C, name), a=args, k=kw: fn(*a, **k),
                         lambda fn=plain, a=args, k=kw: fn(*a, **k),
                         nbytes(args[1]["position"], args[1]["geom_id"]))
    return out


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def glue_off(calls) -> dict:
    """name -> the lanes of each output of the kernel that differ from
    its plain version's in any bit (two NaNs equal)."""
    return {name: [int((~((a == b) | (torch.isnan(a) & torch.isnan(b))
                         if a.is_floating_point() else a == b)).sum())
                   for a, b in zip(as_tuple(kfn()), as_tuple(pfn()))
                   if a is not None or b is not None]
            for name, (kfn, pfn, _) in calls.items()}


def measure_glue(r, reps: int = 20):
    """The glue case: kernels S1, S2 and T on the calls of renderer r's
    next frame (its camera moved), each against its plain version (the
    lanes off), timed in turns beside it, and the plain glue also with
    its host (the launches it queues), and each kernel's bound."""
    calls = glue_calls(capture_glue(r))
    off = glue_off(calls)
    out = {}
    for name, (kfn, pfn, n_bytes) in calls.items():
        ms = in_turns({"kernel": kfn, "plain": pfn}, reps)
        out[name] = {"off": off[name], "ms": ms["kernel"],
                     "plain_ms": ms["plain"],
                     "plain_host_ms": cuda_ms(pfn, reps=5),
                     "bound_ms": bound(n_bytes, 0)[0]}
    return out


def run(cases=None, libs=None, reps: int = 20, old_f=()):
    """label -> measure()'s numbers for each case of `cases` (all by
    default); `old_f` as measure()'s."""
    out = {}
    for label in cases or CASES:
        kernel, scene, res, call = CASES[label]
        if kernel == "glue":
            out[label] = {"glue": measure_glue(glue_renderer(scene, res),
                                               reps)}
            continue
        args, kw = capture(kernel, scene, res, call)
        fn = {"back_projection_atrous1": measure_l,
              "spatial_variance": measure_r}.get(kernel)
        out[label] = (fn(args, kw, libs, reps) if fn
                      else measure(kernel, args, kw, libs, reps, old_f))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated labels of CASES")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR",
                    help="also run DIR's copy of each kernel's source")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    card = card_name()
    cases = args.cases.split(",")
    kernels = tuple(dict.fromkeys(CASES[c][0] for c in cases))
    mine = tuple({"trace_bounce": "trace_kernel"}.get(k, k + "_kernel")
                 for k in kernels if k != "glue")
    if "glue" in kernels:
        mine += tuple(dict.fromkeys(k for _, k in GLUE.values()))
    if "path_trace_table" in kernels:    # timed beside the per-scene B1
        mine += ("path_trace_kernel",)
    if "back_projection_atrous1" in kernels:    # timed beside C and D
        mine += ("back_projection_shard_stencil_kernel",
                 "atrous_level_kernel")
    regs = {"library": [r for r in ptxas_summary(_lib.build(force=True))
                        if r.split()[0] in mine]}
    libs, old_f = {}, set()
    for spec in args.variant:
        name, src = spec.split("=", 1)
        libs[name], log = build_variant(
            name, src, tuple(k for k in kernels if k in SOURCE))
        regs[name] = [r for r in ptxas_summary(log) if r.split()[0] in mine]
        if "trace_bounce" in kernels and not reads_through_order(src):
            old_f.add(name)
    res = run(cases, libs, args.reps, old_f)
    pats = r_patterns(libs) if "spatial_variance" in kernels else {}
    for case, v in pats.items():
        print(f"R {case}: pixels off the first build, largest |d| from "
              f"the plain version: " + ", ".join(
                  f"{k} {n} ({d:.3g})" for k, (n, d) in v.items()))
    for scene in dict.fromkeys(CASES[c][1] for c in res
                               if CASES[c][0] in PER_SCENE):
        if scene == "trace bench":
            scene = "cornell"
        header = A.geom_info(Scene(scene_file(scene)), "cuda").path_scene
        if header is not None:
            regs[f"scene {scene}"] = [
                r for r in ptxas_summary(_lib.build_scene(header)[1])
                if r.split()[0] in mine]
    for label, m in res.items():
        for name, v in m.get("glue", {}).items():
            print(f"{label} {name}: " + ", ".join(f"{t:.4f}" for t in v["ms"])
                  + f" ms, bound {v['bound_ms']:.4f} ms (bytes), plain "
                  + ", ".join(f"{t:.4f}" for t in v["plain_ms"])
                  + f" ms on the device ({v['plain_host_ms']:.4f} ms with "
                  f"its host); lanes differing from the plain version by "
                  f"output: {v['off']} [{card}]")
        if "glue" in m:
            continue
        first = next(iter(m["builds"]))
        for name, v in m["builds"].items():
            bad = {k: n for k, n in v["diffs"].items() if n}
            off = {k: n for k, n in v["diffs_first"].items() if n}
            cd = ""
            if "diffs_c_then_d" in v:
                cd = {k: n for k, n in v["diffs_c_then_d"].items() if n}
                cd = f", from C's then D's kernels: {cd or 'none'}"
            print(f"{label} [{name}]: "
                  + ", ".join(f"{t:.4f}" for t in v["ms"])
                  + f" ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']})"
                  + (f" (without the cull {m['bound_full_ms']:.4f} ms: "
                     f"{m['skipped_tests']} of {m['box_tests']} box tests "
                     f"skip the geom's analytic test)"
                     if "bound_full_ms" in m else "")
                  + f", plain {m['plain_ms']:.2f} ms, {m['lanes']} lanes, "
                  f"{m['tri_tests']} lane-triangle tests; lanes differing "
                  f"from the plain version by plane: {bad or 'none'}, from "
                  f"the {first} build: {off or 'none'}{cd} [{card}]")
        if "live" in m:
            print(f"{label}: {m['live'] / m['lanes']:.4f} of the lanes "
                  f"live, {m['nee'] / m['lanes']:.4f} with a shadow ray "
                  f"(Q's bound counts their planes alone)")
        for name, ms in m.get("parts", {}).items():
            off = m.get("parts_off", {}).get(name)
            print(f"{label} [{name}]: " + ", ".join(f"{t:.4f}" for t in ms)
                  + " ms" + (f", {off} pixels off" if off is not None
                             else "") + f" [{card}]")
        if "taps" in m:
            print(f"{label}: {m['taps']} of {m['lanes']} pixels run the "
                  f"taps, their taps read {m['read']}; "
                  f"{m['idle_blocks']} of {m['blocks']} blocks none, "
                  f"{m['tap_warps']} warps run taps; by tile "
                  f"{m['tiles']}; zero distances {m['zero_pairs']}"
                  + (f"; bound where none does "
                     f"{m['none_needed_bound_ms']:.4f} ms (bytes)"
                     if "none_needed_bound_ms" in m else "") + f" [{card}]")
    for name, r in regs.items():
        print(f"ptxas [{name}]: " + "; ".join(r))
    if "spatial_variance" in kernels:   # R's tap loop: 7 taps a trip
        for name in ("library", *libs):
            so = _lib.LIB if name == "library" else (
                _lib.BUILD / f"variant-{name}.so")
            listing = sass(so, "spatial_variance_kernel")
            (_lib.BUILD / f"sass-r-{name}.txt").write_text(listing)
            print(f"SASS [{name}]: spatial_variance_kernel "
                  f"{len(listing.splitlines())} instructions; loops "
                  f"(body, by opcode): {sass_loops(listing)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "ptxas": regs, "cases": res,
                       "r_patterns": pats}, f, indent=1)


if __name__ == "__main__":
    main()
