"""Kernels F (trace_bounce), H (bounce_fused), A (scene_intersect_full),
J (scene_intersect_full_tex), I (light_visibility), L
(back_projection_atrous1), M (scene_intersect) and B1's table build
(path_trace_table) on the card, on the calls of the scenes whose users
feel them.

    python3 -m ptdn_tpu_torch.bounce_bench [--reps N] [--cases LIST]
                                           [--variant NAME=DIR]...
                                           [--out FILE]

Each case renders three frames of a scene through its engine (depth 8,
RenderConfig's defaults otherwise) and captures the arguments of one
call of the kernel on the fourth frame: the bounce-2 call of F (the
sorted wavefront), of H (the fused per-bounce engine) or of A, J or I
(the split per-bounce engine), or A's primary hit, the camera rays of a
frame whose camera moved, or B1's call (the whole-path engine, its only
one in a frame). M takes the trace bench's rays (trace_bench.setup, the
chunk cull on and off) or a scene's camera rays. On them, for each build
of the kernel (the scene's own, csrc/scene/bounce.cu or
scene_intersect.cu, or for B1's table build the per-scene B1,
csrc/scene/path_trace.cu, where the scene has one, and the kernel
library's)

* counts, per output, the lanes where the kernel's value differs from
  its plain version's in any bit (two NaNs count as equal): the 21 B_*
  planes, and F's three next-albedo planes; A's t, normal, uv, material
  and geom, and J's texel index besides; I's lit flag; M's five
  outputs; B1's 6 x depth contribution planes and depth - 1 texel-index
  planes; and the same against the first build's output;
* times the kernel with CUDA events over N launches (default 20), the
  host hidden behind a device spin (utils/card.py:cuda_ms), the builds
  in turns there and back, and the plain version once;
* computes the kernel's bound: its inputs and outputs once over the HBM
  rate, or its operations over the float32 rate, counting the analytic
  tests of every ray (both rays in F and H, and in B1 at every depth),
  the refine and, in H and B1, the shading of every lane, and the
  lane-triangle tests that the plain version's scan made.

The L case takes L's call on the fourth frame of cornell at 800x800
with fuse_reproject_l1 (a still camera: L on every frame after the
first), and times there, in turns, each build of L beside kernel C
(stencil mode) alone and kernel D at level 1 alone on C's output and
the packed G-buffer planes, as the frame without the flag runs them;
per output (color, variance, moments, history) it counts the pixels off
L's plain version and off C's then D's kernels.

Cases (CASES): F on diamond and bunny at 800x800 and room at 1920x1080;
H on cornell and bunny at 800x800 and room at 600x600; J on cornell at
800x800 and room at 600x600; A on bunny at 800x800, and on the primary
hits of room at 1920x1080 and of cornell at 800x800; I on cornell and
bunny at 800x800 and room at 600x600; L on cornell at 800x800; M on the
trace bench's 640,000 rays, cull on and off, and on bunny's 800x800
camera rays; B1's table build on cornell and on cornell plus 55 cubes
(utils/assets.py:write_cornell_plus, 65 geoms) at 800x800.

--variant NAME=DIR (repeatable) builds DIR's copy of each timed kernel's
source (SOURCE: DIR/bounce.cu for F and H, DIR/scene_intersect.cu for A,
J, I and M, DIR/reproject_atrous.cu for L, DIR/path_trace_table.cu for
B1's table build), a copy of csrc/ with that source or its headers
changed (an older tree's csrc, or a source with one part of the work
taken out), into a library of its own with the same C interface, and
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
import json
import pathlib
import subprocess

import torch

from ptdn_tpu_torch import trace_bench
from ptdn_tpu_torch.denoise import svgf
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import bounce as F
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import reproject_atrous as L
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path, write_cornell_plus
from ptdn_tpu_torch.utils.card import (ANALYTIC_OPS, BOX_OPS, MOLLER_OPS,
                                       REFINE_OPS, SHADE_OPS, bound,
                                       card_name, cuda_ms, nbytes,
                                       ptxas_summary)
from ptdn_tpu_torch.utils.config import RenderConfig

CFG = RenderConfig(trace_depth=8)
# the flags of each kernel's engine: the sort (the mesh scenes' default)
# for F, the unsorted fused per-bounce engine for H, the split one for A,
# J and I; for L the headline frame's temporal SVGF with its 5-level
# filter and fuse_reproject_l1
SPLIT = dict(fuse_path=False, fuse_bounce=False)
FUSE_L1 = dict(denoise_enable=True, temporal_enable=True,
               spatial_enable=True, atrous_nlevel=5, fuse_reproject_l1=True)
ENGINE = {"trace_bounce": {},
          "bounce_fused": dict(fuse_path=False, sort_rays=False),
          "scene_intersect_full": SPLIT, "scene_intersect_full_tex": SPLIT,
          "light_visibility": SPLIT, "back_projection_atrous1": FUSE_L1,
          "path_trace_table": {}, "scene_intersect": {}}
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
# "trace bench"), "camera" on a scene's camera rays
CASES = {"F diamond": ("trace_bounce", "diamond", (800, 800), 2),
         "F bunny": ("trace_bounce", "bunny", (800, 800), 2),
         "F room 1920x1080": ("trace_bounce", "room", (1920, 1080), 2),
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
                                1)}
B_PLANES = ("spx", "spy", "spz", "dx", "dy", "dz", "t", "nx", "ny", "nz",
            "tr", "tg", "tb", "rr", "rg", "rb", "mat", "act", "dif", "uu",
            "vv")
ALB_PLANES = ("alb_r", "alb_g", "alb_b")
# the module whose attribute each kernel's caller calls, where it is not
# engine/wavefront.py, and that attribute's name, where it is not the
# kernel's
CALLER = {"back_projection_atrous1": svgf}
CALLED = {"path_trace_table": "path_trace"}
# the generated scene past B1's per-scene build: cornell plus this many
# cubes (65 geoms)
CUBES = 55


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
    "cull" or "no cull"."""
    if scene == "trace bench":
        return list(trace_bench.setup(device)), {"cull": call == "cull"}
    r = Renderer(Scene(scene_file(scene)),
                 dataclasses.replace(CFG, **ENGINE[kernel]), res, device)
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
    return capture_bounce(r, call, (name,), CALLER.get(kernel, W))[name]


def kernel_fn(kernel: str):
    return {"trace_bounce": F._trace_bounce_kernel,
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
    return {"trace_bounce": F.trace_bounce_plain,
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
    """The output planes by name: F's B_* planes and next albedo, H's
    B_* planes, A's outputs, J's and its texel index, I's lit flag, L's
    color, variance, moments and history, M's outputs, B1's
    contribution and texel-index planes."""
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
    b, alb = out
    names = B_PLANES + (ALB_PLANES if alb is not None else ())
    return dict(zip(names, list(b) + (list(alb) if alb is not None
                                      else [])))


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
        ins = args[2:3]
        outs = out if isinstance(out, tuple) else (out,)
    return bound(nbytes(*ins, *outs), n_lanes(kernel, args) * per_lane
                 + tri_tests * MOLLER_OPS)


def build_variant(name: str, src_dir, kernels=tuple(SOURCE)) -> tuple:
    """Compile src_dir's copy of the source of each of `kernels` (SOURCE)
    with the kernel library's flags into build/variant-<name>.so; returns
    (the library with their entry points declared, ptxas's report of
    it)."""
    _lib.BUILD.mkdir(exist_ok=True)
    so = _lib.BUILD / f"variant-{name}.so"
    sources = dict.fromkeys(SOURCE[k][0] for k in kernels)
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                          str(so), *(str(pathlib.Path(src_dir) / src)
                                     for src in sources)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}")
    entries = [SOURCE[k][1] for k in kernels]
    return (_lib.declare(ctypes.CDLL(str(so)),
                         {e: _lib.ENTRIES[e] for e in entries}), res.stdout)


def _with_lib(lib, fn):
    """fn() with the wrappers launching from `lib` (None: the kernel
    library)."""
    if lib is None:
        return fn()
    real = _lib.kernels
    _lib.kernels = lambda: lib
    try:
        return fn()
    finally:
        _lib.kernels = real


def measure(kernel: str, args, kw, libs=None, reps: int = 20):
    """The numbers of one case: lanes, the plain scan's lane-triangle
    tests, the plain version's ms, the bound, and per build the per-plane
    differing lanes (against the plain version, and against the first
    build) and the kernel's ms, all timed in turns there and back: the
    scene's own build ("scene", where the kernel and the scene have one),
    the kernel library's ("library"), and each library of `libs` (name ->
    library, built by build_variant), which the wrappers take as they
    take the kernel library's."""
    ds, gi, *rest = args
    lib_args = (ds, gi._replace(path_scene=None), *rest)
    builds = {"library": (None, lib_args)}
    if gi.path_scene is not None and kernel in PER_SCENE:
        builds = {"scene": (None, args), **builds}
    builds.update({name: (lib, lib_args)
                   for name, lib in (libs or {}).items()})
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
        got = out_planes(kernel, _with_lib(lib, lambda: kfn(*a, **kw)))
        first = first or got
        per[name] = {"diffs": plane_diffs(got, ref_planes),
                     "diffs_first": plane_diffs(got, first), "ms": []}
    order = list(builds) + list(builds)[::-1]
    for name in order:
        lib, a = builds[name]
        per[name]["ms"].append(_with_lib(lib, lambda: cuda_ms(
            lambda: kfn(*a, **kw), reps=reps, hide_host=True)))
    plain_ms = cuda_ms(lambda: pfn(*args, **kw), reps=1, warmup=0,
                       hide_host=True)
    bound_ms, bound_by = work(kernel, args, kw, ref, tests, culls)
    out = {"lanes": n_lanes(kernel, args), "tri_tests": tests,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "turns": order, "builds": per}
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
        got = out_planes(kernel, _with_lib(lib, fn))
        first = first or got
        per[name] = {"diffs": plane_diffs(got, ref_planes),
                     "diffs_first": plane_diffs(got, first),
                     "diffs_c_then_d": plane_diffs(got, c_then_d),
                     "ms": []}
    parts = {"C": (None, lambda: C._back_projection_stencil_kernel(*cargs)),
             "D level 1": (None, lambda: D._atrous_level_kernel(*d_args))}
    runs.update(parts)
    times = {name: [] for name in runs}
    order = list(runs) + list(runs)[::-1]
    for name in order:
        lib, fn = runs[name]
        times[name].append(_with_lib(lib, lambda: cuda_ms(
            fn, reps=reps, hide_host=True)))
    for name in per:
        per[name]["ms"] = times[name]
    plain_ms = cuda_ms(lambda: L.back_projection_atrous1_plain(*args, **kw),
                       reps=1, warmup=0, hide_host=True)
    bound_ms, bound_by = l_work(args, ref)
    return {"lanes": args[0][0] * args[0][1], "tri_tests": 0,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "turns": order, "builds": per,
            "parts": {k: times[k] for k in parts}}


def run(cases=None, libs=None, reps: int = 20):
    """label -> measure()'s numbers for each case of `cases` (all by
    default)."""
    out = {}
    for label in cases or CASES:
        kernel, scene, res, call = CASES[label]
        args, kw = capture(kernel, scene, res, call)
        out[label] = (measure_l(args, kw, libs, reps)
                      if kernel == "back_projection_atrous1"
                      else measure(kernel, args, kw, libs, reps))
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
                 for k in kernels)
    if "path_trace_table" in kernels:    # timed beside the per-scene B1
        mine += ("path_trace_kernel",)
    if "back_projection_atrous1" in kernels:    # timed beside C and D
        mine += ("back_projection_stencil_kernel", "atrous_level_kernel")
    regs = {"library": [r for r in ptxas_summary(_lib.build(force=True))
                        if r.split()[0] in mine]}
    libs = {}
    for spec in args.variant:
        name, src = spec.split("=", 1)
        libs[name], log = build_variant(name, src, kernels)
        regs[name] = [r for r in ptxas_summary(log) if r.split()[0] in mine]
    res = run(cases, libs, args.reps)
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
        for name, ms in m.get("parts", {}).items():
            print(f"{label} [{name}]: " + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms [{card}]")
    for name, r in regs.items():
        print(f"ptxas [{name}]: " + "; ".join(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "ptxas": regs, "cases": res}, f,
                      indent=1)


if __name__ == "__main__":
    main()
