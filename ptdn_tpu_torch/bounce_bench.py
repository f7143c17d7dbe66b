"""Kernels F (trace_bounce) and H (bounce_fused) on the card, at bounce 2
of the scenes whose users feel them.

    python3 -m ptdn_tpu_torch.bounce_bench [--reps N] [--cases LIST]
                                           [--variant NAME=DIR]...
                                           [--out FILE]

Each case renders three frames of a scene through its engine (depth 8,
RenderConfig's defaults otherwise), captures the arguments of the fourth
frame's bounce-2 call of F (the sorted wavefront) or H (the fused
per-bounce engine), and on them, for each build of the kernel (the
scene's own, csrc/scene/bounce.cu, where the scene has one, and the
kernel library's, csrc/bounce.cu)

* counts, per output plane, the lanes where the kernel's value differs
  from its plain version's in any bit (two NaNs count as equal): the 21
  B_* planes, and F's three next-albedo planes;
* times the kernel with CUDA events over N launches (default 20), the
  host hidden behind a device spin (utils/card.py:cuda_ms), the builds
  in turns there and back, and the plain version once;
* computes the kernel's bound: its planes in and out once over the HBM
  rate, or its operations over the float32 rate, counting the analytic
  tests of both rays, the refine and, in H, the shading of every lane,
  and the lane-triangle tests that the plain version's scan made.

Cases (CASES): F on diamond and bunny at 800x800 and room at 1920x1080,
H on cornell and bunny at 800x800 and room at 600x600.

--variant NAME=DIR (repeatable) builds DIR/bounce.cu, a copy of csrc/
with bounce.cu or its headers changed (an older tree's csrc, or a source
with one part of the work taken out), into a library of its own with the
same C interface, and runs every case's kernel from it too, on the same
captured inputs, as the wrappers run the kernel library's build, so that
two designs are compared in one process on one card.

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

from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import bounce as F
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.card import (ANALYTIC_OPS, MOLLER_OPS, REFINE_OPS,
                                       SHADE_OPS, bound, card_name, cuda_ms,
                                       nbytes, ptxas_summary)
from ptdn_tpu_torch.utils.config import RenderConfig

CFG = RenderConfig(trace_depth=8)
# the flags of each kernel's engine: the sort (the mesh scenes' default)
# for F, the unsorted fused per-bounce engine for H
ENGINE = {"trace_bounce": {},
          "bounce_fused": dict(fuse_path=False, sort_rays=False)}
CASES = {"F diamond": ("trace_bounce", "diamond", (800, 800)),
         "F bunny": ("trace_bounce", "bunny", (800, 800)),
         "F room 1920x1080": ("trace_bounce", "room", (1920, 1080)),
         "H cornell": ("bounce_fused", "cornell", (800, 800)),
         "H bunny": ("bounce_fused", "bunny", (800, 800)),
         "H room": ("bounce_fused", "room", (600, 600))}
B_PLANES = ("spx", "spy", "spz", "dx", "dy", "dz", "t", "nx", "ny", "nz",
            "tr", "tg", "tb", "rr", "rg", "rb", "mat", "act", "dif", "uu",
            "vv")
ALB_PLANES = ("alb_r", "alb_g", "alb_b")


def capture_bounce(r, depth: int, names):
    """Render one frame of renderer r and return, for each engine function
    of `names` (attributes of engine/wavefront.py) that the frame calls,
    the arguments of its call on bounce `depth` as (args, kw) (each
    wrapper still runs, so the frame is unchanged)."""
    got, seen = {}, dict.fromkeys(names, 0)
    real = {k: getattr(W, k) for k in names}

    def spy(key, fn):
        def call(*args, **kw):
            seen[key] += 1
            if seen[key] == depth:
                got[key] = ([a.clone() if torch.is_tensor(a) else a
                             for a in args], kw)
            return fn(*args, **kw)
        return call
    for k in names:
        setattr(W, k, spy(k, real[k]))
    try:
        r.render_frame()
    finally:
        for k in names:
            setattr(W, k, real[k])
    if r.device.type == "cuda":
        torch.cuda.synchronize()
    return got


def capture(kernel: str, scene: str, res, device="cuda"):
    """(args, kw) of `kernel`'s bounce-2 call on the fourth frame of
    `scene` at `res` through the kernel's engine."""
    r = Renderer(Scene(scene_path(scene)),
                 dataclasses.replace(CFG, **ENGINE[kernel]), res, device)
    for _ in range(3):
        r.render_frame()
    return capture_bounce(r, 2, (kernel,))[kernel]


def kernel_fn(kernel: str):
    return {"trace_bounce": F._trace_bounce_kernel,
            "bounce_fused": F._bounce_fused_kernel}[kernel]


def plain_fn(kernel: str):
    return {"trace_bounce": F.trace_bounce_plain,
            "bounce_fused": F.bounce_fused_plain}[kernel]


def out_planes(kernel: str, out):
    """The output planes by name: F's B_* planes and next albedo, H's
    B_* planes."""
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


def work(kernel: str, args, out, tri_tests: int):
    """The kernel's bound on these inputs (utils/card.py:bound)."""
    ds, gi, planes = args
    lanes = planes[0].numel()
    n_an = sum(1 for t in gi.types if t != 2)
    per_lane = 2 * n_an * ANALYTIC_OPS + REFINE_OPS
    if kernel == "bounce_fused":
        per_lane += SHADE_OPS
    outs = out if isinstance(out, tuple) else (out,)
    return bound(nbytes(planes, *outs), lanes * per_lane
                 + tri_tests * MOLLER_OPS)


def build_variant(name: str, src_dir) -> tuple:
    """Compile src_dir/bounce.cu with the kernel library's flags into
    build/variant-<name>.so; returns (the library with F's and H's entry
    points declared, ptxas's report of it)."""
    _lib.BUILD.mkdir(exist_ok=True)
    so = _lib.BUILD / f"variant-{name}.so"
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                          str(so), str(pathlib.Path(src_dir) / "bounce.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}")
    lib = ctypes.CDLL(str(so))
    for fn in ("ptdn_trace_bounce", "ptdn_bounce_fused"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, fn).restype = ctypes.c_int
    return lib, res.stdout


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
    differing lanes and the kernel's ms, all timed in turns there and
    back: the scene's own build ("scene", where the scene has one), the
    kernel library's ("library"), and each library of `libs` (name ->
    library, built by build_variant), which the wrappers take as they
    take the kernel library's."""
    ds, gi, planes = args
    lib_args = (ds, gi._replace(path_scene=None), planes)
    builds = {"library": (None, lib_args)}
    if gi.path_scene is not None:
        builds = {"scene": (None, args), **builds}
    builds.update({name: (lib, lib_args)
                   for name, lib in (libs or {}).items()})
    kfn, pfn = kernel_fn(kernel), plain_fn(kernel)
    A.mesh_best.tri_tests = A.light_visible.tri_tests = 0
    ref = pfn(*args, **kw)
    tests = A.mesh_best.tri_tests + A.light_visible.tri_tests
    ref_planes = out_planes(kernel, ref)
    per = {}
    for name, (lib, a) in builds.items():
        got = _with_lib(lib, lambda: kfn(*a, **kw))
        per[name] = {"diffs": plane_diffs(out_planes(kernel, got),
                                          ref_planes), "ms": []}
    order = list(builds) + list(builds)[::-1]
    for name in order:
        lib, a = builds[name]
        per[name]["ms"].append(_with_lib(lib, lambda: cuda_ms(
            lambda: kfn(*a, **kw), reps=reps, hide_host=True)))
    plain_ms = cuda_ms(lambda: pfn(*args, **kw), reps=1, warmup=0,
                       hide_host=True)
    bound_ms, bound_by = work(kernel, args, ref, tests)
    return {"lanes": planes[0].numel(), "tri_tests": tests,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "turns": order, "builds": per}


def run(cases=None, libs=None, reps: int = 20):
    """label -> measure()'s numbers for each case of `cases` (all by
    default)."""
    out = {}
    for label in cases or CASES:
        kernel, scene, res = CASES[label]
        args, kw = capture(kernel, scene, res)
        out[label] = measure(kernel, args, kw, libs, reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated labels of CASES")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR", help="also run DIR/bounce.cu")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    card = card_name()
    mine = ("trace_kernel", "bounce_fused_kernel")
    regs = {"library": [r for r in ptxas_summary(_lib.build(force=True))
                        if r.split()[0] in mine]}
    libs = {}
    for spec in args.variant:
        name, src = spec.split("=", 1)
        libs[name], log = build_variant(name, src)
        regs[name] = [r for r in ptxas_summary(log) if r.split()[0] in mine]
    res = run(args.cases.split(","), libs, args.reps)
    for scene in dict.fromkeys(CASES[c][1] for c in res):
        header = A.geom_info(Scene(scene_path(scene)), "cuda").path_scene
        if header is not None:
            regs[f"scene {scene}"] = [
                r for r in ptxas_summary(_lib.build_scene(header)[1])
                if r.split()[0] in mine]
    for label, m in res.items():
        for name, v in m["builds"].items():
            bad = {k: n for k, n in v["diffs"].items() if n}
            print(f"{label} [{name}]: "
                  + ", ".join(f"{t:.4f}" for t in v["ms"])
                  + f" ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}), "
                  f"plain {m['plain_ms']:.2f} ms, {m['lanes']} lanes, "
                  f"{m['tri_tests']} lane-triangle tests; lanes differing "
                  f"from the plain version by plane: {bad or 'none'} "
                  f"[{card}]")
    for name, r in regs.items():
        print(f"ptxas [{name}]: " + "; ".join(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "ptxas": regs, "cases": res}, f,
                      indent=1)


if __name__ == "__main__":
    main()
