"""Kernels P and O beside other builds of their sources, on the card.

    python3 -m ptdn_tpu_torch.probes.compare [--variant NAME=DIR]...
        [--reps N] [--ptx DIR] [--frames] [--out FILE]

Builds: this tree's kernel library, and for each --variant DIR's copy of
csrc/intersect_v1.cu and csrc/dyngather.cu (another tree's csrc, or a
changed source, with this tree's entry points) compiled with the
library's flags into a library of its own. On the same inputs, for
every build:

* P on the intersect_v1 probe's three ray sets of 640,000 rays (bunny's
  and cornell's camera rays at 800 x 800, the trace bench's random rays
  in cornell), the cull on and off: its rough (t, tri) checked equal bit
  for bit to the plain version's (the cull by warps) and to the first
  build's; with the bound of the TPU's 512-ray block cull's tests and of
  the warp cull's, both at 60 operations a test (the plain version
  counts both);
* O on the dyngather probe's four timed chains: checked equal to the
  plain version, the numpy chain and the first build;

and times each build with CUDA events, the host hidden behind a device
spin, in turns there and back (utils/card.py:in_turns), and an empty
launch (torch.cuda._sleep(0) behind the same spin): the floor that no
launch beats, beside O's bound.

--ptx DIR compiles every other source of this tree's csrc/ (the kernel
library's, and csrc/scene/*.cu with cornell's scene header) and DIR's
copy of it to PTX, and compares them entry by entry, up to the hash of
the file's path that nvcc puts in internal names. --frames times still
cornell (the whole path) and bunny and room through the fused
per-bounce engine, ms/frame over 20 frames after 3, through this tree's
renderer. Prints one line per case and build with the card's name and
power limit, then each build's ptxas report of P's and O's kernels, and
writes every number as JSON to FILE where given. Needs one card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import re
import subprocess
import tempfile

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import dyngather as O
from ptdn_tpu_torch.ops.cuda import intersect_v1 as P
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.probes import dyngather as probe_o
from ptdn_tpu_torch.probes import intersect_v1 as probe_p
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.card import (bound, card_name, cuda_ms, in_turns,
                                       nbytes, ptxas_summary)

# float operations of one plane-form lane-triangle test (chip_smoke.py's)
PLANE_OPS = 60
SOURCES = ("intersect_v1.cu", "dyngather.cu")
MINE = ("mesh_intersect_v1_kernel", "take_chain_kernel",
        "take_chain_staged_kernel")


def variant(name: str, src_dir):
    """(DIR's P and O built into a library, its ptxas report)."""
    src = pathlib.Path(src_dir)
    return _lib.build_variant(
        name, [src / s for s in SOURCES],
        {k: _lib.ENTRIES[k] for k in ("ptdn_mesh_intersect_v1",
                                      "ptdn_take_chain")})


def run_p(builds, reps):
    """label -> P's numbers on each probe set, cull on and off."""
    out = {}
    for label, (_, pt, _, o, d) in probe_p.cases("cuda").items():
        for cull in (True, False):
            counts = {}
            P.mesh_intersect_v1_plain.tri_tests = 0
            ref = P.mesh_intersect_v1_plain(pt, o, d, cull, counts=counts)
            tests = P.mesh_intersect_v1_plain.tri_tests
            fns, first = {}, None
            for name, lib in builds.items():
                fns[name] = (lambda lib=lib: _lib.with_lib(
                    lib, lambda: P._mesh_intersect_v1_kernel(pt, o, d, cull)))
                got = fns[name]()
                first = first or got
                for what, want in (("plain version", ref),
                                   ("first build", first)):
                    if not (torch.equal(got[0].view(torch.int32),
                                        want[0].view(torch.int32))
                            and torch.equal(got[1], want[1])):
                        raise RuntimeError(f"P {label}, cull {cull}, {name}: "
                                           f"differs from the {what}")
            io = nbytes(o, d, pt.tri_mm, pt.cmin, pt.cmax, *ref)
            tpu = counts.get(P.RBLK, tests) if cull else tests
            out[f"{label}, cull {cull}"] = {
                "ms": in_turns(fns, reps), "hits": int((ref[1] >= 0).sum()),
                "tests_512": tpu, "tests_warp": tests,
                "bound_512": bound(io, tpu * PLANE_OPS),
                "bound_warp": bound(io, tests * PLANE_OPS),
                "counts": {str(k): v for k, v in counts.items()}}
    return out


def run_o(builds, reps):
    """chain -> O's numbers on each timed chain."""
    out = {}
    for s, l, axis, chain in probe_o.TIMED:
        x_np, i_np = probe_o.inputs(s, l, axis)
        x, idx = (torch.from_numpy(a).cuda() for a in (x_np, i_np))
        want = probe_o.numpy_chain(x_np, i_np, axis, chain)
        plain = O.take_chain_plain(x, idx, axis, chain)
        fns = {name: (lambda lib=lib: _lib.with_lib(
            lib, lambda: O._take_chain_kernel(x, idx, axis, chain)))
            for name, lib in builds.items()}
        for name, fn in fns.items():
            got = fn()
            if not (torch.equal(got, plain)
                    and np.array_equal(got.cpu().numpy(), want)):
                raise RuntimeError(f"O {(s, l, axis, chain)}, {name}: "
                                   f"differs from the plain version")
        out[f"({s}, {l}) axis {axis}, chain {chain}"] = {
            "plan": O.tile_plan(s, l, axis), "ms": in_turns(fns, reps),
            "bound": bound(nbytes(x, idx, plain), 0)}
    return out


def entries(ptx: str):
    """entry name -> its PTX body, nvcc's path hash taken out of names."""
    ptx = re.sub(r"_(INTERNAL|GLOBAL__N_)_[0-9a-f]+_", r"_\1_", ptx)
    return {m.group(1): m.group(0) for m in re.finditer(
        r"\.entry (\w+)\((?:.|\n)*?\n}\n", ptx)}


def ptx_diff(other):
    """Every source of csrc/ but P's and O's, here and in `other` (a
    csrc copy), to PTX: (entries compared, the names that differ)."""
    here = _lib.CSRC
    header = A.geom_info(Scene(scene_path("cornell")), "cuda").path_scene
    srcs = [p.relative_to(here) for p in sorted(here.glob("*.cu"))
            if p.name not in SOURCES] + sorted(
        p.relative_to(here) for p in (here / "scene").glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        (pathlib.Path(tmp) / "scene.h").write_text(header)

        def ptx(path):
            dst = pathlib.Path(tmp) / f"{abs(hash(str(path)))}.ptx"
            res = subprocess.run(
                [_lib._nvcc(), *_lib.ARCH, "-std=c++17", "-O3",
                 "--fmad=false", "-I", tmp, "-ptx", "-o", str(dst),
                 str(path)], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc -ptx failed on {path}:\n"
                                   f"{res.stderr}")
            return entries(dst.read_text())
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            mine = list(pool.map(ptx, [here / s for s in srcs]))
            theirs = list(pool.map(ptx, [pathlib.Path(other) / s
                                         for s in srcs]))
    n, differ = 0, []
    for src, a, b in zip(srcs, mine, theirs):
        for name in sorted(set(a) | set(b)):
            n += 1
            if a.get(name) != b.get(name):
                differ.append(f"{src}:{name}")
    return n, differ


def frames(reps=20):
    """ms/frame of still cornell (whole path), bunny and room (fused
    per-bounce engine) through this tree's renderer."""
    import dataclasses

    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(trace_depth=8, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=5)
    fused = dict(fuse_path=False, sort_rays=False)
    out = {}
    for label, name, res, kw in (
            ("cornell", "cornell", (800, 800), {}),
            ("bunny fused", "bunny", (800, 800), fused),
            ("room fused", "room", (600, 600), fused)):
        r = Renderer(Scene(scene_path(name)), dataclasses.replace(cfg, **kw),
                     resolution=res, device="cuda")
        for _ in range(3):
            r.render_frame()
        out[label] = cuda_ms(r.render_frame, reps=reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptx", metavar="DIR",
                    help="compare every other kernel's PTX with DIR's")
    ap.add_argument("--frames", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    card = card_name()
    regs = {"this tree": [r for r in ptxas_summary(_lib.build(force=True))
                          if r.split()[0] in MINE]}
    builds = {"this tree": None}
    for spec in args.variant:
        name, src = spec.split("=", 1)
        builds[name], log = variant(name, src)
        regs[name] = [r for r in ptxas_summary(log) if r.split()[0] in MINE]
    res = {"card": card, "ptxas": regs,
           "empty_launch_ms": cuda_ms(lambda: torch.cuda._sleep(0),
                                      reps=args.reps, hide_host=True)}
    res["P"] = run_p(builds, args.reps)
    res["O"] = run_o(builds, args.reps)
    res["empty_launch_ms_after"] = cuda_ms(lambda: torch.cuda._sleep(0),
                                           reps=args.reps, hide_host=True)
    for label, m in res["P"].items():
        print(f"P {label} ({m['hits']} mesh hits): " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in m["ms"].items())
              + f" ms; bound {m['bound_512'][0]:.4f} ms ({m['bound_512'][1]}"
              f", {m['tests_512']} tests of the 512-ray block cull), "
              f"{m['bound_warp'][0]:.4f} ms ({m['tests_warp']} of the warp "
              f"cull) [{card}]")
    for label, m in res["O"].items():
        print(f"O {label}, tiles {m['plan']}: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in m["ms"].items())
              + f" ms; bound {m['bound'][0]:.4f} ms ({m['bound'][1]}) "
              f"[{card}]")
    print(f"empty launch {res['empty_launch_ms']:.4f}, "
          f"{res['empty_launch_ms_after']:.4f} ms [{card}]")
    if args.ptx:
        n, differ = ptx_diff(args.ptx)
        res["ptx"] = {"entries": n, "differ": differ}
        print(f"PTX of every other kernel against {args.ptx}: {n} entries, "
              f"{len(differ)} differ" + "".join(f"; {d}" for d in differ))
    if args.frames:
        res["frames"] = frames()
        print("frames " + ", ".join(f"{k} {v:.3f} ms/frame"
                                    for k, v in res["frames"].items())
              + f" [{card}]")
    for name, r in regs.items():
        print(f"ptxas [{name}]: " + "; ".join(r))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
