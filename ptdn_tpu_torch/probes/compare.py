"""Kernels P, O and N beside other builds of their sources, on the card.

    python3 -m ptdn_tpu_torch.probes.compare [--variant NAME=DIR]...
        [--reps N] [--ptx DIR] [--dc DIR] [--shard NAME=DIR]...
        [--frames] [--out FILE]

Builds: this tree's kernel library, and for each --variant DIR's copy of
csrc/intersect_v1.cu, csrc/dyngather.cu and csrc/texgather.cu (another
tree's csrc, or a changed source, with this tree's entry points)
compiled with the library's flags into a library of its own. On the
same inputs, for every build:

* P on the intersect_v1 probe's three ray sets of 640,000 rays (bunny's
  and cornell's camera rays at 800 x 800, the trace bench's random rays
  in cornell), the cull on and off: its rough (t, tri) checked equal bit
  for bit to the plain version's (the cull by warps) and to the first
  build's; with the bound of the TPU's 512-ray block cull's tests and of
  the warp cull's, both at 60 operations a test (the plain version
  counts both), and the plain version's time;
* O on the dyngather probe's four timed chains: checked equal to the
  plain version, the numpy chain and the first build, and the plain
  version's time;
* N on the texgather probe's four cases (cornell's and room's tables,
  random and sorted indices): checked equal to the plain version and
  the first build, with its byte bound and torch.take's time;

and times each build with CUDA events, the host hidden behind a device
spin, in turns there and back (utils/card.py:in_turns), and an empty
launch (torch.cuda._sleep(0) behind the same spin): the floor that no
launch beats, beside O's bound.

--ptx DIR compiles every other source of this tree's csrc/ (the kernel
library's, and csrc/scene/*.cu with cornell's scene header) and DIR's
copy of it to PTX, and compares them entry by entry, up to the hash of
the file's path that nvcc puts in internal names (a source DIR lacks,
and an entry of a shared source that DIR's lacks, are listed as new).
--dc DIR builds DIR's copy of csrc/atrous.cu, csrc/reproject.cu and
csrc/reproject_atrous.cu (another tree's, whose C entries may take a
row offset, ReprojRows, as older trees' did) and runs D at every
level, C's stencil and band modes and L on cornell 800 x 800's fourth
frame (the band mode on a moved view) through both builds, unsharded,
C also on room 1920 x 1080's, and its band mode through this tree's
shard kernel with no halo rows (its stencil mode launches that kernel
unsharded): each output equal bit for bit, each timed in turns.
--shard NAME=DIR (repeatable) builds DIR's copy of csrc/atrous.cu and
csrc/reproject.cu and runs, on cornell 800 x 800's fourth frame split
into 4, 8 and 16 row shards, through this tree's build and DIR's:
D's shard mode at every level (DIR's own shard entry where its source
has one (a variant of this tree's shard kernel), else the level as an
older tree's D took a shard: its input extended by its halo rows into
one buffer, the unsharded entry with a halo), and C's shard mode in
both modes (the band mode on a moved view; DIR's own shard entry where
its source has one, else the row offset as an older tree's C took a
shard: the window of its halo rows, its own rows and its halo rows
built into planes outside the timing, as such a tree's denoiser built
it per frame); every shard's output equal bit for bit to this tree's and the
shards' rows to the unsharded kernel's, one shard of 8 and each count's
sum timed in turns beside the unsharded launch, and C's band shard kernel
on the whole image (no halo rows) beside it.
--frames times still cornell (the whole path) and bunny and room
through the fused per-bounce engine, ms/frame over 20 frames after 3,
through this tree's renderer. Prints one line per case and build with the card's name and
power limit, then each build's ptxas report of P's, O's and N's
kernels, and writes every number as JSON to FILE where given. Needs one
card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import pathlib
import re
import subprocess
import tempfile

import numpy as np
import torch

from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import reproject_atrous as RA
from ptdn_tpu_torch.ops.cuda import dyngather as O
from ptdn_tpu_torch.ops.cuda import intersect_v1 as P
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.ops.cuda import texgather as N
from ptdn_tpu_torch.probes import dyngather as probe_o
from ptdn_tpu_torch.probes import intersect_v1 as probe_p
from ptdn_tpu_torch.probes import texgather as probe_n
from ptdn_tpu_torch.parallel.sharded import back_projection_shards
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.card import (bound, card_name, cuda_ms, in_turns,
                                       nbytes, ptxas_summary)
from ptdn_tpu_torch.utils.config import RenderConfig

# float operations of one plane-form lane-triangle test (chip_smoke.py's)
PLANE_OPS = 60
SOURCES = ("intersect_v1.cu", "dyngather.cu", "texgather.cu")
MINE = ("mesh_intersect_v1_kernel", "take_chain_kernel",
        "take_chain_staged_kernel", "gather_u32_kernel")


def variant(name: str, src_dir):
    """(DIR's P, O and N built into a library, its ptxas report)."""
    src = pathlib.Path(src_dir)
    return _lib.build_variant(
        name, [src / s for s in SOURCES],
        {k: _lib.ENTRIES[k] for k in ("ptdn_mesh_intersect_v1",
                                      "ptdn_take_chain", "ptdn_gather_u32")})


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
                "plain_ms": cuda_ms(lambda: P.mesh_intersect_v1_plain(
                    pt, o, d, cull), reps=1, warmup=0, hide_host=True),
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
            "plain_ms": cuda_ms(lambda: O.take_chain_plain(
                x, idx, axis, chain), reps=3, warmup=1, hide_host=True),
            "bound": bound(nbytes(x, idx, plain), 0)}
    return out


def run_n(builds, reps):
    """case -> N's numbers on each texgather probe case, the builds in
    turns."""
    out = {}
    for label, (table, idx) in probe_n.cases("cuda").items():
        t32, i64 = table.view(torch.int32), idx.to(torch.int64)
        want = N.gather_u32_plain(table, idx).view(torch.int32)
        fns = {name: (lambda lib=lib: _lib.with_lib(
            lib, lambda: N._gather_u32_kernel(table, idx)))
            for name, lib in builds.items()}
        first = None
        for name, fn in fns.items():
            got = fn().view(torch.int32)
            first = got if first is None else first
            for what, ref in (("plain version", want), ("first build", first)):
                if not torch.equal(got, ref):
                    raise RuntimeError(f"N {label}, {name}: differs from "
                                       f"the {what}")
        out[label] = {
            "ms": in_turns(fns, reps),
            "take_ms": cuda_ms(lambda: torch.take(t32, i64), reps,
                               hide_host=True),
            "bound": bound(nbytes(idx, idx)
                           + 4 * torch.unique(idx).numel(), 0)}
    return out


class OlderAtrousArgs(ctypes.Structure):
    """csrc/atrous.cu:AtrousArgs of an older tree: this tree's, then the
    row offset and halo rows of PR 16's extended-input shard mode (a tree
    before it reads the first part alone)."""
    _fields_ = [("a", D.AtrousArgs)] + [(k, ctypes.c_int) for k in (
        "row0", "full_h", "halo", "static_halo")]


def older_level(lib, color, var, static, albedo, level, sl, sn, sx, blur,
                row0=0, full_h=None, halo=0, static_halo=0, ext=None):
    """An older tree's D (`lib`) on a level, split layout out: the whole
    image, or with `ext` a shard's input extended by `halo` rows (one
    packed buffer) through the same entry (atrous_tiling of the shard's
    own rows)."""
    h, w = var.shape
    out = torch.empty((h, w, 3), device=color.device)
    var_out = torch.empty((h, w), device=color.device)
    blocks, phases, ty, tx = D.atrous_tiling(h, w, level)
    p = _lib.ptr
    if ext is not None:
        cv, v = p(ext), None
    else:
        cv, v = p(color), None if D._packed_pair(color, var) else p(var)
    args = OlderAtrousArgs(
        D.AtrousArgs(cv, v, p(static), p(albedo), p(out), p(var_out), w, h,
                     level, int(blur), phases, tx, ty, sl, sn, sx),
        row0, h if full_h is None else full_h, halo, static_halo)
    _lib.launch("ptdn_atrous_level", args, ctypes.c_int(blocks), lib=lib)
    return out, var_out


class OlderReprojRows(ctypes.Structure):
    """csrc/reproject.cuh:ReprojRows of an older tree, which every C
    entry there took: the launch's rows in the image and the first row
    of the previous frame's window."""
    _fields_ = [(k, ctypes.c_int) for k in ("row0", "full_h", "prev_row0")]


def older_c(lib, name, args, band=None, rows=None):
    """An older tree's C (`lib`, entry ptdn_<name>) on the whole image
    (rows None) or on a shard's window form (rows = (row0, full_h,
    prev_row0), the previous frame's planes its window), with a
    ReprojRows argument where its source takes one (`lib.rows_entry`)."""
    h = args[0][1]
    c_args, outs = C.reproj_args(*args, name=name, band=band,
                                 full_h=None if rows is None else rows[1])
    extra = ()
    if lib.rows_entry:
        extra = (OlderReprojRows(*(rows or (0, h, 0))),)
    _lib.launch("ptdn_" + name, c_args, *extra, lib=lib)
    return outs


def c_variant(name: str, sources):
    """DIR's C (csrc/reproject.cu among `sources`, built with them) with
    its entries declared: its shard entry where it has one (lib.own),
    else the row-offset entries of an older tree (lib.rows_entry) or the
    plain ones."""
    text = next(pathlib.Path(s) for s in sources
                if pathlib.Path(s).name == "reproject.cu").read_text()
    own = "ptdn_back_projection_shard" in text
    rows_entry = "ReprojRows" in text and not own
    c_entry = [_lib._VP] * (3 if rows_entry else 2)
    entries = {"ptdn_back_projection_stencil": c_entry,
               "ptdn_back_projection_banded": c_entry}
    if own:
        entries["ptdn_back_projection_shard"] = _lib.ENTRIES[
            "ptdn_back_projection_shard"]
    return entries, own, rows_entry


# the images C is compared on unsharded (--dc): the headline's and
# room's at bench.py's 1080p
C_IMAGES = (("cornell", (800, 800)), ("room", (1920, 1080)))


def fourth_frame(scene="cornell", res=(800, 800)):
    """`scene`'s fourth frame at `res` (cornell 800x800's by default):
    (renderer, frame state, radiance (H, W, 3), G-buffer planes (H, W,
    ...))."""
    cfg = RenderConfig(trace_depth=8, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=5)
    r = Renderer(Scene(scene_path(scene)), cfg, res, "cuda")
    for _ in range(3):
        r.render_frame()
    st = r.step.frame_state()
    rad, gb = r.step.tracer(r._cam[0], r._params, 3, False)
    w, h = r.resolution
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    return r, st, rad.reshape(h, w, 3), gb


def c_modes(st, rad, gb):
    """C's two modes on the fourth frame: name -> (the whole image's
    arguments, the band mode's (starts, band_rows, margin) on the device
    or None): the stencil on the still view, the band mode on a view
    moved by 0.3 across."""
    h, w = rad.shape[:2]
    moved = torch.eye(4, device=rad.device)
    moved[0, 3] = 0.3
    out = {}
    for name, view in (("back_projection_stencil", st["prev_view"]),
                       ("back_projection_banded", st["prev_view"] @ moved)):
        args = ((w, h), rad, gb,
                {"normal": st["prev_normal"], "geom_id": st["prev_geom_id"]},
                view, st["color_history"], st["moment_history"],
                st["history_length"], 0.2, 0.2)
        band = None
        if name == "back_projection_banded":
            band = (trep.motion_bounds((w, h), gb, view)[1:], trep.BAND_ROWS,
                    trep.BAND_MARGIN)
        out[name] = (args, band)
    return out


def whole_shard(args, band):
    """C's shard kernel in band mode on the whole image's call (rows (0,
    h), no halo rows, the starts read to the host); the whole image's
    stencil mode launches it as it is."""
    none = args[1].new_empty((0, args[0][0], C.PACKED))
    return functools.partial(C._back_projection_banded_kernel, *args,
                             band[0].tolist(), *band[1:],
                             rows=(0, args[0][1]), halo=(none, none))


def run_dc(other, reps):
    """D at every level, C in both modes and L of cornell 800x800's
    fourth frame through this tree's build and `other`'s (a csrc
    directory), unsharded, C also on room 1920x1080's and its band mode
    through this tree's shard kernel (whole_shard): equal bit for bit,
    timed in turns."""
    src = pathlib.Path(other)
    sources = [src / "atrous.cu", src / "reproject.cu",
               src / "reproject_atrous.cu"]
    entries, _, rows_entry = c_variant("dc", sources)
    lib, _ = _lib.build_variant("dc", sources, {
        "ptdn_atrous_level": _lib.ENTRIES["ptdn_atrous_level"],
        "ptdn_back_projection_atrous1": _lib.ENTRIES[
            "ptdn_back_projection_atrous1"], **entries})
    lib.rows_entry = rows_entry
    out = {}
    for scene, res in reversed(C_IMAGES):
        r, st, rad, gb = fourth_frame(scene, res)
        for name, (args, band) in c_modes(st, rad, gb).items():
            kernel = (C._back_projection_banded_kernel if band
                      else C._back_projection_stencil_kernel)
            fns = {"this tree": functools.partial(kernel, *args,
                                                  *(band or ())),
                   other: functools.partial(older_c, lib, name, args, band)}
            if band:
                fns["the shard kernel"] = whole_shard(args, band)
            got = [fn() for fn in fns.values()]
            if not all(torch.equal(a, b) for g in got[1:]
                       for a, b in zip(got[0], g)):
                raise RuntimeError(f"C {name}, {scene}: the builds differ")
            key = name if scene == "cornell" else (
                f"{name} {scene} {res[0]}x{res[1]}")
            out[key] = in_turns(fns, reps)
    args = c_modes(st, rad, gb)["back_projection_stencil"][0]
    static = D.pack_static_planes(gb["position"], gb["normal"])
    l_args = args + (0.45, 0.2, 0.35, True, static)
    fns = {"this tree": lambda: RA._back_projection_atrous1_kernel(*l_args),
           other: lambda: _lib.with_lib(
               lib, lambda: RA._back_projection_atrous1_kernel(*l_args))}
    got = [fn() for fn in fns.values()]
    if not all(torch.equal(a, b) for a, b in zip(*got)):
        raise RuntimeError("L: the builds differ")
    out["back_projection_atrous1"] = in_turns(fns, reps)
    stencil = C._back_projection_stencil_kernel(*args)
    var, color = stencil[0], stencil[1]
    albedo = (gb["albedo"] * gb["ialbedo"]).contiguous()
    for level in range(1, 6):
        dargs = (color, var, static, albedo if level == 5 else None, level,
                 0.45, 0.2, 0.35, True)
        fns = {"this tree": lambda: D._atrous_level_kernel(*dargs),
               other: lambda: older_level(lib, *dargs)}
        got = [fn() for fn in fns.values()]
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            raise RuntimeError(f"D level {level}: the builds differ")
        out[f"atrous_level {level}"] = in_turns(fns, reps)
        color, var = got[0]
    return out


SHARD_COUNTS = (4, 8, 16)


def shard_calls(color, var, static, albedo, level, n, h):
    """D's shard-mode calls (_atrous_level_kernel's arguments) of the n
    row shards of a level's input, and each shard's input extended by
    its halo rows as one buffer, with its G-buffer (an older tree's
    form)."""
    halo, sh = D.atrous_halo(level), D.atrous_halo(5)
    pad = lambda x, k: torch.cat([x.new_zeros((k,) + x.shape[1:]), x,  # noqa: E731
                                  x.new_zeros((k,) + x.shape[1:])])
    ext = pad(torch.cat([color, var[..., None]], -1), halo)
    sext = pad(static, sh)
    hl, calls = h // n, []
    for r0 in range(0, h, hl):
        own = ext[halo + r0:halo + r0 + hl]
        rows = (ext[r0:r0 + halo], ext[r0 + hl + halo:r0 + hl + 2 * halo])
        st = sext[r0:r0 + hl + 2 * sh]
        alb = None if albedo is None else albedo[r0:r0 + hl]
        calls.append(((own[..., :3], own[..., 3], st, alb, level, 0.45,
                       0.2, 0.35, True, False, r0, h, rows, sh),
                      ext[r0:r0 + hl + 2 * halo].contiguous()))
    return calls


def extended_shard(lib, call, ext):
    """An older tree's D on a shard: its input extended by its halo rows
    (`ext`), through the unsharded entry with a halo (atrous_tiling of
    the shard's rows)."""
    color, var, static, albedo, level, sl, sn, sx, blur, _, r0, h, rows, \
        sh = call
    return older_level(lib, color, var, static, albedo, level, sl, sn, sx,
                       blur, r0, h, rows[0].shape[0], sh, ext)


def run_shard(specs, reps):
    """D's shard mode at every level and C's shard mode in both modes of
    cornell 800x800's fourth frame on SHARD_COUNTS shards through this
    tree's build and each of `specs` (NAME=DIR, DIR a csrc copy): equal
    bit for bit to this tree's and to the unsharded kernel, one shard of
    8 and each count's sum timed in turns."""
    builds = {}
    for spec in specs:
        name, src = spec.split("=", 1)
        sources = [pathlib.Path(src) / "atrous.cu",
                   pathlib.Path(src) / "reproject.cu"]
        own = "ptdn_atrous_shard" in sources[0].read_text()
        entry = "ptdn_atrous_shard" if own else "ptdn_atrous_level"
        c_entries, c_own, rows_entry = c_variant(name, sources)
        lib, _ = _lib.build_variant(f"shard-{name}", sources, {
            entry: _lib.ENTRIES[entry], **c_entries})
        lib.rows_entry = rows_entry
        builds[name] = (lib, own, c_own)
    r, st, rad, gb = fourth_frame()
    h, w = rad.shape[:2]
    out = {}
    modes = c_modes(st, rad, gb)
    for mode, (args, band) in modes.items():
        kernel = (C._back_projection_banded_kernel if band
                  else C._back_projection_stencil_kernel)
        whole = kernel(*args, *(band or ()))
        fns = {"unsharded": functools.partial(kernel, *args, *(band or ()))}
        starts = None if band is None else band[0].tolist()
        if band:
            # the whole image through the shard kernel: rows (0, h), no
            # halo (the unsharded stencil mode's launch)
            one = whole_shard(args, band)
            if not all(torch.equal(a, b) for a, b in zip(one(), whole)):
                raise RuntimeError("C's band shard kernel on the whole "
                                   "image: not the unsharded kernel's")
            fns["the shard kernel on the whole image"] = one
        for n in SHARD_COUNTS:
            calls = back_projection_shards(args, n, starts)[0]
            # an older tree's form: the window's planes, made outside
            # the timing
            windows = []
            for sargs, kw in calls:
                wargs, wrows = C.shard_window(sargs[:10], kw["rows"],
                                              kw["halo"])
                wargs = tuple({k: v.contiguous() for k, v in a.items()}
                              if isinstance(a, dict) else
                              a.contiguous() if torch.is_tensor(a) else a
                              for a in wargs)
                windows.append((wargs, wrows))

            def each(lib, c_own, calls=calls, windows=windows):
                if lib is None or c_own:
                    return [_lib.with_lib(lib, lambda a=a, kw=kw: kernel(
                        *a, **kw)) for a, kw in calls]
                return [older_c(lib, mode, wa, band, wr)
                        for wa, wr in windows]
            runs = {"this tree": (None, True), **{
                k: (lib, c_own) for k, (lib, _, c_own) in builds.items()}}
            for name, (lib, c_own) in runs.items():
                got = each(lib, c_own)
                for i in range(4):
                    if not torch.equal(torch.cat([g[i] for g in got]),
                                       whole[i]):
                        raise RuntimeError(f"C's shard mode, {name}, {mode}, "
                                           f"{n} shards: not the unsharded "
                                           f"kernel's rows")
                fns[f"{name} {n} shards"] = functools.partial(each, lib,
                                                              c_own)
                if n == 8:
                    fns[f"{name} one shard of 8"] = functools.partial(
                        each, lib, c_own, calls[1:2], windows[1:2])
        out[mode] = in_turns(fns, reps)
    var, color = C._back_projection_stencil_kernel(
        *modes["back_projection_stencil"][0])[:2]
    static = D.pack_static_planes(gb["position"], gb["normal"])
    albedo = (gb["albedo"] * gb["ialbedo"]).contiguous()
    for level in range(1, 6):
        alb = albedo if level == 5 else None
        whole = D._atrous_level_kernel(color, var, static, alb, level, 0.45,
                                       0.2, 0.35, True)
        fns = {"unsharded": lambda: D._atrous_level_kernel(
            color, var, static, alb, level, 0.45, 0.2, 0.35, True)}
        for n in SHARD_COUNTS:
            calls = shard_calls(color, var, static, alb, level, n, h)

            def each(lib, own, calls=calls):
                if lib is None or own:
                    return [_lib.with_lib(lib, lambda c=c: (
                        D._atrous_level_kernel(*c))) for c, _ in calls]
                return [extended_shard(lib, c, e) for c, e in calls]
            runs = {"this tree": (None, True), **{
                k: (lib, own) for k, (lib, own, _) in builds.items()}}
            for name, (lib, own) in runs.items():
                got = each(lib, own)
                for i in (0, 1):
                    if not torch.equal(torch.cat([g[i] for g in got]),
                                       whole[i]):
                        raise RuntimeError(f"D's shard mode, {name}, level "
                                           f"{level}, {n} shards: not the "
                                           f"unsharded level's rows")
                fns[f"{name} {n} shards"] = functools.partial(each, lib,
                                                              own)
                if n == 8:
                    fns[f"{name} one shard of 8"] = functools.partial(
                        each, lib, own, calls[1:2])
        out[f"atrous_level {level}"] = in_turns(fns, reps)
        color, var = whole
    return out


def entries(ptx: str):
    """entry name -> its PTX body, nvcc's path hash taken out of names."""
    ptx = re.sub(r"_(INTERNAL|GLOBAL__N_)_[0-9a-f]+_", r"_\1_", ptx)
    return {m.group(1): m.group(0) for m in re.finditer(
        r"\.entry (\w+)\((?:.|\n)*?\n}\n", ptx)}


def ptx_diff(other):
    """Every source of csrc/ but P's, O's and N's, here and in `other` (a
    csrc copy), to PTX: (entries compared, the names that differ, the
    sources `other` lacks, the entries of the shared sources that only
    this tree has)."""
    here = _lib.CSRC
    header = A.geom_info(Scene(scene_path("cornell")), "cuda").path_scene
    srcs = [p.relative_to(here) for p in sorted(here.glob("*.cu"))
            if p.name not in SOURCES] + sorted(
        p.relative_to(here) for p in (here / "scene").glob("*.cu"))
    new = [s for s in srcs if not (pathlib.Path(other) / s).exists()]
    srcs = [s for s in srcs if s not in new]
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
    n, differ, added = 0, [], []
    for src, a, b in zip(srcs, mine, theirs):
        added += [f"{src}:{name}" for name in sorted(set(a) - set(b))]
        for name in sorted(set(b)):
            n += 1
            if a.get(name) != b[name]:
                differ.append(f"{src}:{name}")
    return n, differ, [str(s) for s in new], added


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
    ap.add_argument("--dc", metavar="DIR",
                    help="D, C and L beside DIR's copy, equal and timed")
    ap.add_argument("--shard", action="append", default=[],
                    metavar="NAME=DIR",
                    help="D's and C's shard modes beside DIR's, equal and "
                         "timed")
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
    for k, run in (("P", run_p), ("O", run_o), ("N", run_n)):
        res[k] = run(builds, args.reps)
    res["empty_launch_ms_after"] = cuda_ms(lambda: torch.cuda._sleep(0),
                                           reps=args.reps, hide_host=True)
    for label, m in res["P"].items():
        print(f"P {label} ({m['hits']} mesh hits): " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in m["ms"].items())
              + f" ms; bound {m['bound_512'][0]:.4f} ms ({m['bound_512'][1]}"
              f", {m['tests_512']} tests of the 512-ray block cull), "
              f"{m['bound_warp'][0]:.4f} ms ({m['tests_warp']} of the warp "
              f"cull); plain {m['plain_ms']:.4f} ms [{card}]")
    for label, m in res["O"].items():
        print(f"O {label}, tiles {m['plan']}: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in m["ms"].items())
              + f" ms; bound {m['bound'][0]:.4f} ms ({m['bound'][1]}); "
              f"plain {m['plain_ms']:.4f} ms [{card}]")
    for label, m in res["N"].items():
        print(f"N {label}: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in m["ms"].items())
              + f" ms; bound {m['bound'][0]:.4f} ms ({m['bound'][1]}); "
              f"torch.take {m['take_ms']:.4f} ms [{card}]")
    print(f"empty launch {res['empty_launch_ms']:.4f}, "
          f"{res['empty_launch_ms_after']:.4f} ms [{card}]")
    if args.ptx:
        n, differ, new, added = ptx_diff(args.ptx)
        res["ptx"] = {"entries": n, "differ": differ, "new": new,
                      "added": added}
        print(f"PTX of every other kernel against {args.ptx}: {n} entries, "
              f"{len(differ)} differ" + "".join(f"; {d}" for d in differ)
              + f"; sources new here: {new}; entries new here: {added}")
    if args.dc:
        res["dc"] = run_dc(args.dc, args.reps)
        for k, v in res["dc"].items():
            print(f"{k} (cornell 800x800, unsharded), equal bit for bit: "
                  + "; ".join(f"{b} {', '.join(f'{t:.4f}' for t in ms)}"
                              for b, ms in v.items()) + f" ms [{card}]")
    if args.shard:
        res["shard"] = run_shard(args.shard, args.reps)
        for k, v in res["shard"].items():
            print(f"{k} shard mode (cornell 800x800), equal bit for bit: "
                  + "; ".join(f"{b} {', '.join(f'{t:.4f}' for t in ms)}"
                              for b, ms in v.items()) + f" ms [{card}]")
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
