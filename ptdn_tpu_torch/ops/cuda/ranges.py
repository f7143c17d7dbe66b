"""Kernel Q (ranges_and_key): the sorted wavefront's crossed-chunk ranges
and coherence sort key (csrc/ranges.cu), with its plain PyTorch version.

Replaces XLA code of the JAX package, not a Pallas kernel:
ptdn_tpu/engine/wavefront.py:ranges_and_key (:617) with the
chunk_range_planes (:522) it calls twice, glue that runs once per bounce
of the sorted wavefront between kernels E and F. The plain version is
that code in PyTorch, one (..., C) batch over every chunk box; it costs
hundreds of launches a call (the (…, 7) bit tensors of the morton key,
the correctly rounded multiply-adds of the shadow-range limit), so the
sorted frame was host-bound in it. The kernel runs one thread per lane
(see csrc/ranges.cu). The JAX code concatenates E's planes with the
ranges and the pixel plane into F's input, which XLA fuses into E's
output on the TPU; on the card that copy was 90% of Q's bytes, so E
writes its planes into the first 21 planes of the bounce's buffer
(shade_bounce(out=...)) and Q fills the rest in place.

edge_inputs(seed) makes the edge cases that the CPU tests hold the plain
version to against the JAX package and chip_smoke.py holds the kernel
to against the plain version.
"""

from __future__ import annotations

import ctypes
import types

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.shade import (N_OUT, O_ACT, O_DX, O_DY, O_DZ,
                                           O_NEE, O_SDX, O_SDY, O_SDZ,
                                           O_SPX, O_SPY, O_SPZ)
from ptdn_tpu_torch.ops.fp import dot3, sqrt

SENTINEL = 1 << 30      # the sort key of a dead lane, past every live one
MAX_RANGE_SLABS = 64    # chunk AABB tests per ray before supergroups
# the planes of allp (F's input and the pixel plane): E's, then the ranges
# and the pixel plane, which Q writes
N_ALLP = N_OUT + 5
# boxes under one union box in the kernel's pre-test (csrc/ranges.cu)
BOX_GROUP = 8


class RangeArgs(ctypes.Structure):
    """Mirror of csrc/ranges.cu:RangeArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("sh", "pix", "boxes",
                                                "allp", "key")]
                + [(k, ctypes.c_int) for k in (
                    "n", "n_boxes", "group", "n_chunks", "do_vis",
                    "has_limit")]
                + [(k, ctypes.c_float) for k in ("lx", "ly", "lz",
                                                 "lrad")])


def range_group(n_chunks: int) -> int:
    """Chunks a box of the range test covers: 1 up to 64 chunks, past
    that G = max(2, ceil(n / 64)) consecutive chunks (a supergroup)."""
    if n_chunks <= MAX_RANGE_SLABS:
        return 1
    return max(2, -(-n_chunks // MAX_RANGE_SLABS))


def range_box_planes(ds, n_chunks: int):
    """(bmin, bmax), each (S, 3): the boxes the range test runs on, the
    n_chunks chunk AABBs, or past 64 chunks the union AABBs of each
    supergroup of range_group(n_chunks) consecutive chunks, the last
    padded with empty boxes (min +inf, max -inf, crossed by nothing)."""
    cmin = ds.tri_chunk_min[:n_chunks]
    cmax = ds.tri_chunk_max[:n_chunks]
    g = range_group(n_chunks)
    if g == 1:
        return cmin, cmax
    n_super = -(-n_chunks // g)
    pad = n_super * g - n_chunks
    inf = torch.full((pad, 3), float("inf"), device=cmin.device)
    return (torch.cat([cmin, inf]).reshape(n_super, g, 3).amin(dim=1),
            torch.cat([cmax, -inf]).reshape(n_super, g, 3).amax(dim=1))


def range_boxes(ds, n_chunks: int) -> torch.Tensor:
    """Kernel Q's box table, (S, 6) float32 (lo xyz, hi xyz per box) on
    ds's device: range_box_planes' boxes. A function of the scene alone:
    PathTracer holds it as a buffer."""
    bmin, bmax = range_box_planes(ds, n_chunks)
    return torch.cat([bmin, bmax], dim=1).to(torch.float32).contiguous()


def range_group_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """The union boxes of kernel Q's pre-test, (ceil(S / 8), 6), as the
    kernel computes them in shared memory: for every BOX_GROUP
    consecutive boxes of `boxes` (range_boxes' table) per axis the least
    of their lo and hi and the greatest (torch.fmin / fmax drop a NaN
    coordinate, as fminf / fmaxf do)."""
    s = boxes.shape[0]
    ng = -(-s // BOX_GROUP)
    pad = torch.full((ng * BOX_GROUP - s, 6), float("nan"),
                     device=boxes.device)
    b = torch.cat([boxes, pad]).reshape(ng, BOX_GROUP, 2, 3)
    lo = torch.fmin(b[:, :, 0], b[:, :, 1])
    hi = torch.fmax(b[:, :, 0], b[:, :, 1])
    inf = torch.tensor(float("inf"), device=boxes.device)
    lo = torch.where(lo.isnan(), inf, lo).amin(dim=1)
    hi = torch.where(hi.isnan(), -inf, hi).amax(dim=1)
    return torch.cat([lo, hi], dim=1)


def lane_counts(sh: torch.Tensor):
    """(lanes, live, nee) of E's planes `sh` (or an allp whose first 21
    they are): every lane, the live lanes, and the live lanes that carry
    a shadow ray."""
    alive = sh[O_ACT] > 0.5
    return (sh[O_ACT].numel(), int(alive.sum()),
            int((alive & (sh[O_NEE] > 0.5)).sum()))


def traffic(sh: torch.Tensor) -> int:
    """The bytes kernel Q must move on E's planes `sh`, 4 B a plane: on
    every lane the live flag and the pixel plane read, the four range
    planes, the pixel plane and the key written; on a live lane also the
    NEE flag, the origin and the next direction read; on a lane with a
    shadow ray also its direction (csrc/ranges.cu reads no more)."""
    lanes, live, nee = lane_counts(sh)
    return 4 * (8 * lanes + 7 * live + 3 * nee)


def box_tests(sh: torch.Tensor, n_boxes: int) -> int:
    """The box tests kernel Q makes on E's planes `sh`: every box for each
    live lane's next ray and, where the lane carries one, its shadow
    ray."""
    _, live, nee = lane_counts(sh)
    return (live + nee) * n_boxes


def chunk_range_planes(ds, o, d, n_chunks: int, t_limit=None):
    """Per lane the [lo, hi] chunk ids bounding every chunk AABB the ray
    o + t d crosses (t >= 0, and tmin <= t_limit where given), (n_chunks,
    -1) where it crosses none (wavefront.py:522-598). The slab is the
    kernels' own (subtract, then multiply by 1/d), so a chunk outside the
    range is one the kernels' per-lane cull skips. Past 64 chunks the test
    runs on supergroups of G = ceil(n / 64) consecutive chunks (their
    union AABBs) and the range rounds out to whole groups, still a
    superset. All chunks are tested at once as an (..., C) batch."""
    shape = torch.broadcast_shapes(o[0].shape, d[0].shape)
    dev = o[0].device
    inv = tuple(1.0 / c for c in d)

    def slab_ranges(bmin, bmax, count):
        if count == 0:
            return (torch.zeros(shape, dtype=torch.int32, device=dev),
                    torch.full(shape, -1, dtype=torch.int32, device=dev))
        t0 = [(bmin[:, k] - o[k][..., None]) * inv[k][..., None]
              for k in range(3)]
        t1 = [(bmax[:, k] - o[k][..., None]) * inv[k][..., None]
              for k in range(3)]
        tmin = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                           torch.minimum(t0[1], t1[1])),
                             torch.minimum(t0[2], t1[2]))
        tmax = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        crossed = (tmax >= 0.0) & (tmin <= tmax)
        if t_limit is not None:
            # a box entered beyond t_limit cannot occlude (shadow rays)
            crossed = crossed & (tmin <= t_limit[..., None])
        iota = torch.arange(count, dtype=torch.int32, device=dev)
        lo = torch.where(crossed, iota, count).amin(dim=-1)
        hi = torch.where(crossed, iota, -1).amax(dim=-1)
        return lo.to(torch.int32), hi.to(torch.int32)

    bmin, bmax = range_box_planes(ds, n_chunks)
    g = range_group(n_chunks)
    if g == 1:
        return slab_ranges(bmin, bmax, n_chunks)
    slo, shi = slab_ranges(bmin, bmax, bmin.shape[0])
    lo = torch.clamp_max(slo * g, n_chunks)
    hi = torch.where(shi < 0, -1, torch.clamp_max(shi * g + (g - 1),
                                                  n_chunks - 1))
    return lo.to(torch.int32), hi.to(torch.int32)


def _interleave7(a, b, n_chunks: int):
    """Morton interleave of two chunk ids squeezed into 7 bits each (a
    monotone squeeze past 127 chunks, so the top of a large scene does
    not fold into one bucket): a's bits odd, b's even."""
    def to7(x):
        if n_chunks > 127:
            x = x * 127 // n_chunks
        return torch.clamp(x, 0, 127)[..., None]
    bit = torch.arange(7, dtype=torch.int32, device=a.device)
    # the bits never overlap, so their sum is their OR
    return ((((to7(a) >> bit) & 1) << (2 * bit + 1))
            + (((to7(b) >> bit) & 1) << (2 * bit))).sum(-1, dtype=torch.int32)


def ranges_and_key_plain(ds, sh: torch.Tensor, pix: torch.Tensor,
                         n_chunks: int, do_vis: bool, light_pos=None,
                         light_radius=None):
    """Plain PyTorch version of kernel Q (see ranges_and_key): returns a
    new allp and the key; `sh` is E's planes or an allp whose first
    N_OUT planes they are."""
    sh = sh[:N_OUT]
    sp = (sh[O_SPX], sh[O_SPY], sh[O_SPZ])
    no_limit = torch.full_like(sp[0], float("inf"))
    s_limit = no_limit
    if light_pos is not None:
        e = tuple(light_pos[k] - sp[k] for k in range(3))
        s_limit = sqrt(dot3(e, e)) + light_radius
    d = tuple(sh[[a, b]] for a, b in ((O_DX, O_SDX), (O_DY, O_SDY),
                                      (O_DZ, O_SDZ)))
    lo, hi = chunk_range_planes(ds, sp, d, n_chunks,
                                t_limit=torch.stack([no_limit, s_limit]))
    # dead lanes and lanes without a shadow ray: empty ranges
    alive = sh[O_ACT] > 0.5
    keep = torch.stack([alive, alive & (sh[O_NEE] > 0.5)])
    lo = torch.where(keep, lo, n_chunks)
    hi = torch.where(keep, hi, -1)
    (nlo, slo), (nhi, shi) = lo, hi
    if do_vis:
        key = (_interleave7(nlo, slo, n_chunks) * 16384
               + _interleave7(torch.clamp_min(nhi, 0),
                              torch.clamp_min(shi, 0), n_chunks))
    else:
        key = nlo * (n_chunks + 1) + torch.clamp_min(nhi, 0)
    key = torch.where(keep[0], key, SENTINEL).to(torch.int32)
    ranges = torch.stack([nlo, nhi, slo, shi]).to(torch.float32)
    return torch.cat([sh, ranges, pix[None]]), key.reshape(-1)


def ranges_and_key(ds, allp: torch.Tensor, pix: torch.Tensor,
                   n_chunks: int, do_vis: bool, light_pos=None,
                   light_radius=None, boxes=None):
    """Crossed-chunk ranges and the coherence sort key of the shaded
    wavefront (wavefront.py:617-704), in place: `allp` is the bounce's
    (26, NB, 128) buffer, whose first 21 planes E wrote
    (shade_bounce(out=allp[:21])); its planes 21..25 are filled. pix:
    the (NB, 128) pixel plane. Returns (allp, key): allp = E's planes,
    nlo, nhi, slo, shi (as float32), pix — F's input plus the pixel
    plane — and key (N,) int32. The shadow range is bounded by the
    distance to the light center `light_pos` (float32 values) plus
    `light_radius` (the light AABB's half diagonal); lanes without a
    shadow ray and dead lanes get empty ranges, and dead lanes the key
    SENTINEL so whole tiles go idle. With do_vis the key interleaves
    (nlo, slo) over (nhi, shi) (the morton key), else it is nlo * (C + 1)
    + nhi. The next and the shadow ray of a lane share their origin, so
    one pass finds both ranges (no limit is an infinite one). CPU tensors
    take the plain version; CUDA tensors launch kernel Q, on `boxes`
    (range_boxes(ds, n_chunks), which a CUDA call must give)."""
    _lib.require(allp.device, "ranges_and_key")
    if allp.shape[0] != N_ALLP:
        raise ValueError(f"ranges_and_key fills a {N_ALLP}-plane allp, got "
                         f"{tuple(allp.shape)}")
    if allp.device.type == "cpu":
        planes, key = ranges_and_key_plain(ds, allp, pix, n_chunks, do_vis,
                                           light_pos, light_radius)
        allp[N_OUT:] = planes[N_OUT:]
        return allp, key
    if boxes is None:
        raise ValueError("ranges_and_key on the card needs boxes: "
                         "range_boxes(ds, n_chunks)")
    return _ranges_and_key_kernel(boxes, allp, pix, n_chunks, do_vis,
                                  light_pos, light_radius)


def range_args(boxes, sh, pix, allp, key, n_chunks, do_vis, light_pos=None,
               light_radius=None) -> RangeArgs:
    """Kernel Q's arguments: E's planes `sh` (allp's first 21; an older
    tree's kernel copied a buffer of their own into allp), the pixel
    plane, the box table and the outputs."""
    lp = [0.0] * 3 if light_pos is None else [float(x) for x in light_pos]
    g = range_group(n_chunks)
    p = _lib.ptr
    return RangeArgs(sh=p(sh), pix=p(pix), boxes=p(boxes), allp=p(allp),
                     key=p(key), n=key.numel(), n_boxes=-(-n_chunks // g),
                     group=g, n_chunks=n_chunks, do_vis=int(bool(do_vis)),
                     has_limit=int(light_pos is not None), lx=lp[0],
                     ly=lp[1], lz=lp[2],
                     lrad=0.0 if light_pos is None else float(light_radius))


def _ranges_and_key_kernel(boxes, allp, pix, n_chunks, do_vis,
                           light_pos=None, light_radius=None):
    nb = allp.shape[1]
    g = range_group(n_chunks)
    _lib.check_tensor(pix, torch.float32, (nb, 128), "pix")
    _lib.check_tensor(boxes, torch.float32, (-(-n_chunks // g), 6), "boxes")
    _lib.check_tensor(allp, torch.float32, (N_ALLP, nb, 128), "allp")
    key = torch.empty(nb * 128, dtype=torch.int32, device=allp.device)
    _lib.launch("ptdn_ranges_and_key",
                range_args(boxes, allp, pix, allp, key, n_chunks, do_vis,
                           light_pos, light_radius))
    ranges_and_key.launches += 1
    return allp, key


ranges_and_key.launches = 0


# ---------------------------------------------------------------------------
# edge inputs, shared by tests/test_torch_ranges.py and chip_smoke.py

def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).T


def chunk_table(r, count: int):
    """(cmin, cmax) (count, 3) float32: `count` random boxes in the cube
    [-5, 5]^3, each 0.2 to 3 wide, with two tested boxes flat (zero width
    on one axis, as a chunk of a floor or a wall is: a ray in their plane
    meets 0 * inf on both faces): the first range_group(count) chunks in
    one plane y = const, and the group in the middle in one plane x =
    const."""
    lo = r.uniform(-5.0, 4.0, size=(count, 3))
    hi = lo + r.uniform(0.2, 3.0, size=(count, 3))
    g = range_group(count)
    mid = (count // 2) // g * g
    lo[:g, 1] = hi[:g, 1] = lo[0, 1]
    lo[mid:mid + g, 0] = hi[mid:mid + g, 0] = lo[mid, 0]
    return lo.astype(np.float32), hi.astype(np.float32)


def edge_inputs(seed: int = 0, n: int = 4096):
    """label -> dict(cmin, cmax, sh, pix, n_chunks, do_vis, light_pos,
    light_radius), numpy float32 arrays (sh (21, n / 128, 128), pix (n /
    128, 128)), for kernel Q and its plain version, and for the JAX
    package's ranges_and_key (both read only tri_chunk_min and
    tri_chunk_max of the scene: chunk_scene wraps cmin and cmax). Chunk
    tables of 64 boxes (the last tested box by box) and 65 (the first in
    supergroups, G = 2), and 233 (terrain30k's count, G = 4). Over the
    lanes: random origins and directions; directions with ±0 components
    and axis-parallel ones; origins on a box face (0 * inf = NaN in the
    slab); NaN and inf planes on dead lanes; live lanes without a shadow
    ray. Cases: the morton key with the light limit, do_vis off, and no
    light limit (light_pos None)."""
    r = np.random.default_rng(seed)
    nb = n // 128
    tables = {c: chunk_table(r, c) for c in (64, 65, 233)}
    out = {}
    for count, (cmin, cmax) in tables.items():
        sh = np.zeros((N_OUT, n), np.float32)
        sh[[O_SPX, O_SPY, O_SPZ]] = r.uniform(-6.0, 6.0, size=(3, n))
        sh[[O_DX, O_DY, O_DZ]] = _unit(r, n)
        sh[[O_SDX, O_SDY, O_SDZ]] = _unit(r, n)
        sh[O_ACT] = r.uniform(size=n) < 0.85
        sh[O_NEE] = r.uniform(size=n) < 0.6
        q = n // 8
        # axis-parallel rays, both directions, through ±0 components
        for lane in range(q):
            ax = lane % 3
            dirs = np.zeros(3, np.float32)
            dirs[ax] = 1.0 if lane % 2 else -1.0
            if lane % 4 < 2:
                dirs[(ax + 1) % 3] = -0.0
            sh[[O_DX, O_DY, O_DZ], lane] = dirs
            sh[[O_SDX, O_SDY, O_SDZ], lane] = dirs[::-1]
        # origins on a face of a tested box (a chunk's, or a supergroup's
        # union), rays along that face or through it: the two flat boxes
        # and the last box most often
        bmin, bmax = (t.numpy() for t in range_box_planes(
            chunk_scene(cmin, cmax), count))
        n_boxes = bmin.shape[0]
        for j, lane in enumerate(range(q, 2 * q)):
            b = (0, n_boxes // 2, n_boxes - 1, j % n_boxes)[j % 4]
            face = (bmin if j % 2 else bmax)[b]
            ax = (j // 2) % 3
            o = r.uniform(bmin[b], bmax[b]).astype(np.float32)
            o[ax] = face[ax]
            sh[[O_SPX, O_SPY, O_SPZ], lane] = o
            if j % 8 < 4:
                sh[O_DX + ax, lane] = 0.0
                sh[O_SDX + ax, lane] = -0.0
        # dead lanes with NaN and inf planes
        dead = np.arange(2 * q, 3 * q)
        sh[O_ACT, dead] = 0.0
        sh[O_SPX, dead[::3]] = np.nan
        sh[O_DY, dead[1::3]] = np.inf
        sh[O_SDZ, dead[2::3]] = -np.inf
        sh[O_ACT, dead[::5]] = np.nan
        # the light 0.75 before the last box in x, level with its centre,
        # its radius that distance: shadow rays along +x from the light's
        # line enter the box at their limit or a rounding off it (the
        # test is tmin <= limit)
        last = n_boxes - 1
        f32 = np.float32
        lp = np.array([bmin[last, 0] - f32(0.75),
                       (bmin[last, 1] + bmax[last, 1]) / f32(2),
                       (bmin[last, 2] + bmax[last, 2]) / f32(2)], f32)
        lrad = bmin[last, 0] - lp[0]
        ties = np.arange(3 * q, 4 * q)
        e0 = r.choice(f32([0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0]), ties.size)
        sh[O_SPX, ties] = lp[0] - e0
        sh[O_SPY, ties], sh[O_SPZ, ties] = lp[1], lp[2]
        sh[O_SDX, ties], sh[O_SDY, ties], sh[O_SDZ, ties] = 1.0, 0.0, -0.0
        sh[O_ACT, ties] = sh[O_NEE, ties] = 1.0
        sh = sh.reshape(N_OUT, nb, 128)
        pix = np.arange(n, dtype=np.float32)[::-1].copy().reshape(nb, 128)
        base = dict(cmin=cmin, cmax=cmax, sh=sh, pix=pix, n_chunks=count)
        out[f"{count} boxes, morton key"] = dict(
            base, do_vis=True, light_pos=lp, light_radius=lrad)
        out[f"{count} boxes, do_vis off"] = dict(
            base, do_vis=False, light_pos=lp, light_radius=lrad)
        out[f"{count} boxes, no light limit"] = dict(
            base, do_vis=True, light_pos=None, light_radius=None)
    return out


def chunk_scene(cmin, cmax, device="cpu"):
    """A stand-in for a DeviceScene that holds only the chunk tables (all
    that ranges_and_key reads of the scene)."""
    return types.SimpleNamespace(
        tri_chunk_min=torch.as_tensor(cmin, device=device),
        tri_chunk_max=torch.as_tensor(cmax, device=device))


def new_allp(sh: torch.Tensor) -> torch.Tensor:
    """A bounce's (26, NB, 128) allp on sh's device with E's (21, NB, 128)
    planes `sh` in its first 21, as E writes them there, and NaN in the
    planes Q fills."""
    allp = torch.full((N_ALLP,) + tuple(sh.shape[1:]), float("nan"),
                      device=sh.device)
    allp[:N_OUT] = sh
    return allp


def edge_call(case, device="cpu"):
    """(ds, allp, pix, n_chunks, do_vis, light_pos, light_radius) of an
    edge_inputs case, as torch tensors on `device` (allp: new_allp of the
    case's planes), light_pos as Python floats."""
    lp = case["light_pos"]
    return (chunk_scene(case["cmin"], case["cmax"], device),
            new_allp(torch.as_tensor(case["sh"], device=device)),
            torch.as_tensor(case["pix"], device=device), case["n_chunks"],
            case["do_vis"], None if lp is None else [float(x) for x in lp],
            None if lp is None else float(case["light_radius"]))
