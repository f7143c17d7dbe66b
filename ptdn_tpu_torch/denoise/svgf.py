"""SVGF: the reference's denoise() host routine (src/denoise.cu:349-402)
as a module whose registered buffers hold the temporal history.

* temporal on  -> back-projection (kernel C for a static camera, its band
  mode for any other motion), then color history <- accumulated color;
  the choice of branch reads the reprojected motion back to the host
  (motion_bounds, with the band starts), which happens only when the
  camera moved this frame or the one before (the choice's inputs, the
  primary-hit G-buffer and the last frame's view, change with the camera
  alone);
* with fuse_reproject_l1, where its gate allows, the back-projection and
  the à-trous level 1 run as one kernel L for a static camera, and as
  C's band mode then D at level 1 otherwise; level 1's output is the
  color history;
* temporal off -> EstimateVariance STUB writing 10.0 (denoise.cu:320-329,
  replicated) and color history <- raw input;
* native mode (compat=False, ptdn_tpu/denoise/svgf.py:136-182): with
  temporal on, the pixels whose history is shorter than 4 frames take
  the spatial variance estimate (kernel R, ops/cuda/spatial_variance.py)
  in place of the back-projection's; with temporal off that estimate
  replaces the 10.0 stub on every frame. The fuse_reproject_l1 frame
  applies no such fallback, in native mode too, as in the JAX package
  (its branch, svgf.py:79-135, returns before the native code);
* debug views (history/100, variance/0.1) bypass filtering;
* else à-trous levels 1..nlevel (kernel D), feeding level
  `history_level`'s output back into the color history (SVGF's
  first-iteration-feeds-history trick, denoise.cu:386-392); the
  G-buffer position and normal are packed for them once per camera
  move, and the levels between pass their color and variance on
  packed;
* end of frame: the G-buffer, moments, history length and view matrix
  become the previous frame's.

A shard of a taller image (`rows` = (row0, full_h), parallel/sharded.py)
denoises its own rows, each pixel as the whole image's frame does bit
for bit. The frame is then a generator (SVGFDenoiser.frame_gen) that
yields the exchanges its group fulfils (parallel/mesh.py): the branch
choice's maximum and band sums over the shards (motion_parts), the
previous frame's rows that the back-projection reads past the shard's
own, which it reads in place (the stencil's two when still, the rows
the bands' slabs reach when moved: band_halo, the same on every shard),
native mode's three rows of kernel R's inputs, and the à-trous levels'
halos through the `pyramid` hook (the JAX package's pyramid_override;
parallel/sharded.py: ShardPyramid). fuse_reproject_l1 is off on a
shard, as in the JAX package, whose sharded step runs its denoiser on
the xla backend that the fused kernel's gate excludes
(ptdn_tpu/denoise/svgf.py:62-70).
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ptdn_tpu_torch.denoise.reproject import (BAND_MARGIN, BAND_ROWS,
                                              back_projection_auto,
                                              back_projection_banded,
                                              band_halo, bounds_from_parts,
                                              halo_pack, motion_bounds,
                                              motion_parts)
from ptdn_tpu_torch.denoise.variance import RADIUS
from ptdn_tpu_torch.ops.cuda import reproject as kernel_c
from ptdn_tpu_torch.ops.cuda.atrous import atrous_level, pack_static_planes
from ptdn_tpu_torch.ops.cuda.reproject_atrous import back_projection_atrous1
from ptdn_tpu_torch.ops.cuda.spatial_variance import spatial_variance_fallback
from ptdn_tpu_torch.parallel.mesh import Halo, Reduce

STATE_KEYS = ("color_history", "moment_history", "history_length",
              "prev_position", "prev_normal", "prev_geom_id", "prev_view")


def init_denoise_state(resolution, device) -> Dict[str, torch.Tensor]:
    """denoiseInit equivalents (denoise.cu:31-61), zero-initialized."""
    w, h = resolution
    f = dict(dtype=torch.float32, device=device)
    return {
        "color_history": torch.zeros((h, w, 3), **f),
        "moment_history": torch.zeros((h, w, 2), **f),
        "history_length": torch.zeros((h, w), dtype=torch.int32,
                                      device=device),
        "prev_position": torch.zeros((h, w, 3), **f),
        "prev_normal": torch.zeros((h, w, 3), **f),
        "prev_geom_id": torch.full((h, w), -1, dtype=torch.int32,
                                   device=device),
        "prev_view": torch.eye(4, **f),
    }


def shard_back_projection(bp_args, rows, near: bool, starts, k: int):
    """A shard's back-projection call, as its denoiser makes it (a
    generator: yields the Halo exchange). `bp_args` are kernel C's
    arguments (res, ..., moment_alpha_min) over the shard's rows, its
    previous frame's its own rows as they lie; the k rows of the
    neighbours' that its taps reach (two when near, band_halo's when
    moved) come packed (halo_pack) through a Halo. Returns (kernel C's
    wrapper of the branch (ops/cuda/reproject.py), positional arguments
    (band mode's ending in the image's `starts` on the host, the band
    rows and margin), keywords)."""
    _, _, _, prev_gb, _, ch, mh, hl = bp_args[:8]
    halo = yield Halo(halo_pack(ch, mh, hl, prev_gb["normal"],
                                prev_gb["geom_id"], k), k, split=True)
    kw = {"rows": rows, "halo": halo}
    if near:
        return kernel_c.back_projection_stencil, bp_args, kw
    return (kernel_c.back_projection_banded,
            bp_args + (starts, BAND_ROWS, BAND_MARGIN), kw)


def run_alone(gen):
    """The value of a frame generator that asks for no exchange (the
    whole image's frame)."""
    try:
        req = next(gen)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"the whole image's frame asked for {req!r}")


def hook_value(x):
    """A hook's result (a generator's value, its exchanges passed on to
    the group, or the value itself); use with ``yield from``."""
    if inspect.isgenerator(x):
        x = yield from x
    return x


class Pyramid:
    """The à-trous levels of a frame (kernel D) and the G-buffer planes
    they read: the whole image's. A shard's takes its place through
    SVGFDenoiser's `pyramid` (parallel/sharded.py:ShardPyramid, whose
    methods are generators that yield their halos)."""

    def pack(self, position, normal):
        """The planes every level reads, packed once per camera move."""
        return pack_static_planes(position, normal)

    def __call__(self, src, var, static, albedo, sig, cfg, first: int):
        """Levels first..nlevel from color `src` and variance `var`, the
        last one remodulated by `albedo` (or None). Returns (output,
        the output of level history_level, or None if it did not run)."""
        history = None
        for level in range(first, cfg.atrous_nlevel + 1):
            last = level == cfg.atrous_nlevel
            keep = level == cfg.history_level
            # the color history and the output keep the JAX layout
            src, var = atrous_level(
                src, var, static, albedo if last else None, level, *sig,
                cfg.blur_variance, pack_out=not (last or keep))
            if keep:
                history = src
        return src, history


class SVGFDenoiser(nn.Module):
    """forward(raw (H, W, 3), gbuffer of (H, W, ...), view_mat (4, 4),
    params, cam_changed) -> filtered (H, W, 3); the history buffers
    advance. cam_changed says whether the camera (so the G-buffer and the
    view) changed since the last frame. A shard (`rows` = (row0, full_h):
    its H rows are image rows row0.. of a full_h-row image) runs
    frame_gen(), the same frame as a generator of exchanges; `pyramid`
    replaces the à-trous levels (Pyramid)."""

    def __init__(self, cfg, resolution: Tuple[int, int], device,
                 rows: Optional[Tuple[int, int]] = None,
                 pyramid: Optional[Pyramid] = None):
        super().__init__()
        self.cfg = cfg
        self.resolution = tuple(resolution)
        self.rows = rows
        self.pyramid = pyramid or Pyramid()
        # the JAX package's gate of the fused reprojection + level 1
        # (ptdn_tpu/denoise/svgf.py:62-79), term for term: level 1 is not
        # the last level (no albedo inside), its output is the new color
        # history, no debug view bypasses the filter. Its backend term is
        # the pallas backend, whose kernels the port's are. w <= 1024 is
        # a TPU limit there (wider compiles took the TPU worker down); it
        # stays here so that the port takes the same path as the JAX
        # package on the same config.
        self.fuse_l1 = (cfg.fuse_reproject_l1 and rows is None
                        and cfg.temporal_enable
                        and cfg.spatial_enable and cfg.atrous_nlevel >= 2
                        and cfg.history_level == 1
                        and cfg.right_view_option == 0
                        and self.resolution[0] <= 1024)
        for k, v in init_denoise_state(resolution, device).items():
            self.register_buffer(k, v)
        self.forget_motion()

    def forget_motion(self):
        """Drop the kept branch choice and packed G-buffer (the history
        was replaced)."""
        self.near, self.starts, self.moved = None, None, True
        self.static = None
        # a shard's: the band starts on the host and the halo rows of its
        # back-projection on a moved frame (band_halo)
        self.band_starts, self.moved_halo = None, None

    def _motion(self, gbuffer, cam_changed):
        """The near/far choice and band starts (motion_bounds), read on
        the host in one read only when the camera moved this frame or the
        last; a shard's are reduced over the image first, and its
        band-mode halo computed from the starts read."""
        if cam_changed or self.moved or self.near is None:
            if self.rows is None:
                bounds = motion_bounds(self.resolution, gbuffer,
                                       self.prev_view)
            else:
                row0, full_h = self.rows
                reach, total, cnt = motion_parts(
                    self.resolution, gbuffer, self.prev_view, BAND_ROWS,
                    row0, full_h)
                reach = yield Reduce(reach, "max")
                sums = yield Reduce(torch.stack([total, cnt]), "sum")
                bounds = bounds_from_parts(reach, sums[0], sums[1], full_h)
            near, *starts = bounds.tolist()
            self.near, self.starts = bool(near), bounds[1:]
            if self.rows is not None:
                self.band_starts = starts
                self.moved_halo = band_halo(starts, self.resolution[1],
                                            self.rows[1])
        self.moved = cam_changed

    def bp_args(self, raw, gbuffer, params):
        """Kernel C's arguments for the frame of `raw` and `gbuffer`
        against the history and the previous frame held."""
        prev_gb = {"position": self.prev_position,
                   "normal": self.prev_normal,
                   "geom_id": self.prev_geom_id}
        return (self.resolution, raw, gbuffer, prev_gb, self.prev_view,
                self.color_history, self.moment_history,
                self.history_length, params["color_alpha"],
                params["moment_alpha"])

    def back_projection(self, bp_args):
        """back_projection_auto, as a generator; a shard's reads its own
        previous rows in place and the rows its taps reach past them from
        its neighbours (shard_back_projection): two when still (C's
        stencil), the rows its bands' slabs reach when moved (C's band
        mode, band_halo)."""
        if self.rows is None:
            return back_projection_auto(*bp_args, near=self.near,
                                        starts=self.starts)
        fn, args, kw = yield from shard_back_projection(
            bp_args, self.rows, self.near, self.band_starts,
            2 if self.near else self.moved_halo)
        return fn(*args, **kw)

    def _spatial(self, color, gbuffer, params, history=None, variance=None):
        """Native mode's variance (kernel R, spatial_variance_fallback).
        A shard's runs on its rows extended by the image's RADIUS rows
        around them, none past the image, where R's masks are the
        image's, and keeps its own."""
        sig = (params["sigma_n"], params["sigma_x"])
        temporal = () if history is None else (history, variance)
        if self.rows is None:
            return spatial_variance_fallback(color, gbuffer, *sig, *temporal)
        row0, full_h = self.rows
        h = color.shape[0]
        planes = [color, gbuffer["position"], gbuffer["normal"]]
        if temporal:
            planes += [history.to(torch.float32)[..., None],
                       variance[..., None]]
        ext = yield Halo(torch.cat(planes, dim=-1), RADIUS)
        top, bottom = min(RADIUS, row0), min(RADIUS, full_h - row0 - h)
        ext = ext[RADIUS - top:RADIUS + h + bottom]
        gb = {"position": ext[..., 3:6], "normal": ext[..., 6:9]}
        if temporal:
            temporal = (ext[..., 9].to(torch.int32),
                        ext[..., 10].contiguous())
        out = spatial_variance_fallback(ext[..., 0:3], gb, *sig, *temporal)
        return out[top:top + h]

    def forward(self, raw: torch.Tensor, gbuffer: Dict[str, torch.Tensor],
                view_mat: torch.Tensor, params,
                cam_changed: bool = True) -> torch.Tensor:
        return run_alone(self.frame_gen(raw, gbuffer, view_mat, params,
                                    cam_changed))

    def frame_gen(self, raw, gbuffer, view_mat, params, cam_changed=True):
        """forward as a generator of exchanges (a shard's), returning the
        filtered rows."""
        cfg = self.cfg
        w, h = self.resolution
        sig = (params["sigma_l"], params["sigma_n"], params["sigma_x"])
        bp_args = self.bp_args(raw, gbuffer, params)
        first = 1       # the first à-trous level left to run
        filtering = (cfg.right_view_option not in (1, 2)
                     and cfg.spatial_enable and cfg.atrous_nlevel > 0)
        if filtering and (cam_changed or self.static is None):
            # like the branch choice's inputs, the G-buffer changes with
            # the camera alone: packed again only when it moved
            self.static = yield from hook_value(self.pyramid.pack(
                gbuffer["position"], gbuffer["normal"]))
        static = self.static
        if self.fuse_l1:
            # the fuse_reproject_l1 frame (ptdn_tpu/denoise/svgf.py:80-135):
            # kernel L where the motion is near, else C's band mode then D
            # at level 1; level 1's output is the color history. No
            # spatial fallback in native mode: the JAX branch has none
            yield from self._motion(gbuffer, cam_changed)
            if self.near:
                color_history, variance, moment_acc, hist_up = (
                    back_projection_atrous1(*bp_args, *sig,
                                            cfg.blur_variance, static))
            else:
                var0, acc, moment_acc, hist_up = back_projection_banded(
                    *bp_args, starts=self.starts)
                color_history, variance = atrous_level(
                    acc, var0, static, None, 1, *sig, cfg.blur_variance)
            first = 2
        elif cfg.temporal_enable:
            yield from self._motion(gbuffer, cam_changed)
            variance, color_acc, moment_acc, hist_up = (
                yield from self.back_projection(bp_args))
            color_history = color_acc
            if not cfg.compat:
                # native mode: a history under 4 frames takes the spatial
                # estimate (kernel R; svgf.py:156-168)
                variance = yield from self._spatial(
                    color_acc, gbuffer, params, hist_up, variance)
        else:
            color_history = raw
            moment_acc = self.moment_history
            hist_up = self.history_length
            if cfg.compat:
                # EstimateVariance stub = 10.0 (denoise.cu:320-329)
                variance = torch.full((h, w), 10.0, device=raw.device)
            else:
                # native mode: the stub replaced by the spatial estimate
                # on every pixel (kernel R; svgf.py:176-182)
                variance = yield from self._spatial(raw, gbuffer, params)

        if cfg.right_view_option == 1:
            output = (hist_up.to(torch.float32) / 100.0)[..., None].expand(
                h, w, 3)
        elif cfg.right_view_option == 2:
            output = (variance / 0.1)[..., None].expand(h, w, 3)
        elif not filtering:
            output = color_history
        else:
            albedo = None
            if cfg.sep_color and cfg.add_color:
                albedo = (gbuffer["albedo"] * gbuffer["ialbedo"]).contiguous()
            output, history = yield from hook_value(self.pyramid(
                color_history, variance, static, albedo, sig, cfg, first))
            if history is not None:
                color_history = history

        self.color_history = color_history
        self.moment_history = moment_acc
        self.history_length = hist_up
        self.prev_position = gbuffer["position"]
        self.prev_normal = gbuffer["normal"]
        self.prev_geom_id = gbuffer["geom_id"]
        self.prev_view = view_mat
        return output
