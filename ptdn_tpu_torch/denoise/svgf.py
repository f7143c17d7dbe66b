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
* debug views (history/100, variance/0.1) bypass filtering;
* else à-trous levels 1..nlevel (kernel D), feeding level
  `history_level`'s output back into the color history (SVGF's
  first-iteration-feeds-history trick, denoise.cu:386-392); the
  G-buffer position and normal are packed for them once per camera
  move, and the levels between pass their color and variance on
  packed;
* end of frame: the G-buffer, moments, history length and view matrix
  become the previous frame's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ptdn_tpu_torch.denoise.reproject import (back_projection_auto,
                                              back_projection_banded,
                                              motion_bounds)
from ptdn_tpu_torch.ops.cuda.atrous import atrous_level, pack_static_planes
from ptdn_tpu_torch.ops.cuda.reproject_atrous import back_projection_atrous1

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


class SVGFDenoiser(nn.Module):
    """forward(raw (H, W, 3), gbuffer of (H, W, ...), view_mat (4, 4),
    params, cam_changed) -> filtered (H, W, 3); the history buffers
    advance. cam_changed says whether the camera (so the G-buffer and the
    view) changed since the last frame."""

    def __init__(self, cfg, resolution: Tuple[int, int], device):
        super().__init__()
        if not cfg.compat:
            raise NotImplementedError("native mode (compat=False) is not "
                                      "ported")
        self.cfg = cfg
        self.resolution = tuple(resolution)
        # the JAX package's gate of the fused reprojection + level 1
        # (ptdn_tpu/denoise/svgf.py:62-79), term for term: level 1 is not
        # the last level (no albedo inside), its output is the new color
        # history, no debug view bypasses the filter. Its backend term is
        # the pallas backend, whose kernels the port's are. w <= 1024 is
        # a TPU limit there (wider compiles took the TPU worker down); it
        # stays here so that the port takes the same path as the JAX
        # package on the same config.
        self.fuse_l1 = (cfg.fuse_reproject_l1 and cfg.temporal_enable
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

    def _motion(self, gbuffer, cam_changed):
        """The near/far choice and band starts (motion_bounds), read on
        the host only when the camera moved this frame or the last."""
        if cam_changed or self.moved or self.near is None:
            bounds = motion_bounds(self.resolution, gbuffer, self.prev_view)
            self.near, self.starts = bool(bounds[0]), bounds[1:]
        self.moved = cam_changed

    def forward(self, raw: torch.Tensor, gbuffer: Dict[str, torch.Tensor],
                view_mat: torch.Tensor, params,
                cam_changed: bool = True) -> torch.Tensor:
        cfg = self.cfg
        w, h = self.resolution
        prev_gb = {"position": self.prev_position,
                   "normal": self.prev_normal,
                   "geom_id": self.prev_geom_id}
        sig = (params["sigma_l"], params["sigma_n"], params["sigma_x"])
        bp_args = ((w, h), raw, gbuffer, prev_gb, self.prev_view,
                   self.color_history, self.moment_history,
                   self.history_length, params["color_alpha"],
                   params["moment_alpha"])
        first = 1       # the first à-trous level left to run
        filtering = (cfg.right_view_option not in (1, 2)
                     and cfg.spatial_enable and cfg.atrous_nlevel > 0)
        if filtering and (cam_changed or self.static is None):
            # like the branch choice's inputs, the G-buffer changes with
            # the camera alone: packed again only when it moved
            self.static = pack_static_planes(gbuffer["position"],
                                             gbuffer["normal"])
        static = self.static
        if self.fuse_l1:
            # the fuse_reproject_l1 frame (ptdn_tpu/denoise/svgf.py:80-135):
            # kernel L where the motion is near, else C's band mode then D
            # at level 1; level 1's output is the color history
            self._motion(gbuffer, cam_changed)
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
            self._motion(gbuffer, cam_changed)
            variance, color_acc, moment_acc, hist_up = back_projection_auto(
                *bp_args, near=self.near, starts=self.starts)
            color_history = color_acc
        else:
            color_history = raw
            moment_acc = self.moment_history
            hist_up = self.history_length
            # EstimateVariance stub = 10.0 (denoise.cu:320-329)
            variance = torch.full((h, w), 10.0, device=raw.device)

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
            src, var = color_history, variance
            for level in range(first, cfg.atrous_nlevel + 1):
                last = level == cfg.atrous_nlevel
                keep = level == cfg.history_level
                # the color history and the output keep the JAX layout
                src, var = atrous_level(
                    src, var, static, albedo if last else None, level, *sig,
                    cfg.blur_variance, pack_out=not (last or keep))
                if keep:
                    color_history = src
            output = src

        self.color_history = color_history
        self.moment_history = moment_acc
        self.history_length = hist_up
        self.prev_position = gbuffer["position"]
        self.prev_normal = gbuffer["normal"]
        self.prev_geom_id = gbuffer["geom_id"]
        self.prev_view = view_mat
        return output
