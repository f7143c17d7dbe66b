"""The row-sharded frame step (ptdn_tpu/parallel/sharded.py).

Each shard traces its own rows through the whole image's engines (the
tracer is row-parallel: a shard's PathTracer makes its rows' camera
rays, centred on the image's height, and seeds lane i with x + (row0 +
y) * W, so every pixel draws the single-device stream; the primary-hit
cache is per shard and the sorted engine's coherence sort is shard-
local). Its denoiser asks its group for the rows of the other shards
that its stencils read (svgf.py), and its à-trous levels run kernel D's
shard mode (ShardPyramid): one halo exchange per camera move brings the
G-buffer planes for every level, one per level the color and variance,
each the taps' exact reach. The stitched frame equals the whole image's
frame bit for bit, in every branch (the JAX package's sharded step
swaps its reprojection for XLA code there and differs by up to 1e-3).

make_sharded_step builds the step of the shards a group holds (all of
them in one process, one a rank across processes); ShardedRenderer
drives it as Renderer drives the whole image's step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ptdn_tpu_torch.denoise.reproject import band_halo
from ptdn_tpu_torch.denoise.svgf import Pyramid, shard_back_projection
from ptdn_tpu_torch.engine.renderer import Renderer
from ptdn_tpu_torch.engine.step import FrameStep
from ptdn_tpu_torch.engine.wavefront import PathTracer
from ptdn_tpu_torch.ops.cuda.atrous import (atrous_halo, atrous_level,
                                            pack_static_planes,
                                            packed_level_input)
from ptdn_tpu_torch.parallel.mesh import Halo, InProcessGroup, ShardGroup

# frame-state keys that are image rows (H, W, ...) or flat rays (H * W,
# ...), the same contiguous partition (ptdn_tpu/parallel/sharded.py:
# _IMAGE_KEYS); the rest (the previous view) is replicated
IMAGE_KEYS = ("accum_image", "color_history", "moment_history",
              "history_length", "prev_position", "prev_normal",
              "prev_geom_id", "pcache_t", "pcache_normal", "pcache_uv",
              "pcache_mat_id", "pcache_geom_id", "pcache_hit",
              "pcache_albedo")


def shard_rows(group: ShardGroup, height: int) -> List[Tuple[int, int]]:
    """(row0, h) of each shard the group holds; the height must divide
    evenly (ValueError)."""
    if height % group.n:
        raise ValueError(f"image height {height} must divide across "
                         f"{group.n} shards")
    h = height // group.n
    return [(i * h, h) for i in group.held]


def back_projection_shards(args, n: int, starts=None, k=None):
    """Kernel C's shard-form calls (ops/cuda/reproject.py) of n row
    shards of the whole image's call `args` (res, ..., moment_alpha_min),
    each made by svgf.shard_back_projection, as the sharded denoiser
    makes it, its Halo fulfilled by an in-process group: k halo rows, 2
    in stencil mode, band_halo's in band mode (`starts`: the image's band
    starts on the host), or `k`. Returns ([(positional arguments,
    keywords)], k), the band mode's positional arguments ending in
    (starts, band_rows, margin)."""
    (w, h), color, gb, prev_gb, view, ch, mh, hl, ca, ma = args
    rows = h // n
    if k is None:
        k = 2 if starts is None else band_halo(starts, rows, h)
    gens = []
    for r0 in range(0, h, rows):
        r = slice(r0, r0 + rows)
        sargs = ((w, rows), color[r], {key: v[r] for key, v in gb.items()},
                 {"normal": prev_gb["normal"][r],
                  "geom_id": prev_gb["geom_id"][r]}, view, ch[r], mh[r],
                 hl[r], ca, ma)
        gens.append(shard_back_projection(sargs, (r0, h), starts is None,
                                          starts, k))
    return [(a, kw) for _, a, kw in InProcessGroup(n).run(gens)], k


class ShardPyramid(Pyramid):
    """The à-trous levels of the shard whose rows start at image row
    `row0` of a `full_h`-row image (the JAX package's
    _make_sharded_pyramid): the G-buffer planes extended once per camera
    move by the last level's reach; per level the halo rows of the color
    and variance, each level's reach (top and bottom, apart from the
    shard's rows), then kernel D's shard mode on the level's input as it
    lies, packed (the previous level's packed output as it is, the
    others packed once)."""

    def __init__(self, row0: int, full_h: int, nlevel: int):
        self.row0, self.full_h = row0, full_h
        self.static_halo = atrous_halo(max(nlevel, 1))

    def pack(self, position, normal):
        return (yield Halo(pack_static_planes(position, normal),
                           self.static_halo))

    def __call__(self, src, var, static, albedo, sig, cfg, first: int):
        history = None
        for level in range(first, cfg.atrous_nlevel + 1):
            last = level == cfg.atrous_nlevel
            keep = level == cfg.history_level
            cv = packed_level_input(src, var)
            rows = yield Halo(cv, atrous_halo(level), split=True)
            src, var = atrous_level(
                cv[..., :3], cv[..., 3], static, albedo if last else None,
                level, *sig, cfg.blur_variance, pack_out=not (last or keep),
                row0=self.row0, full_h=self.full_h, halo=rows,
                static_halo=self.static_halo)
            if keep:
                history = src
        return src, history


class ShardedStep:
    """The frame step of the shards `group` holds: forward(cam, view_mat,
    params, frame, cam_changed) returns each held shard's (left, right)
    rows, gather() stitches them into the image's, frame_state() the
    shards' states into the image's under the JAX keys."""

    def __init__(self, scene, cfg, resolution, group: ShardGroup, device):
        w, h = resolution
        self.cfg = cfg
        self.resolution = (w, h)
        self.group = group
        self.rows = shard_rows(group, h)
        self.steps: List[FrameStep] = []
        first = None
        for row0, hl in self.rows:
            # the first shard's tracer lends the others its scene tensors,
            # tables and per-scene builds
            tracer = PathTracer(scene, cfg, (w, hl), device, row0=row0,
                                full_height=h, shared=first)
            first = first or tracer
            self.steps.append(FrameStep(
                scene, cfg, (w, hl), device, tracer=tracer,
                pyramid=ShardPyramid(row0, h, cfg.atrous_nlevel)))

    def forward(self, cam, view_mat, params, frame: int, cam_changed: bool):
        return self.group.run(s.frame_gen(cam, view_mat, params, frame,
                                          cam_changed) for s in self.steps)

    __call__ = forward

    def gather(self, outs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The image's (left, right) from forward's shard rows."""
        return (self.group.gather([o[0] for o in outs]),
                self.group.gather([o[1] for o in outs]))

    def frame_state(self) -> Dict[str, torch.Tensor]:
        states = [s.frame_state() for s in self.steps]
        return {k: (self.group.gather([st[k] for st in states])
                    if k in IMAGE_KEYS else v)
                for k, v in states[0].items()}

    def reset(self):
        for s in self.steps:
            s.reset()


def make_sharded_step(scene, cfg, resolution, group: ShardGroup,
                      device="cuda") -> ShardedStep:
    """The sharded frame step of `group`'s shards on `device` (the card
    unless the caller names the CPU; without a card the default
    raises). Raises ValueError if the height does not divide evenly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_sharded_step(device='cuda') needs a CUDA "
                           "device")
    return ShardedStep(scene, cfg, tuple(resolution or scene.resolution),
                       group, device)


class ShardedRenderer(Renderer):
    """Renderer (the frame loop, camera and resets) over the sharded
    step of `group`: render_frame returns the stitched image."""

    def __init__(self, scene, cfg, resolution, group: ShardGroup,
                 device="cuda"):
        self.group = group
        super().__init__(scene, cfg, resolution, device)

    def _build(self):
        self.step = make_sharded_step(self.scene, self.cfg, self.resolution,
                                      self.group, self.device)
        self._params = self.cfg.traced_params()

    def _images(self, out):
        return self.step.gather(out)
