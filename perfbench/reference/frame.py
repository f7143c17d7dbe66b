"""One frame of the renderer in plain PyTorch, from the scene file, the
camera and the SVGF history: what the benchmark holds the program's
frames to.

`ReferenceFrame(scene_path, settings, resolution, device)` parses the
scene itself (reference/scene.py), builds its own camera, and
`frame(pose, prev_pose, index, history)` renders frame `index` at the
camera `pose`: the raw 1-spp radiance (`left`), the primary-hit G-buffer
and the SVGF frame (`right` and the history it carries on). The previous
frame's G-buffer and view are worked out again from `prev_pose`; only the
color and moment histories and the history length come from outside,
since they sum every frame since the reset. `history=None` is the
renderer's reset state (zeros, no previous geometry, the identity view).

The settings are the configuration's: 1 spp, a trace depth, the NEE
shadow ray, compat mode, and temporal + spatial SVGF with its à-trous
levels. What the configurations of the benchmark do not use (native
mode, a mesh light, the debug views, the albedo demodulation, the fused
reprojection) is refused.

`store` is applied to every plane that a stage hands the next: the
identity in the reference; the control rounds them to a lower precision
(check.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from perfbench.reference.camera import (OrbitCamera, generate_camera_rays,
                                        view_matrix)
from perfbench.reference.denoise import (BAND_MARGIN, BAND_ROWS,
                                         atrous_level_plain,
                                         back_projection_banded_plain,
                                         back_projection_stencil_plain,
                                         motion_bounds, pack_static_planes)
from perfbench.reference.fp import fma
from perfbench.reference.intersect import (TCHUNK, geom_info,
                                           scene_intersect_full_plain)
from perfbench.reference.parser import MESH
from perfbench.reference.scene import Scene
from perfbench.reference.tracer import (I_AB, I_AR, N_OUT, N_TIN,
                                        PCACHE_KEYS, albedo_from,
                                        deferred_radiance_plain,
                                        path_trace_plain, shade_bounce_plain,
                                        static_light_radius,
                                        trace_bounce_plain)

HISTORY_KEYS = ("color_history", "moment_history", "history_length")


@dataclasses.dataclass(frozen=True)
class Settings:
    """The renderer's settings that a frame reads (the reference app's
    ui_* values, main.cpp:39-62)."""
    trace_depth: int
    shadow_ray: bool = True
    reduce_var: bool = True
    shadow_intensity: float = 2.7
    light_radius: float = 1.4
    show_texture: bool = True
    compat: bool = True
    temporal_enable: bool = True
    spatial_enable: bool = True
    color_alpha: float = 0.2
    moment_alpha: float = 0.2
    blur_variance: bool = True
    sigma_l: float = 0.45
    sigma_x: float = 0.35
    sigma_n: float = 0.2
    atrous_nlevel: int = 5
    history_level: int = 1


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class ReferenceFrame:
    def __init__(self, scene_path: str, settings: Settings, resolution,
                 device, store: Callable = identity):
        s = settings
        if not (s.compat and s.temporal_enable and s.spatial_enable
                and 1 <= s.history_level <= s.atrous_nlevel):
            raise NotImplementedError(f"the reference renders compat mode "
                                      f"with temporal and spatial SVGF: {s}")
        self.settings = s
        self.device = torch.device(device)
        self.store = store
        self.scene = Scene(scene_path)
        self.resolution = tuple(resolution)
        scene = self.scene
        if scene.geom_types[0] == MESH and s.shadow_ray:
            raise NotImplementedError("a mesh light takes the split engine")
        self.ds = scene.device(self.device)
        self.gi = geom_info(scene, self.device, s.compat)
        # the program's engine choice: the sorted wavefront past four
        # triangle chunks, else the whole path
        self.bounces = -(-scene.n_tris // TCHUNK) > 4
        light_mat = scene.materials[scene.geom_material_ids[0]]
        emit = (np.asarray(light_mat.color, np.float32)
                * np.float32(light_mat.emittance))
        self.light = {
            "geom": 0,
            "pos": [float(x) for x in scene.geoms[0].translation],
            "emit": [float(x) for x in emit],
            "half_diag": static_light_radius(self.ds, 0),
            "radius": float(np.float32(s.light_radius)),
            "intensity": float(np.float32(s.shadow_intensity))}
        self.show_texture = s.show_texture and len(scene.textures) > 0
        self.flags = {"shadow_ray": s.shadow_ray, "reduce_var": s.reduce_var,
                      "do_vis": (s.shadow_ray
                                 and float(light_mat.emittance) > 0.0),
                      "alb_skip1": False, "show_tex": self.show_texture}
        f = np.float32
        self.params = {k: f(getattr(s, k)) for k in (
            "color_alpha", "moment_alpha", "sigma_l", "sigma_n", "sigma_x")}

    # -- the camera ------------------------------------------------------
    def camera(self, pose):
        """(camera tensors, view matrix) at `pose` (look_at, theta, phi;
        None: the scene's own camera)."""
        cam = OrbitCamera(self.scene.camera, resolution=self.resolution)
        if pose is not None:
            cam.look_at = np.asarray(pose["look_at"], np.float32)
            cam.theta, cam.phi = float(pose["theta"]), float(pose["phi"])
        fc = cam.frame()
        return (fc.as_tensors(self.device),
                torch.from_numpy(view_matrix(fc)).to(self.device))

    def primary(self, pose):
        """The camera rays, the primary hit (with its albedo) and the
        view matrix at `pose`."""
        cam, vm = self.camera(pose)
        o, d = generate_camera_rays(cam, self.resolution)
        isect = scene_intersect_full_plain(self.ds, self.gi, o, d)
        isect["albedo"] = albedo_from(self.ds, isect["mat_id"], isect["uv"],
                                      self.show_texture)
        prim = {k: isect[k] for k in PCACHE_KEYS}
        return dict(prim, o=o, d=d), vm

    def gbuffer(self, prim):
        w, h = self.resolution
        gb = {"position": fma(prim["t"][:, None], prim["d"], prim["o"]),
              "normal": prim["normal"], "albedo": prim["albedo"],
              "geom_id": prim["geom_id"]}
        return {k: v.reshape((h, w) + tuple(v.shape[1:]))
                for k, v in gb.items()}

    # -- the tracer ------------------------------------------------------
    def trace(self, prim, index: int, counts=None) -> torch.Tensor:
        """The raw radiance (N, 3) of frame `index` from the primary hit;
        `counts` as path_trace_plain's (the whole path only)."""
        depth = self.settings.trace_depth
        if not self.bounces:
            contrib, texidx = path_trace_plain(
                self.ds, self.gi, prim, frame=index, lane0=0, depth=depth,
                light=self.light, flags=self.flags, counts=counts)
            return deferred_radiance_plain(self.ds, contrib, texidx, depth)
        return self._bounces(prim, index)

    def _bounces(self, prim, index: int) -> torch.Tensor:
        """Per bounce kernel E's and F's plain versions over the lanes in
        pixel order (the sorted wavefront's arithmetic, unsorted)."""
        n = prim["t"].shape[0]
        dev = prim["t"].device
        one, zero = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        planes = torch.stack(
            [prim["o"][:, k] for k in range(3)]
            + [prim["d"][:, k] for k in range(3)] + [prim["t"]]
            + [prim["normal"][:, k] for k in range(3)]
            + [prim["albedo"][:, k] for k in range(3)]
            + [one] * 3 + [zero] * 3
            + [prim["mat_id"].to(torch.float32),
               prim["hit"].to(torch.float32), zero])
        pix = torch.arange(n, dtype=torch.float32, device=dev)
        ranges = torch.zeros((N_TIN - N_OUT, n), device=dev)
        fl, light = self.flags, self.light
        depth = self.settings.trace_depth
        for dd in range(1, depth + 1):
            sh = shade_bounce_plain(
                torch.cat([planes, pix[None]]), self.ds.mat_attr,
                fd=index + dd, lane0=0, light_pos=light["pos"],
                lrad=light["radius"], sint=light["intensity"],
                alb_skip=dd == 1 and fl["alb_skip1"],
                shadow_ray=fl["shadow_ray"], reduce_var=fl["reduce_var"])
            # F's plain version reads no range plane: it scans every chunk
            out, alb = trace_bounce_plain(
                self.ds, self.gi, torch.cat([sh, ranges]),
                light_geom=light["geom"], do_vis=fl["do_vis"],
                do_next=dd < depth, emit=light["emit"],
                show_tex=fl["show_tex"])
            planes = torch.cat([out[0:10],
                                planes[I_AR:I_AB + 1] if alb is None
                                else alb, out[10:19]])
        return planes[16:19].T.contiguous()

    # -- the denoiser ----------------------------------------------------
    def denoise(self, raw, gb, prev_gb, prev_view, history):
        """The SVGF frame (compat, temporal + spatial): (output, the
        history it carries on)."""
        s, p, st = self.settings, self.params, self.store
        w, h = self.resolution
        bp_args = (self.resolution, raw, gb, prev_gb, prev_view,
                   history["color_history"], history["moment_history"],
                   history["history_length"], p["color_alpha"],
                   p["moment_alpha"])
        bounds = motion_bounds(self.resolution, gb, prev_view)
        if bool(bounds[0]):
            out = back_projection_stencil_plain(*bp_args)
        else:
            out = back_projection_banded_plain(*bp_args, bounds[1:],
                                               BAND_ROWS, BAND_MARGIN)
        variance, color_acc, moment_acc, hist_up = out
        src, var = st(color_acc), st(variance)
        color_history = src
        static = st(pack_static_planes(gb["position"], gb["normal"]))
        for level in range(1, s.atrous_nlevel + 1):
            src, var = atrous_level_plain(
                src, var, static, None, level, p["sigma_l"], p["sigma_n"],
                p["sigma_x"], s.blur_variance)
            src, var = st(src), st(var)
            if level == s.history_level:
                color_history = src
        return src, {"color_history": color_history,
                     "moment_history": st(moment_acc),
                     "history_length": hist_up}

    def reset_history(self):
        """The renderer's state after a reset (init_denoise_state)."""
        w, h = self.resolution
        dev = self.device
        return ({"color_history": torch.zeros((h, w, 3), device=dev),
                 "moment_history": torch.zeros((h, w, 2), device=dev),
                 "history_length": torch.zeros((h, w), dtype=torch.int32,
                                               device=dev)},
                {"position": torch.zeros((h, w, 3), device=dev),
                 "normal": torch.zeros((h, w, 3), device=dev),
                 "geom_id": torch.full((h, w), -1, dtype=torch.int32,
                                       device=dev)},
                torch.eye(4, device=dev))

    def frame(self, pose, prev_pose, index: int,
              history: Optional[Dict[str, torch.Tensor]] = None,
              counts=None):
        """Frame `index` at camera `pose`, the last frame's at `prev_pose`
        with the SVGF `history` it left (None: the first frame after a
        reset). Returns a dict: left and right (H, W, 3), the G-buffer
        position, normal and geom_id, and the history carried on.
        `counts` as trace's."""
        w, h = self.resolution
        st = self.store
        if history is None:
            history, prev_gb, prev_view = self.reset_history()
        else:
            prev, prev_view = self.primary(prev_pose)
            g = self.gbuffer(prev)
            prev_gb = {k: st(g[k]) if g[k].is_floating_point() else g[k]
                       for k in ("position", "normal", "geom_id")}
        prim, view = self.primary(pose)
        gb = {k: st(v) if v.is_floating_point() else v
              for k, v in self.gbuffer(prim).items()}
        raw = st(self.trace(prim, index, counts).reshape(h, w, 3))
        right, carried = self.denoise(raw, gb, prev_gb, prev_view, history)
        return dict(left=raw, right=right, position=gb["position"],
                    normal=gb["normal"], geom_id=gb["geom_id"], **carried)
