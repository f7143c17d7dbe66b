"""Runtime configuration, field for field the JAX package's RenderConfig.

Defaults match the reference (src/main.cpp:42-62). There is no
``backend`` field: the device of the renderer decides whether the
hand-written CUDA kernels or their plain PyTorch versions run. The
continuous fields are handed to the frame step as float32 scalars by
``traced_params()``, the structural ones shape the step when it is built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # -------- path tracer (main.cpp:39-47) --------
    trace_depth: int = 4            # ui_tracedepth (1..10)
    shadow_ray: bool = True         # ui_shadowray: NEE shadow ray to light 0
    reduce_var: bool = True         # ui_reducevar: skip emissive hit after diffuse
    shadow_intensity: float = 2.7   # ui_sintensity
    light_radius: float = 1.4       # ui_lightradius
    use_bvh: bool = True            # ui_usekdtree / USE_KDTREE
    show_texture: bool = True       # SHOW_TEXTURE compile flag (sceneStructs.h:16)

    # -------- denoiser (main.cpp:50-62) --------
    denoise_enable: bool = False    # ui_denoise_enable
    temporal_enable: bool = False   # ui_temporal_enable
    spatial_enable: bool = False    # ui_spatial_enable
    color_alpha: float = 0.2        # ui_color_alpha
    moment_alpha: float = 0.2       # ui_moment_alpha
    blur_variance: bool = True      # ui_blurvariance
    sigma_l: float = 0.45           # ui_sigmal
    sigma_x: float = 0.35           # ui_sigmax
    sigma_n: float = 0.2            # ui_sigman
    atrous_nlevel: int = 5          # ui_atrous_nlevel (0..7)
    history_level: int = 1          # ui_history_level
    sep_color: bool = False         # ui_sepcolor: demodulate first-hit albedo
    add_color: bool = False         # ui_addcolor: remodulate after last level

    # -------- camera automation (main.cpp:65-70) --------
    automate_camera: bool = False
    camera_speed_x: float = 0.0
    camera_speed_y: float = 0.0
    camera_speed_z: float = 0.0
    camera_speed_theta: float = 0.0
    camera_speed_phi: float = 0.0

    # -------- debug views (main.cpp:73-74) --------
    # 0 = filtered color, 1 = history length (/100), 2 = variance (/0.1)
    right_view_option: int = 0

    # -------- engine knobs of the JAX package, kept field for field --------
    mesh_mode: str = "auto"
    # replicate reference quirks (stale-albedo on miss, no tan(fov/2) in
    # reprojection, inverted moment alpha, ...)
    compat: bool = True
    fuse_bounce: bool = True
    fuse_path: bool = True
    sort_rays: Any = None
    sort_group: Any = None
    sort_regroup: Any = None
    sort_every: Any = None
    fuse_reproject_l1: bool = False

    def traced_params(self) -> Dict[str, Any]:
        """Continuous parameters as float32 scalars."""
        f = np.float32
        return {
            "shadow_intensity": f(self.shadow_intensity),
            "light_radius": f(self.light_radius),
            "color_alpha": f(self.color_alpha),
            "moment_alpha": f(self.moment_alpha),
            "sigma_l": f(self.sigma_l),
            "sigma_x": f(self.sigma_x),
            "sigma_n": f(self.sigma_n),
        }

    def static_key(self):
        """Hashable key of the structural fields, which shape the frame
        step when it is built (the JAX package's static_key without its
        backend field)."""
        return (
            self.trace_depth, self.shadow_ray, self.reduce_var, self.use_bvh,
            self.show_texture,
            self.denoise_enable, self.temporal_enable, self.spatial_enable,
            self.blur_variance, self.atrous_nlevel, self.history_level,
            self.sep_color, self.add_color, self.right_view_option,
            self.mesh_mode, self.compat,
            self.fuse_bounce, self.fuse_path, self.sort_rays,
            self.sort_group, self.sort_regroup, self.sort_every,
            self.fuse_reproject_l1,
        )
