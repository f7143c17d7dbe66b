"""The camera-motion kernels L, M and C's band mode against their plain
versions on the card. The file imports no JAX, so that it runs where the
card is:

    python3 -m pytest --noconftest tests/test_torch_motion_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_motion.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import reproject_atrous as L
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from torch_card import scenes_dir  # noqa: F401 (fixture)


SIG = (0.45, 0.2, 0.35)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 9.0],
                  size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.cuda
def test_motion_kernels_match_plain_on_card(scenes_dir):
    """Kernels L, M and C's band mode against their plain versions on the
    card, at a small size (chip_smoke.py does this at the main path's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = RenderConfig(trace_depth=4, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=5)
    res = (128, 96)
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), cfg, res, "cuda")
    for _ in range(3):
        r.render_frame()
    st = r.step.frame_state()
    rad, gb = r.step.tracer(r._cam[0], r._params, 3, False)
    w, h = res
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    args = (res, rad.reshape(h, w, 3), gb,
            {"position": st["prev_position"], "normal": st["prev_normal"],
             "geom_id": st["prev_geom_id"]}, st["prev_view"],
            st["color_history"], st["moment_history"], st["history_length"],
            0.2, 0.2)
    static = D.pack_static_planes(gb["position"], gb["normal"])
    for a, b in zip(L._back_projection_atrous1_kernel(*args, *SIG, True,
                                                      static),
                    L.back_projection_atrous1_plain(*args, *SIG, True,
                                                    static)):
        assert torch.allclose(a.double(), b.double(), rtol=1e-6, atol=1e-6)
    moved = torch.eye(4, device="cuda")
    moved[0, 3] = 0.3
    margs = args[:4] + (st["prev_view"] @ moved,) + args[5:]
    starts = trep.motion_bounds(res, gb, margs[4], 32, 16)[1:]
    for a, b in zip(C._back_projection_banded_kernel(*margs, starts, 32, 16),
                    C.back_projection_banded_plain(*margs, starts, 32, 16)):
        assert torch.allclose(a.double(), b.double(), rtol=1e-6, atol=1e-6)
    o, d = (torch.from_numpy(x).cuda() for x in _rays(4096, 2))
    tr = r.step.tracer
    for cull in (True, False):
        k = A._scene_intersect_kernel(tr.ds, tr.gi, o, d, cull)
        p = A.scene_intersect_plain(tr.ds, tr.gi, o, d, cull)
        for key in k:
            assert torch.allclose(k[key].double(), p[key].double(),
                                  rtol=1e-6, atol=1e-6), key
