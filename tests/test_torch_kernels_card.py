"""Every CUDA kernel of the whole-path cornell frame (A, B1, B2, C, D)
against its plain version on the card, at a small size (chip_smoke.py
does this at the main path's). The file imports no JAX, so that it runs
where the card is:

    python3 -m pytest --noconftest tests/test_torch_kernels_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_kernels.py."""

import pytest
import torch

from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from torch_card import scenes_dir  # noqa: F401 (fixture)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(scenes_dir):
    """Every CUDA kernel against its plain version on the card, at a small
    size (chip_smoke.py does this at the main path's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.ops.camera import generate_camera_rays

    res = (128, 96)
    cfg = RenderConfig(trace_depth=4, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=5)
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), cfg, res, "cuda")
    for _ in range(3):
        r.render_frame()
    tr = r.step.tracer
    ds, gi = tr.ds, tr.gi
    o, d = generate_camera_rays(r._cam[0], res)
    ka = A._scene_intersect_full_kernel(ds, gi, o, d)
    pa = A.scene_intersect_full_plain(ds, gi, o, d)
    assert (ka["geom_id"] == pa["geom_id"]).float().mean() >= 0.999
    prim = dict({k: getattr(tr, "pcache_" + k) for k in
                 ("t", "normal", "uv", "mat_id", "geom_id", "hit",
                  "albedo")}, o=o, d=d)
    light = dict(tr.light, radius=1.4, intensity=2.7)
    kc, kt = B._path_trace_kernel(ds, gi, prim, 3, 0, 4, light, tr.flags)
    pc, pt = B.path_trace_plain(ds, gi, prim, frame=3, lane0=0, depth=4,
                                light=light, flags=tr.flags)
    diff = (B._deferred_radiance_kernel(ds, kc, kt, 4)
            - B.deferred_radiance_plain(ds, pc, pt, 4)).abs().max(-1).values
    assert (diff > 1e-3).float().mean() < 0.01
    st = r.step.frame_state()
    rad, gb = tr(r._cam[0], r._params, 3, False)
    w, h = res
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    args = (res, rad.reshape(h, w, 3), gb,
            {"position": st["prev_position"], "normal": st["prev_normal"],
             "geom_id": st["prev_geom_id"]}, st["prev_view"],
            st["color_history"], st["moment_history"], st["history_length"],
            0.2, 0.2)
    for a, b in zip(C._back_projection_stencil_kernel(*args),
                    C.back_projection_stencil_plain(*args)):
        assert torch.allclose(a.double(), b.double(), rtol=1e-5, atol=1e-5)
    src, var = C.back_projection_stencil_plain(*args)[1::-1]
    static = D.pack_static_planes(gb["position"], gb["normal"])
    for level in range(1, 6):
        dargs = (src, var, static, None, level, 0.45, 0.2, 0.35, True,
                 level < 5)
        for a, b in zip(D._atrous_level_kernel(*dargs),
                        D.atrous_level_plain(*dargs)):
            assert torch.equal(a, b)
        src, var = D.atrous_level_plain(*dargs)
