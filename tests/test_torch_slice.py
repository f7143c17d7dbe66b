"""The port's whole frame against the JAX package: ptdn_tpu_torch's
Renderer on the CPU (the plain versions of every kernel), cornell at
64x64 for 3 frames, against a live JAX Renderer(backend="xla") run and
the committed pallas goldens, within tests/test_golden.py's budgets."""

import os

import numpy as np
import pytest
import torch

from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
_SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
             trace_depth=3, atrous_nlevel=3)
CONFIGS = {"cornell_raw_d3": dict(denoise_enable=False, trace_depth=3),
           "cornell_svgf_d3": _SVGF}
# tests/test_golden.py's FRAC_BUDGET and RMSE bound for these configs
FRAC_BUDGET = {"cornell_raw_d3": 0.01, "cornell_svgf_d3": 0.06}
RMSE_BUDGET = 0.012


@pytest.fixture(scope="module")
def port_renders(scenes_dir):
    scene = Scene(str(scenes_dir / "cornell.txt"))
    return {name: Renderer(scene, RenderConfig(**kw), (64, 64),
                           device="cpu").render(3)
            for name, kw in CONFIGS.items()}


def _within_budget(name, images, refs):
    for img, ref in zip(images, refs):
        diff = np.abs(img - ref).max(axis=-1)
        assert (diff > 1e-3).mean() < FRAC_BUDGET[name]
        assert np.sqrt(((img - ref) ** 2).mean()) < RMSE_BUDGET


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_matches_pallas_golden(port_renders, name):
    g = np.load(os.path.join(GOLDEN, f"{name}.pallas.npz"))
    _within_budget(name, port_renders[name], (g["left"], g["right"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_matches_live_xla(port_renders, scenes_dir, name):
    r = JRenderer(JScene(str(scenes_dir / "cornell.txt")),
                  JConfig(backend="xla", **CONFIGS[name]),
                  resolution=(64, 64))
    _within_budget(name, port_renders[name], r.render(3))


def test_slice_launches_no_kernel_on_cpu(port_renders):
    """On CPU tensors every wrapper took its plain version."""
    from ptdn_tpu_torch.ops.cuda import atrous, path, reproject
    from ptdn_tpu_torch.ops.cuda import scene_intersect
    assert (scene_intersect.scene_intersect_full.launches
            + path.path_trace.launches + path.deferred_radiance.launches
            + reproject.back_projection_stencil.launches
            + atrous.atrous_level.launches) == 0


def test_renderer_on_cuda_without_card_raises(scenes_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Renderer(Scene(str(scenes_dir / "cornell.txt")), RenderConfig(),
                 (64, 64), device="cuda")


@pytest.mark.parametrize("temporal,view,expect", [(True, 2, 1000.0),
                                                  (False, 2, 100.0),
                                                  (True, 1, 0.01)])
def test_svgf_debug_views_and_variance_stub(temporal, view, expect):
    """Frame 0 rejects every history (variance 100, history 1); with the
    temporal pass off the EstimateVariance stub writes 10.0
    (denoise.cu:320-329). The debug views show variance / 0.1 and
    history / 100, as the JAX package's test_svgf_debug_views pins."""
    from ptdn_tpu_torch.denoise.svgf import SVGFDenoiser

    h, w = 16, 24
    cfg = RenderConfig(denoise_enable=True, temporal_enable=temporal,
                       spatial_enable=True, right_view_option=view)
    den = SVGFDenoiser(cfg, (w, h), "cpu")
    gb = {"position": torch.zeros(h, w, 3), "normal": torch.zeros(h, w, 3),
          "geom_id": torch.zeros(h, w, dtype=torch.int32),
          "albedo": torch.ones(h, w, 3), "ialbedo": torch.ones(h, w, 3)}
    out = den(torch.full((h, w, 3), 0.5), gb, torch.eye(4),
              cfg.traced_params())
    assert torch.allclose(out, torch.full((h, w, 3), expect))


def test_svgf_keeps_kernel_c_choice_while_camera_still(scenes_dir,
                                                       monkeypatch):
    """The choice of kernel C (motion_bounds, read back to the host) is
    made only when the camera moved this frame or the one before, the
    only frames whose G-buffer or previous view differ from the last
    one's; the frames equal those of a renderer that decides afresh every
    frame, through a camera change at frame 3."""
    from ptdn_tpu_torch.denoise import svgf

    calls = []
    real = svgf.motion_bounds
    monkeypatch.setattr(svgf, "motion_bounds",
                        lambda *a: calls.append(1) or real(*a))
    scene = Scene(str(scenes_dir / "cornell.txt"))
    kept, fresh = (Renderer(scene, RenderConfig(**_SVGF), (32, 32),
                            device="cpu") for _ in range(2))
    for frame in range(6):
        if frame == 3:
            kept.cam_changed = fresh.cam_changed = True
        fresh.step.denoiser.forget_motion()
        assert torch.equal(kept.render_frame()[1], fresh.render_frame()[1])
    assert len(calls) == 4 + 6      # kept: frames 0, 1, 3, 4; fresh: all


def test_svgf_packs_gbuffer_once_per_camera_move(scenes_dir, monkeypatch):
    """Kernel D's packed G-buffer (pack_static_planes) is made when the
    camera moved, and kept while it is still: through an orbit at frame 3
    the frames equal those of a renderer that packs afresh every frame,
    with two packs in place of six."""
    from ptdn_tpu_torch.denoise import svgf

    calls = []
    real = svgf.pack_static_planes
    monkeypatch.setattr(svgf, "pack_static_planes",
                        lambda *a: calls.append(1) or real(*a))
    scene = Scene(str(scenes_dir / "cornell.txt"))
    kept, fresh = (Renderer(scene, RenderConfig(**_SVGF), (32, 32),
                            device="cpu") for _ in range(2))
    for frame in range(6):
        if frame == 3:
            kept.orbit(0.3, 0.1)
            fresh.orbit(0.3, 0.1)
        n = len(calls)
        a = kept.render_frame()[1]
        kept_packs = len(calls) - n
        fresh.step.denoiser.forget_motion()
        assert torch.equal(a, fresh.render_frame()[1])
        assert kept_packs == (1 if frame in (0, 3) else 0), frame
