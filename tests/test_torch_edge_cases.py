"""The JAX package's edge-case configs (tests/test_edge_cases.py) through
the port on the CPU (the plain versions): a pure-analytic scene (no
mesh), depth 1 with and without SVGF, no à-trous level, the spatial
filter without the temporal one, a resolution whose ray count is not a
multiple of 1,024, and depth 10; each with the JAX test's own
assertions on the port's render, and the pure-analytic raw frame against
a live render of the JAX package's XLA backend."""

import numpy as np
import pytest

from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

# the port's copy of tests/test_edge_cases.py's scene: a light cube, a
# floor and a sphere, no mesh
PURE_ANALYTIC = """\
MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         .8 .6 .6
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

CAMERA
RES         64 64
FOVY        45
FILE        mini
EYE         0.0 5 10.5
LOOKAT      0 5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       0 10 0
ROTAT       0 0 0
SCALE       3 .3 3

OBJECT 1
cube
material 1
TRANS       0 0 0
ROTAT       0 0 0
SCALE       10 .01 10

OBJECT 2
sphere
material 1
TRANS       0 3 0
ROTAT       0 0 0
SCALE       3 3 3
"""
# tests/test_golden.py's budget for a raw frame: the share of pixels off
# by more than 1e-3, and the RMSE
FRAC_BUDGET, RMSE_BUDGET = 0.01, 0.012


@pytest.fixture(scope="module")
def analytic_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("scenes") / "mini.txt"
    p.write_text(PURE_ANALYTIC)
    return str(p)


def _render(path, res=(64, 64), frames=1, **kw):
    """The port's last (left, right) of `frames` frames, on the CPU."""
    r = Renderer(Scene(path), RenderConfig(**kw), resolution=res,
                 device="cpu")
    return r.render(frames)


def test_pure_analytic_scene(analytic_path):
    """No mesh at all: the tracer skips the mesh path cleanly, the frame
    is finite and sees the light (its max is the emittance, 5)."""
    assert Scene(analytic_path).n_tris == 0
    left, _ = _render(analytic_path, frames=2, denoise_enable=False,
                      trace_depth=3)
    assert not np.isnan(left).any()
    assert left.max() == pytest.approx(5.0, rel=1e-5)
    assert left.mean() > 0.005


def test_pure_analytic_matches_live_xla(analytic_path):
    """The pure-analytic raw frame (depth 3, 2 frames) against the JAX
    package's live XLA render, within tests/test_golden.py's raw-frame
    budget."""
    kw = dict(denoise_enable=False, trace_depth=3)
    left, _ = _render(analytic_path, frames=2, **kw)
    r = JRenderer(JScene(analytic_path), JConfig(backend="xla", **kw),
                  resolution=(64, 64))
    ref, _ = r.render(2)
    ref = np.asarray(ref)
    diff = np.abs(left - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < FRAC_BUDGET
    assert np.sqrt(((left - ref) ** 2).mean()) < RMSE_BUDGET


def test_depth_one(analytic_path):
    """trace_depth=1: only emissive primaries contribute (plus NEE)."""
    left, _ = _render(analytic_path, denoise_enable=False, trace_depth=1)
    assert not np.isnan(left).any()


def test_depth_one_svgf(scenes_dir):
    """depth 1 on cornell with temporal SVGF and two à-trous levels
    (the reference GUI's minimum depth): finite, emissive primaries
    land."""
    left, right = _render(str(scenes_dir / "cornell.txt"), frames=2,
                          denoise_enable=True, temporal_enable=True,
                          spatial_enable=True, atrous_nlevel=2,
                          trace_depth=1)
    assert not np.isnan(left).any()
    assert not np.isnan(right).any()
    assert left.max() > 0


def test_atrous_zero_levels(analytic_path):
    """atrous_nlevel=0 skips the filter: the output is the temporal
    accumulation, finite."""
    _, right = _render(analytic_path, frames=2, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=0, trace_depth=2)
    assert not np.isnan(right).any()


def test_spatial_only_without_temporal(analytic_path):
    _, right = _render(analytic_path, frames=2, denoise_enable=True,
                       temporal_enable=False, spatial_enable=True,
                       trace_depth=2)
    assert not np.isnan(right).any()


def test_odd_resolution(analytic_path):
    """60 x 52: a ray count that is not a multiple of 1,024 renders, at
    its own shape."""
    left, _ = _render(analytic_path, res=(60, 52), denoise_enable=False,
                      trace_depth=2)
    assert left.shape == (52, 60, 3)
    assert not np.isnan(left).any()


def test_reference_scene_depths(scenes_dir):
    """depth 10 (the reference GUI's maximum) on cornell at 32 x 32."""
    left, _ = _render(str(scenes_dir / "cornell.txt"), res=(32, 32),
                      denoise_enable=False, trace_depth=10)
    assert not np.isnan(left).any()
