"""Kernel B1's table build on the card: against the per-scene build and
its plain version. The file imports no JAX, so that it runs where the
card is:

    python3 -m pytest --noconftest tests/test_torch_b1_table_card.py

It skips without a card. The table build's CPU tests against the JAX
package are tests/test_torch_b1_table.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import write_cornell_plus
from ptdn_tpu_torch.utils.config import RenderConfig
from torch_card import scenes_dir  # noqa: F401 (fixture)


# tests/test_golden.py's cornell_raw_d3 config and its budgets
RAW_D3 = dict(denoise_enable=False, trace_depth=3)


# the three causes, as generated cornell variants (write_cornell_plus)
CAUSES = {"65 geoms": dict(cubes=55),
          "1025 materials": dict(materials=1016),
          "non-finite constant": dict(materials=1, refrior="inf")}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def frames(tmp_path_factory, scenes_dir):
    """The port's 3 frames of cornell_raw_d3 at 64 x 64 on the CPU, of
    cornell and of each cause's variant, rendered once; each with its
    renderer."""
    out = tmp_path_factory.mktemp("scenes")
    cache = {}

    def render(cause):
        if cause not in cache:
            path = (str(scenes_dir / "cornell.txt") if cause is None
                    else write_cornell_plus(out, **CAUSES[cause]))
            r = Renderer(Scene(path), RenderConfig(**RAW_D3), (64, 64),
                         device="cpu")
            cache[cause] = (r, r.render(3), path)
        return cache[cause]
    return render


def _b1_args(r, frame):
    """Kernel B1's arguments on renderer r's primary state (its last
    frame's primary-hit cache and camera rays)."""
    tr = r.step.tracer
    o, d = generate_camera_rays(r._cam[0], r.resolution)
    prim = dict({k: getattr(tr, "pcache_" + k) for k in W.PCACHE_KEYS},
                o=o, d=d)
    light = dict(tr.light, radius=float(r.cfg.light_radius),
                 intensity=float(r.cfg.shadow_intensity))
    return (tr.ds, tr.gi, prim, frame, 0, r.cfg.trace_depth, light,
            tr.flags)


def _b1_plain(ds, gi, prim, frame, lane0, depth, light, flags):
    return B.path_trace_plain(ds, gi, prim, frame=frame, lane0=lane0,
                              depth=depth, light=light, flags=flags)


def _assert_same(got, want):
    assert np.array_equal(_bits(got[0].cpu().numpy()),
                          _bits(want[0].cpu().numpy()))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_b1_table_build_matches_per_scene_on_card(frames, scenes_dir):
    """On a card, at 128 x 96 (chip_smoke.py does so at 800 x 800): B1's
    table build on cornell (its path_scene dropped) equals the per-scene
    build and the plain version bit for bit; the 65-geom scene renders
    through it, a launch a frame, and on that scene's primary state (geom
    indices up to 64 in its tables) it equals its plain version bit for
    bit, contributions and texel indices."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")),
                 RenderConfig(trace_depth=4), (128, 96), "cuda")
    r.render(2)
    ds, gi, *args = _b1_args(r, 2)
    table = B._path_trace_kernel(ds, gi._replace(path_scene=None), *args)
    _assert_same(table, B._path_trace_kernel(ds, gi, *args))
    _assert_same(table, _b1_plain(ds, gi, *args))
    path = frames("65 geoms")[2]
    r65 = Renderer(Scene(path), RenderConfig(**RAW_D3), (128, 96), "cuda")
    B.path_trace.table_launches = 0
    left, right = r65.render(2)
    assert B.path_trace.table_launches == 2
    assert np.isfinite(left).all() and np.isfinite(right).all()
    args65 = _b1_args(r65, 1)
    assert args65[1].path_scene is None and len(args65[1].types) == 65
    _assert_same(B._path_trace_kernel(*args65), _b1_plain(*args65))
