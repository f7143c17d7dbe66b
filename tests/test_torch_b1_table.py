"""Kernel B1's table build (csrc/path_trace_table.cu): the scenes past the
per-scene build's limits (more than 64 geoms, more than 1,024
materials, a constant that is not finite) keep the whole-path engine and
take it, where the per-scene build refused them on the card. Its row
table against the constants the per-scene header writes, the three
causes on generated cornell variants, a 65-geom frame against the JAX
package's live render, and, on a card only, the table build against the
per-scene build and the plain version."""

import re

import numpy as np
import pytest
import torch

from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import write_cornell_plus
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

# tests/test_golden.py's cornell_raw_d3 config and its budgets
RAW_D3 = dict(denoise_enable=False, trace_depth=3)
FRAC_BUDGET, RMSE_BUDGET = 0.01, 0.012
# the three causes, as generated cornell variants (write_cornell_plus)
CAUSES = {"65 geoms": dict(cubes=55),
          "1025 materials": dict(materials=1016),
          "non-finite constant": dict(materials=1, refrior="inf")}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["cornell", "bunny"])
def test_row_table_holds_the_header_constants(scenes_dir, name):
    """The table B1's table build reads (GeomInfo.row_code, row_coef, the
    (G, 2) geom table and the material table) equals, bit for bit, the
    constants path_scene_header writes for the per-scene build, read back
    from the header's C text; scene_dev hands the table to the kernels."""
    scene = Scene(str(scenes_dir / f"{name}.txt"))
    gi = A.geom_info(scene, "cpu")
    ds = scene.device("cpu")

    def array(key):
        m = re.search(key + r"(?:\[\d*\])+ = \{(.*?)\};", gi.path_scene, re.S)
        return re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f|-?\d+", m.group(1))

    def floats(key):
        return np.float32([float.fromhex(v[:-1]) for v in array(key)])
    assert gi.table[:, 0].tolist() == [int(v) for v in array("kType")]
    assert gi.table[:, 1].tolist() == [int(v) for v in array("kMat")]
    assert gi.row_code.tolist() == [int(v) for v in array("kCode")]
    assert gi.row_coef.shape == (15 * len(scene.geoms), 4)
    assert np.array_equal(_bits(gi.row_coef.numpy()).reshape(-1),
                          _bits(floats("kCoef")))
    assert np.array_equal(_bits(ds.mat_attr.numpy()).reshape(-1),
                          _bits(floats("kMatAttr")))
    sd = A.scene_dev(ds, gi, torch.device("cpu"))
    assert (sd.row_code, sd.row_coef) == (gi.row_code.data_ptr(),
                                          gi.row_coef.data_ptr())


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


@pytest.mark.parametrize("cause", sorted(CAUSES))
def test_scene_past_the_per_scene_build_keeps_the_whole_path(frames, cause):
    """Each cause alone makes path_scene None (B1's table build on the
    card) and the engine stays whole_path. The variants with materials no
    geom uses render cornell's frames bit for bit (an unused material's
    REFRIOR inf reaches no arithmetic; the JAX package renders that scene
    as cornell too); the 65-geom frame is finite."""
    r, (left, right), _ = frames(cause)
    tr = r.step.tracer
    assert tr.gi.path_scene is None and tr.engine == "whole_path"
    n_geoms, n_mats = len(tr.gi.types), tr.ds.mat_attr.shape[0]
    assert (n_geoms > A.B1_MAX_GEOMS) == (cause == "65 geoms")
    assert (n_mats > A.B1_MAX_MATS) == (cause == "1025 materials")
    assert (not torch.isfinite(tr.ds.mat_attr).all()) == (
        cause == "non-finite constant")
    if cause == "65 geoms":
        assert n_geoms == 65
        assert np.isfinite(left).all() and np.isfinite(right).all()
    else:
        _, (ref_left, ref_right), _ = frames(None)
        assert np.array_equal(_bits(left), _bits(ref_left))
        assert np.array_equal(_bits(right), _bits(ref_right))


def test_cornell65_frame_matches_live_jax(frames):
    """The port's 65-geom frame (cornell plus 55 cubes, cornell_raw_d3 at
    64 x 64, 3 frames: B1's baked rows over 65 geoms in the plain
    version) against the JAX package's live render of the same scene,
    within tests/test_golden.py's budgets for that config. The JAX
    whole-path Pallas kernel takes ~5 minutes to compile in interpret mode
    at 65 geoms, so the reference is the JAX XLA backend. Its cost is the
    cold compile of one frame program, whose 65 geoms are unrolled: a
    smaller image, one frame or depth 2 do not shorten it, and depth 1
    runs no bounce past the primary hit, which is B1's loop.
    Measured: 0.27% of pixels off by more than 1e-3, RMSE 0.0017."""
    _, got, path = frames("65 geoms")
    ref = JRenderer(JScene(path), JConfig(backend="xla", **RAW_D3),
                    resolution=(64, 64)).render(3)
    for img, want in zip(got, ref):
        diff = np.abs(img - np.asarray(want)).max(axis=-1)
        assert (diff > 1e-3).mean() < FRAC_BUDGET
        assert np.sqrt(((img - np.asarray(want)) ** 2).mean()) < RMSE_BUDGET


def test_table_build_launches_nothing_on_cpu(frames):
    """On CPU tensors B1 took its plain version, whichever build the
    scene would take on the card."""
    for cause in CAUSES:
        frames(cause)
    assert B.path_trace.launches == B.path_trace.table_launches == 0


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
