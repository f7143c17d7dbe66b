"""Native mode (compat=False) on the card: kernel R, E's light table
and the native builds of A, J, B1, F and H against their plain versions
at 128x96, and R on history patterns at odd sizes (chip_smoke.py does
this at the main path's shapes). The file
imports no JAX, so that it runs where the card is:

    python3 -m pytest --noconftest tests/test_torch_native_card.py

It skips without a card. The CPU tests of native mode against the JAX
package are tests/test_torch_native.py."""

import pytest
import torch

from ptdn_tpu_torch import bounce_bench as BB
from ptdn_tpu_torch.denoise import svgf
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.camera import generate_camera_rays
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.ops.cuda import spatial_variance as R
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path, write_two_light
from ptdn_tpu_torch.utils.config import RenderConfig

SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            trace_depth=3, atrous_nlevel=2)
FUSED = dict(fuse_path=False, sort_rays=False)
SPLIT = dict(fuse_path=False, fuse_bounce=False)
# R against its plain version: torch.exp and expf may differ in the last
# bit (tests/test_torch_native.py's bound against the JAX package)
VAR_ATOL = 1e-6


@pytest.fixture
def card():
    """Skip where there is no card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("size", BB.R_SIZES)
def test_spatial_variance_patterns_on_card(card, size):
    """Kernel R against its plain version at odd sizes on every history
    pattern of bounce_bench.r_pattern_args (none, all short, none short,
    a clustered 17% block, 17% random, one pixel): within 1e-6, and
    every pixel with a history of 4 frames or more keeps its temporal
    variance bit for bit."""
    h, w = size
    for pattern in BB.R_PATTERNS:
        args = BB.r_pattern_args(h, w, pattern)
        ref = R.spatial_variance_plain(*args)
        got = R._spatial_variance_kernel(*args)
        assert got.shape == (h, w)
        torch.testing.assert_close(got, ref, rtol=0, atol=VAR_ATOL)
        if len(args) > 4:
            keep = args[4] >= 4
            assert torch.equal(got[keep], args[5][keep]), pattern


def _bits_equal(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _native_capture(path, flags, names, call, res=(128, 96), module=W):
    """The arguments of `names`' call number `call` on the fourth frame of
    the scene at `path` in native mode on the card (denoised, depth 3)."""
    r = Renderer(Scene(str(path)),
                 RenderConfig(compat=False, **dict(SVGF, **flags)), res,
                 "cuda")
    for _ in range(3):
        r.render_frame()
    return r, BB.capture_bounce(r, call, names, module)


def _equal_planes(kernel, args, kw):
    """Kernel F, H, A, J or B1 (bounce_bench's names) on `args` through
    the scene's own build and the library's native build: no lane off its
    plain version in any bit of any output."""
    ds, gi, *rest = args
    assert not gi.compat and gi.path_scene is not None
    ref = BB.out_planes(kernel, BB.plain_fn(kernel)(*args, **kw))
    for g in (gi, gi._replace(path_scene=None)):
        got = BB.out_planes(kernel, BB.kernel_fn(kernel)(ds, g, *rest, **kw))
        diffs = BB.plane_diffs(got, ref)
        assert not any(diffs.values()), (kernel, g.path_scene is None, diffs)


@pytest.mark.cuda
def test_native_kernels_match_plain_on_card(card, tmp_path):
    """R against its plain version on native cornell's spatial-only frame
    and its fourth temporal frame (the fallback), within 1e-6 (bit
    for bit where expf and torch.exp agree); E's light table on the
    two-light scene's bounce 2, bit for bit; the native builds of A, J,
    B1 (per-scene and table), F and H on bunny's state, no lane off in
    any output."""
    cornell = scene_path("cornell")
    for flags in (dict(temporal_enable=False), {}):
        _, cap = _native_capture(cornell, flags,
                                 ("spatial_variance_fallback",), 1,
                                 module=svgf)
        args, kw = cap["spatial_variance_fallback"]
        got = R._spatial_variance_kernel(*args, **kw)
        ref = R.spatial_variance_plain(*args, **kw)
        torch.testing.assert_close(got, ref, rtol=0, atol=VAR_ATOL)
    _, cap = _native_capture(write_two_light(tmp_path), {},
                             ("shade_bounce",), 2)
    (planes, mats), kw = cap["shade_bounce"]
    assert kw["lights"] is not None
    got = E._shade_bounce_kernel(planes, mats, **kw)
    ref = E.shade_bounce_plain(planes, mats, **kw)
    assert got.shape[0] == E.N_OUT + 1
    assert _bits_equal(got, ref)
    bunny = scene_path("bunny")
    for kernel, flags in (("trace_bounce", {}),
                          ("bounce_fused", FUSED),
                          ("scene_intersect_full", SPLIT)):
        _, cap = _native_capture(bunny, flags, (kernel,), 2)
        _equal_planes(kernel, *cap[kernel])
    r, _ = _native_capture(bunny, dict(sort_rays=False), (), 1)
    tr = r.step.tracer
    o, d = generate_camera_rays(r._cam[0], r.resolution)
    _equal_planes("scene_intersect_full_tex", (tr.ds, tr.gi, o, d), {})
    prim = dict({k: getattr(tr, "pcache_" + k) for k in W.PCACHE_KEYS},
                o=o, d=d)
    light = dict(tr.light, radius=float(r.cfg.light_radius),
                 intensity=float(r.cfg.shadow_intensity))
    _equal_planes("path_trace_table", (tr.ds, tr.gi, prim),
                  dict(frame=3, lane0=0, depth=3, light=light,
                       flags=tr.flags))
