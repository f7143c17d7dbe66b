"""Native mode (compat=False) and NEE toward a mesh light in the port,
against the JAX package on the CPU: the spatial variance of native SVGF
(denoise/variance.py, the plain version of kernel R) against the JAX
functions and their own tests' assertions; the native SVGF frame against
make_denoise_fn(compat=False); native frames (true barycentric mesh
normals) of cornell and bunny on every engine, the mesh-light scene and
the two-light scene (kernel E's light table) against live JAX renders
(backend="xla"). The card's cases (R, E's light table and the native
builds of A, J, B1, F and H against their plain versions) are in
tests/test_torch_native_card.py, which imports no JAX.

Tolerances: frames within tests/test_golden.py's raw budgets (fewer
than 1% of pixels off by more than 1e-3, RMSE below 0.012); the SVGF
frames within 1e-5 of JAX's (measured at most 1.2e-7 at 16x16, every
path); the variance within 1e-6 absolute (measured 1.5e-7: exp's last
bit on the CPU, amplified by mu2 - mu1^2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.denoise import variance as JV
from ptdn_tpu.denoise.svgf import init_denoise_state, make_denoise_fn
from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch import bounce_bench as BB
from ptdn_tpu_torch.denoise import variance as V
from ptdn_tpu_torch.denoise.reproject import _norm3 as _norm3_of
from ptdn_tpu_torch.denoise.reproject import luminance as reproject_luminance
from ptdn_tpu_torch.denoise.svgf import SVGFDenoiser
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.ops.cuda import spatial_variance as R
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import write_mesh_light, write_two_light
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

RES = (32, 32)
RAW = dict(denoise_enable=False, trace_depth=2)
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            trace_depth=2, atrous_nlevel=2)
# the port's four engines (the JAX package's choice, wavefront.py:936-971)
ENGINES = {"sorted": dict(sort_rays=True),
           "whole_path": dict(sort_rays=False),
           "bounce_fused": dict(fuse_path=False, sort_rays=False),
           "bounce_split": dict(fuse_path=False, fuse_bounce=False)}
VAR_ATOL = 1e-6
SVGF_ATOL = 1e-5


def within_raw_budget(img, ref):
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01
    assert np.sqrt(((img - ref) ** 2).mean()) < 0.012


def port_render(path, frames=2, res=RES, **kw):
    r = Renderer(Scene(str(path)), RenderConfig(**kw), res, device="cpu")
    left, _ = r.render(frames)
    return np.asarray(left), r.step.tracer


def jax_render(path, frames=2, res=RES, **kw):
    r = JRenderer(JScene(str(path)), JConfig(backend="xla", **kw),
                  resolution=res)
    return np.asarray(r.render(frames)[0])


# ---------------------------------------------------------------------------
# the spatial variance (kernel R's plain version)

def _gbuffers(h, w, seed, edge=False):
    """Seeded color, position and normal (numpy); with `edge` the right
    half of the positions pushed 100 away (a geometric edge)."""
    rng = np.random.default_rng(seed)
    color = rng.random((h, w, 3), np.float32)
    pos = (rng.random((h, w, 3), np.float32) * 0.5).astype(np.float32)
    if edge:
        pos[:, w // 2:, 2] += 100.0
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return color, pos, nrm


def _both(color, pos, nrm):
    jgb = {"position": jnp.asarray(pos), "normal": jnp.asarray(nrm)}
    tgb = {"position": torch.from_numpy(pos), "normal": torch.from_numpy(nrm)}
    return jnp.asarray(color), jgb, torch.from_numpy(color), tgb


@pytest.mark.parametrize("case", ["spatial", "fallback", "none_needed"])
def test_spatial_variance_matches_jax(case):
    """spatial_variance and variance_with_spatial_fallback at an odd size
    (21x19) against the JAX functions, and kernel R's wrapper on the CPU
    (its plain version). A history of at least 4 frames everywhere passes
    the temporal variance through bit for bit."""
    h, w = 21, 19
    color, pos, nrm = _gbuffers(h, w, 3, edge=case == "fallback")
    jc, jgb, tc, tgb = _both(color, pos, nrm)
    sig = (np.float32(0.2), np.float32(0.5))
    if case == "spatial":
        ref = np.asarray(JV.spatial_variance(jc, jgb, *map(jnp.float32, sig)))
        got = V.spatial_variance(tc, tgb, *sig).numpy()
        wrapped = R.spatial_variance_fallback(tc, tgb, *sig).numpy()
    else:
        rng = np.random.default_rng(4)
        temporal = rng.random((h, w), np.float32) * 3
        hist = (np.full((h, w), 9, np.int32) if case == "none_needed"
                else rng.integers(0, 8, (h, w)).astype(np.int32))
        ref = np.asarray(JV.variance_with_spatial_fallback(
            jnp.asarray(temporal), jnp.asarray(hist), jc, jgb,
            *map(jnp.float32, sig)))
        args = (torch.from_numpy(temporal), torch.from_numpy(hist), tc, tgb)
        got = V.variance_with_spatial_fallback(*args, *sig).numpy()
        wrapped = R.spatial_variance_fallback(tc, tgb, *sig, args[1],
                                              args[0]).numpy()
        keep = hist >= V.HIST_THRESHOLD
        assert np.array_equal(got[keep], temporal[keep])
        if case == "none_needed":
            assert np.array_equal(got, temporal)
    assert got.shape == (h, w) and (got >= 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=VAR_ATOL)
    assert np.array_equal(wrapped, got)


def _flat_gbuffer(h=16, w=16, z=-5.0):
    """tests/test_denoise.py's flat wall: depth z, normals +z."""
    ys, xs = np.mgrid[0:h, 0:w]
    pos = np.stack([xs - w / 2, ys - h / 2, np.full_like(xs, z)],
                   axis=-1).astype(np.float32)
    return {"position": torch.from_numpy(pos),
            "normal": torch.from_numpy(np.broadcast_to(
                [0, 0, 1.0], (h, w, 3)).astype(np.float32).copy()),
            "geom_id": torch.zeros((h, w), dtype=torch.int32)}


def test_spatial_variance_assertions_of_the_jax_tests():
    """tests/test_denoise.py's native-mode assertions on the port: on a
    flat wall of iid uniform noise the interior estimate is near 1/12;
    two flat halves across a geometric edge do not mix; temporal off and
    compat=False route the estimate into the variance view (a constant
    image reads 0, not the stub's 100); a short history takes the spatial
    estimate, a long one keeps the temporal variance."""
    h = w = 16
    gb = _flat_gbuffer(h, w)
    noise = np.random.default_rng(7).random((h, w, 1)).astype(np.float32)
    var = V.spatial_variance(torch.from_numpy(np.repeat(noise, 3, -1)), gb,
                             np.float32(0.2), np.float32(5.0)).numpy()
    assert var.shape == (h, w) and (var >= 0).all()
    assert abs(var[4:-4, 4:-4].mean() - 1.0 / 12.0) < 0.02
    gb2 = _flat_gbuffer(h, w)
    gb2["position"][:, w // 2:, 2] += 100.0
    flat = np.full((h, w, 3), 0.25, np.float32)
    flat[:, w // 2:] = 0.75
    assert V.spatial_variance(torch.from_numpy(flat), gb2, np.float32(0.2),
                              np.float32(0.5)).max() < 1e-3
    cfg = RenderConfig(denoise_enable=True, temporal_enable=False,
                       spatial_enable=True, right_view_option=2,
                       compat=False)
    gb3 = dict(_flat_gbuffer(h, w), albedo=torch.ones(h, w, 3),
               ialbedo=torch.ones(h, w, 3))
    out = SVGFDenoiser(cfg, (w, h), "cpu")(
        torch.full((h, w, 3), 0.5), gb3, torch.eye(4), cfg.traced_params())
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-5)
    hist = torch.full((h, w), 10, dtype=torch.int32)
    hist[:4] = 1
    fb = V.variance_with_spatial_fallback(
        torch.full((h, w), 7.0), hist, torch.full((h, w, 3), 0.5), gb,
        np.float32(0.2), np.float32(5.0)).numpy()
    np.testing.assert_allclose(fb[:4], 0.0, atol=1e-5)
    np.testing.assert_allclose(fb[4:], 7.0)


@pytest.mark.parametrize("size", [(1, 1), (37, 23), (64, 64), (800, 800)])
def test_spatial_variance_tile_geometry(size):
    """Kernel R's blocks (ops/cuda/spatial_variance.py:sv_tile_pixels,
    the kernel's mapping) filter every pixel of the image once, and stage
    every in-image tap of the 7x7 window of each pixel in the pixel's own
    block, each staged pixel once (800x800: the shapes only)."""
    h, w = size
    (fb, fy, fx), (sb, sy, sx) = R.sv_tile_pixels(h, w)
    assert fy.size == h * w
    assert np.unique(fy * w + fx).size == h * w
    # a staged pixel once per block, and the block's staged pixels the
    # in-image part of the rectangle its filtered pixels' windows span
    assert np.unique((sb * h + sy) * w + sx).size == sb.size
    n = int(fb.max()) + 1
    lo_y, hi_y = np.full(n, h), np.full(n, -1)
    lo_x, hi_x = np.full(n, w), np.full(n, -1)
    np.minimum.at(lo_y, sb, sy)
    np.maximum.at(hi_y, sb, sy)
    np.minimum.at(lo_x, sb, sx)
    np.maximum.at(hi_x, sb, sx)
    area = (hi_y - lo_y + 1) * (hi_x - lo_x + 1)
    assert (np.bincount(sb, minlength=n) == area).all()
    r = V.RADIUS
    assert (lo_y[fb] <= np.maximum(fy - r, 0)).all()
    assert (hi_y[fb] >= np.minimum(fy + r, h - 1)).all()
    assert (lo_x[fb] <= np.maximum(fx - r, 0)).all()
    assert (hi_x[fb] >= np.minimum(fx + r, w - 1)).all()
    assert R.sv_block_need(np.ones((h, w), bool)).sum() == h * w


def test_spatial_variance_blocks_needing_taps():
    """sv_block_need counts, per block of kernel R's grid, the pixels
    that run the taps, as sv_tile_pixels maps pixels to blocks."""
    h, w = 37, 23
    need = np.random.default_rng(5).random((h, w)) < 0.17
    (fb, fy, fx), _ = R.sv_tile_pixels(h, w)
    want = np.bincount(fb, weights=need[fy, fx], minlength=fb.max() + 1)
    assert np.array_equal(R.sv_block_need(need), want.astype(int))
    assert R.sv_block_need(np.zeros((h, w), bool)).sum() == 0


@pytest.mark.parametrize("sigma", [0.2, 0.35, 1.0, 0.0])
def test_zero_distance_factor_is_one(sigma):
    """Kernel R's shortcut rests on the plain version's bits: a zero
    distance gives the factor min(1, exp(-0 / (sigma + 1e-6))) = 1.0
    exactly (-0 / den is -0, exp(-0) is 1, the clamp keeps 1), the value
    the kernel gives such a tap without the division and the exp."""
    den = V._sigma(sigma, "cpu")
    zero = torch.zeros(4, 3)
    d = _norm3_of(zero)
    assert torch.equal(d, torch.zeros(4)) and not torch.signbit(d).any()
    q = -d / den
    assert torch.signbit(q).all() and (q == 0).all()
    assert torch.equal(torch.exp(torch.tensor(-0.0)), torch.tensor(1.0))
    assert torch.equal(torch.clamp_max(torch.exp(q), 1.0), torch.ones(4))
    # the same on a flat patch through the plain version: equal normals
    # and positions give the weights 1 and the window's plain mean
    color = torch.rand(5, 5, 3, generator=torch.Generator().manual_seed(1))
    flat = {"position": torch.ones(5, 5, 3), "normal": torch.ones(5, 5, 3)}
    lum = reproject_luminance(color)
    mu1, mu2 = lum.mean(), (lum * lum).mean()
    got = V.spatial_variance(color, flat, sigma, sigma)[2, 2]
    assert abs(float(got) - float(torch.clamp_min(mu2 - mu1 * mu1, 0))
               ) < 1e-6


@pytest.mark.parametrize("pattern", BB.R_PATTERNS)
def test_spatial_variance_patterns_match_jax(pattern):
    """Kernel R's wrapper on the CPU (its plain version) on every history
    pattern of bounce_bench.r_pattern_args at 37x23 (the card test's
    inputs: a flat quarter of zero distances, a geometric edge) against
    the JAX functions; pixels with a history of 4 frames or more keep
    the temporal variance."""
    args = BB.r_pattern_args(37, 23, pattern, device="cpu")
    got = R.spatial_variance_fallback(*args)
    jc = jnp.asarray(args[0].numpy())
    jgb = {k: jnp.asarray(v.numpy()) for k, v in args[1].items()}
    sig = tuple(map(jnp.float32, args[2:4]))
    if len(args) == 4:
        ref = JV.spatial_variance(jc, jgb, *sig)
    else:
        ref = JV.variance_with_spatial_fallback(
            jnp.asarray(args[5].numpy()), jnp.asarray(args[4].numpy()), jc,
            jgb, *sig)
        keep = args[4] >= V.HIST_THRESHOLD
        assert torch.equal(got[keep], args[5][keep])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=VAR_ATOL)


def _windows(need, r=V.RADIUS):
    """The pixels inside the 7x7 windows of the pixels `need` (numpy)."""
    h, w = need.shape
    read = np.zeros((h, w), bool)
    for y, x in zip(*np.nonzero(need)):
        read[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = True
    return read


@pytest.mark.parametrize("pattern", BB.R_PATTERNS)
def test_spatial_variance_bound_counts_what_the_taps_read(pattern):
    """bounce_bench.r_work, kernel R's bound: the output, the history
    and the temporal variance once a pixel, color, position and normal
    once for each pixel inside a tapping pixel's window (r_read), 40
    operations a tap, on every history pattern at 37x23."""
    args = BB.r_pattern_args(37, 23, pattern, device="cpu")
    need = BB.r_need(args)
    read = _windows(need.numpy())
    assert np.array_equal(BB.r_read(need).numpy(), read)
    hw = 37 * 23
    per_pixel = 4 + (8 if len(args) > 4 else 0)
    want = BB.bound(per_pixel * hw + 36 * int(read.sum()),
                    int(need.sum()) * 49 * BB.SPATIAL_TAP_OPS)
    assert BB.r_work(args, torch.zeros(37, 23), need) == want


@pytest.mark.parametrize("size", [(9, 7), (16, 5)])
def test_spatial_variance_zero_pairs(size):
    """bounce_bench.r_zero_pairs counts the in-image (pixel, tap) pairs
    of kernel R's window and those whose normal, position or both
    distances are 0, as a loop over every pixel and tap does."""
    h, w = size
    args = BB.r_pattern_args(h, w, "no history", device="cpu")
    pos, nrm = (args[1][k].numpy() for k in ("position", "normal"))
    want = dict.fromkeys(("pairs", "normal_zero", "position_zero",
                          "both_zero"), 0)
    r = V.RADIUS
    for y in range(h):
        for x in range(w):
            for qy in range(max(0, y - r), min(h, y + r + 1)):
                for qx in range(max(0, x - r), min(w, x + r + 1)):
                    zn = (nrm[y, x] == nrm[qy, qx]).all()
                    zp = (pos[y, x] == pos[qy, qx]).all()
                    want["pairs"] += 1
                    want["normal_zero"] += int(zn)
                    want["position_zero"] += int(zp)
                    want["both_zero"] += int(zn and zp)
    got = BB.r_zero_pairs(args[1])
    assert got == want
    assert want["position_zero"] > h * w and want["normal_zero"] > h * w


# ---------------------------------------------------------------------------
# the native SVGF frame

@pytest.fixture(scope="module")
def svgf_inputs(scenes_dir):
    """The raw frames, G-buffers and views of 2 frames of cornell 16x16
    (the port's tracer, compat mode), as the denoiser receives them."""
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")),
                 RenderConfig(**SVGF), (16, 16), device="cpu")
    seen, real = [], r.step.denoiser.forward

    def spy(raw, gb, view, params, cam_changed=True):
        seen.append((raw.clone(), {k: v.clone() for k, v in gb.items()},
                     view.clone(), cam_changed))
        return real(raw, gb, view, params, cam_changed)
    r.step.denoiser.forward = spy
    r.render(2)
    return seen


@pytest.mark.parametrize("case", ["temporal_off", "temporal_on", "fuse_l1"])
def test_native_svgf_frame_matches_jax(svgf_inputs, case):
    """The port's SVGFDenoiser(compat=False) against the JAX package's
    make_denoise_fn(compat=False), jitted, on the same inputs, 2 frames:
    temporal off (the spatial estimate on every pixel, xla), temporal on
    (frames of history under 4: the fallback, xla) and fuse_reproject_l1
    (pallas, interpret mode: the JAX gate needs that backend), whose
    branch applies no spatial fallback, in the JAX package as in the
    port: there the native frame equals the compat one bit for bit, and
    the unfused native frame differs from it."""
    kw = dict(SVGF, compat=False,
              temporal_enable=case != "temporal_off",
              fuse_reproject_l1=case == "fuse_l1")
    backend = "pallas" if case == "fuse_l1" else "xla"
    jcfg = JConfig(backend=backend, **kw)
    den = jax.jit(make_denoise_fn(jcfg, (16, 16), interpret=True))
    state = init_denoise_state((16, 16))
    cfg = RenderConfig(**kw)
    native = SVGFDenoiser(cfg, (16, 16), "cpu")
    compat = SVGFDenoiser(cfg.replace(compat=True), (16, 16), "cpu")
    unfused = SVGFDenoiser(cfg.replace(fuse_reproject_l1=False), (16, 16),
                           "cpu")
    assert native.fuse_l1 == (case == "fuse_l1")
    params = cfg.traced_params()
    for raw, gb, view, cam_changed in svgf_inputs:
        ref, state = den(state, jnp.asarray(raw.numpy()),
                         {k: jnp.asarray(v.numpy()) for k, v in gb.items()},
                         jnp.asarray(view.numpy()), jcfg.traced_params())
        got = native(raw, gb, view, params, cam_changed).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=SVGF_ATOL)
        same = np.array_equal(
            got, compat(raw, gb, view, params, cam_changed).numpy())
        assert same == (case == "fuse_l1")
        if case == "fuse_l1":
            assert not np.array_equal(
                got, unfused(raw, gb, view, params, cam_changed).numpy())


# ---------------------------------------------------------------------------
# native frames: barycentric normals

def test_cornell_native_equals_compat(scenes_dir):
    """Cornell's one mesh, the back wall, is flat (its vertex normals are
    equal), so the normal weights do not matter there: the native frame
    equals the compat one within 1e-5 (tests/test_engine.py:215)."""
    path = scenes_dir / "cornell.txt"
    a, _ = port_render(path, trace_depth=3, denoise_enable=False)
    b, tr = port_render(path, trace_depth=3, denoise_enable=False,
                        compat=False)
    assert not tr.gi.compat and np.isfinite(b).all()
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.fixture(scope="module")
def bunny_jax_native(scenes_dir):
    return jax_render(scenes_dir / "bunny.txt", compat=False, **RAW)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_bunny_native_matches_jax(scenes_dir, bunny_jax_native, engine):
    """Bunny (smooth vertex normals) in native mode through each of the
    port's engines against one live JAX native render, 2 frames at
    32x32 depth 2, within the raw budget; the sorted frame also differs
    from compat mode's (the flag reaches the normals)."""
    path = scenes_dir / "bunny.txt"
    got, tr = port_render(path, compat=False, **RAW, **ENGINES[engine])
    assert tr.engine == engine and not tr.gi.compat
    assert tr.gi.path_scene is not None
    assert "kCompat = false" in tr.gi.path_scene
    within_raw_budget(got, bunny_jax_native)
    if engine == "sorted":
        compat, _ = port_render(path, **RAW, **ENGINES[engine])
        assert np.abs(got - compat).max() > 1e-3


# ---------------------------------------------------------------------------
# NEE toward a mesh light, and native multi-light NEE

def test_mesh_light_matches_jax(tmp_path):
    """Cornell with OBJECT 0 an emissive mesh panel (write_mesh_light):
    2 frames at 32x32 depth 2 against a live JAX render, within the raw
    budget; the NEE toward the panel adds light (the same frames with a
    shadow intensity of 0 are darker)."""
    path = write_mesh_light(tmp_path)
    got, tr = port_render(path, **RAW)
    assert tr.engine == "bounce_split" and tr.shadow_closest
    within_raw_budget(got, jax_render(path, **RAW))
    dark, _ = port_render(path, **RAW, shadow_intensity=0.0)
    assert got.mean() > dark.mean() + 0.01


def test_mesh_light_engine_choice(tmp_path):
    """With shadow_ray on, a mesh light at geom 0 takes the split engine
    whatever fuse_path, fuse_bounce and sort_rays say; with it off, the
    usual choice (wavefront.py:935-971)."""
    scene = Scene(write_mesh_light(tmp_path))

    def engine(**kw):
        return Renderer(scene, RenderConfig(**kw), (16, 16),
                        device="cpu").step.tracer.engine
    for fuse_path in (True, False):
        for fuse_bounce in (True, False):
            for sort_rays in (None, True, False):
                kw = dict(fuse_path=fuse_path, fuse_bounce=fuse_bounce,
                          sort_rays=sort_rays)
                assert engine(**kw) == "bounce_split", kw
                assert engine(compat=False, **kw) == "bounce_split", kw
    assert engine(shadow_ray=False) == "whole_path"
    assert engine(shadow_ray=False, sort_rays=True) == "sorted"


def test_two_light_native_matches_jax(tmp_path):
    """The two-light scene in native mode: each NEE lane draws a light
    from E's light table and the shadow test is the full closest hit;
    2 frames at 32x32 depth 2 against a live JAX render, within the raw
    budget. Compat mode keeps the single-light engine choice."""
    path = write_two_light(tmp_path)
    got, tr = port_render(path, compat=False, **RAW)
    assert tr.engine == "bounce_split" and tr.multi_light
    assert tr.light_geoms.tolist() == [0, 2]
    within_raw_budget(got, jax_render(path, compat=False, **RAW))
    _, compat = port_render(path, frames=1, **RAW)
    assert compat.engine == "whole_path" and not compat.multi_light


def test_two_light_native_lights_the_right_half(tmp_path):
    """tests/test_engine.py's light-selection check on the port, with 3
    frames in place of its 48 (measured: a gain of 0.038, and 0.55% apart
    with the black light), at 48x48 depth 2: native mode lights the
    floor's right half from the second light (brighter than compat
    mode's by more than 0.02), and a black second light leaves the mean
    as compat mode's within 5% (the x2 weight and the 1/2 odds cancel)."""
    def mean(path, compat):
        img, _ = port_render(path, frames=3, res=(48, 48), compat=compat,
                             **RAW)
        assert np.isfinite(img).all() and (img >= 0).all()
        return img
    path = write_two_light(tmp_path)
    a, b = mean(path, True), mean(path, False)
    assert b[24:, 24:].mean() - a[24:, 24:].mean() > 0.02
    dark = write_two_light(tmp_path, "0 0 0")
    c, d = mean(dark, True), mean(dark, False)
    assert abs(d.mean() - c.mean()) / c.mean() < 0.05


def test_light_table_planes(tmp_path):
    """E's light table on the CPU, at bounce 1 of the two-light scene:
    22 planes, the drawn index 0 or 1 with both lights drawn, no
    contribution off the NEE lanes; a table of the first light alone
    draws it on every lane."""
    r = Renderer(Scene(write_two_light(tmp_path)),
                 RenderConfig(compat=False, **RAW), (32, 32), device="cpu")
    seen, real = [], W.shade_bounce

    def spy(planes, mats, **kw):
        seen.append((planes.clone(), mats, kw))
        return real(planes, mats, **kw)
    W.shade_bounce = spy
    try:
        r.render_frame()
    finally:
        W.shade_bounce = real
    planes, mats, kw = seen[0]
    out = E.shade_bounce_plain(planes, mats, **kw)
    assert out.shape[0] == E.N_OUT + 1
    li, nee = out[E.O_LI], out[E.O_NEE] > 0.5
    assert set(li[nee].unique().tolist()) == {0.0, 1.0}
    assert bool((out[E.O_CR:E.O_CB + 1][:, ~nee] == 0).all())
    assert bool((out[E.O_CR:E.O_CB + 1][:, nee] > 0).any())
    one = E.shade_bounce_plain(planes, mats,
                               **dict(kw, lights=kw["lights"][:1]))
    assert bool((one[E.O_LI] == 0).all())
