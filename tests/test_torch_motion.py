"""The camera-motion slice of the port against the JAX package: the
banded far branch of the reprojection (kernel C's band mode), kernel L
(back-projection fused with the à-trous level 1) and kernel M (the
unmerged closest hits) through their plain PyTorch versions against the
JAX functions they port (Pallas kernels in interpret mode), the
fuse_reproject_l1 frame, the animated goldens through the port's own
CameraAutomation, the renderer's set_config, and, on a card only, each
kernel against its plain version."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.app.automate import CameraAutomation as JAutomation
from ptdn_tpu.denoise import reproject as jrep
from ptdn_tpu.ops.camera import OrbitCamera as JCam
from ptdn_tpu.ops.pallas.reproject_atrous import \
    back_projection_atrous1_pallas
from ptdn_tpu.ops.pallas.scene_intersect import scene_intersect_pallas
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu_torch import interop
from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.camera import OrbitCamera
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import reproject_atrous as L
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
_SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
             trace_depth=3, atrous_nlevel=3)
# tests/test_golden.py's animated pallas configs, and cornell_svgf_d3's
# budgets there
ANIM = {"cornell_svgf_anim_slow": dict(_SVGF, automate_camera=True,
                                       camera_speed_theta=0.4,
                                       camera_speed_phi=0.08),
        "cornell_svgf_anim_fast": dict(_SVGF, automate_camera=True,
                                       camera_speed_theta=0.5,
                                       camera_speed_phi=2.1,
                                       camera_speed_y=1.8)}
FRAC_BUDGET, RMSE_BUDGET = 0.06, 0.012
SIG = (0.45, 0.2, 0.35)


def _motion_args(h, w, dy, dx, seed=13):
    """tests/test_denoise.py:_motion_args as numpy: reprojection inputs
    with a prescribed per-pixel displacement (dy, dx) in pixels."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = xs + 0.5 + dx
    py = ys + 0.5 + dy
    z = -np.ones_like(px, np.float32)
    vx = -((px + 0.5) / w - 0.5) * 2.0
    vy = -((py + 0.5) / h - 0.5) * 2.0
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    gb_c = {"position": np.stack([vx, vy, z], -1).astype(np.float32),
            "normal": nrm,
            "geom_id": rng.integers(-1, 3, size=(h, w)).astype(np.int32)}
    gb_p = {"position": gb_c["position"],
            "normal": nrm + 0.01 * rng.normal(size=(h, w, 3)).astype(
                np.float32),
            "geom_id": rng.integers(-1, 3, size=(h, w)).astype(np.int32)}
    color = rng.uniform(size=(h, w, 3)).astype(np.float32)
    ch = rng.uniform(size=(h, w, 3)).astype(np.float32)
    mh = rng.uniform(size=(h, w, 2)).astype(np.float32)
    hl = rng.integers(0, 6, size=(h, w)).astype(np.int32)
    return [(w, h), color, gb_c, gb_p, vm, ch, mh, hl, 0.2, 0.2]


def _stencil_args():
    """tests/test_denoise.py's stencil_args domain: 24x24, every
    reprojection sub-pixel-jittered around its pixel centre (kernel L's
    domain)."""
    rng = np.random.default_rng(7)
    jy, jx = (rng.uniform(-0.45, 0.45, size=(24, 24)).astype(np.float32)
              for _ in range(2))
    return _motion_args(24, 24, jy, jx, seed=7)


def _as(args, conv):
    """The argument list with every array converted by conv (the scalars
    alphas stay float32 scalars)."""
    def one(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return conv(x) if isinstance(x, np.ndarray) else x
    return [one(x) for x in args]


def _jax(args):
    out = _as(args, jnp.asarray)
    out[-2:] = [jnp.float32(a) for a in args[-2:]]
    return out


def _torch(args):
    return _as(args, lambda x: torch.from_numpy(np.array(x)))


def _close(got, ref, atol, names=("variance", "color", "moments")):
    for g, r, name in zip(got, ref, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=atol,
                                   atol=atol, err_msg=name)


def test_far_branch_rejects_outside_band_slab():
    """A 3 px pan with one pixel (row 60, col 7) flowing 40 px down: the
    pixel's base row leaves its band's slab, so the JAX package's
    back_projection_auto (banded far branch) restarts its history
    (history 1, variance 100); the port's far branch must too, and agree
    everywhere else (history equal, the rest to 1e-5)."""
    h, w = 192, 48
    dy = np.zeros((h, w), np.float32)
    dy[60, 7] = 40.0
    dx = np.full((h, w), 3.0, np.float32)
    args = _motion_args(h, w, dy, dx)
    for gb in (args[2], args[3]):
        gb["geom_id"] = np.ones((h, w), np.int32)
        gb["normal"] = np.broadcast_to(np.float32([0, 0, 1]),
                                       (h, w, 3)).copy()
    args[7] = np.full((h, w), 3, np.int32)
    ref = jrep.back_projection_auto(*_jax(args))
    got = trep.back_projection_auto(*_torch(args))
    assert int(np.asarray(ref[3])[60, 7]) == 1
    assert float(np.asarray(ref[0])[60, 7]) == 100.0
    assert int(got[3][60, 7]) == 1 and float(got[0][60, 7]) == 100.0
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("case", ["fast_pan", "residual_overflow"])
def test_back_projection_banded_matches_jax(case):
    """The port's back_projection_banded (kernel C's band mode, plain)
    against the JAX function on tests/test_denoise.py's two motion cases
    (band_rows 32, margin 16): a 40 px/frame pan with +-8 px scatter, and
    a lone 30 px outlier that its band's slab rejects."""
    if case == "fast_pan":
        rng = np.random.default_rng(17)
        h, w = 70, 48
        dy = (40.0 + rng.uniform(-8, 8, size=(h, w))).astype(np.float32)
        dx = (-25.0 + rng.uniform(-30, 30, size=(h, w))).astype(np.float32)
        args = _motion_args(h, w, dy, dx)
    else:
        h, w = 64, 48
        dy = np.zeros((h, w), np.float32)
        dy[5, 7] = 30.0
        args = _motion_args(h, w, dy, np.zeros((h, w), np.float32), seed=19)
        args[2]["geom_id"][5, 7] = 1
    ref = jrep.back_projection_banded(*_jax(args), band_rows=32, margin=16)
    got = trep.back_projection_banded(*_torch(args), band_rows=32,
                                      margin=16)
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    _close(got, ref, 1e-5)
    if case == "residual_overflow":
        assert int(got[3][5, 7]) == 1 and float(got[0][5, 7]) == 100.0


def test_motion_bounds_band_starts_match_jax():
    """motion_bounds' flag and band starts from one reprojection: the
    flag as the JAX motion_bounds' near, the starts as the slab starts
    the JAX banded path computes (s_b rounded half up, clipped)."""
    rng = np.random.default_rng(5)
    h, w = 150, 40
    dy = (-20.0 + rng.uniform(-3, 3, size=(h, w))).astype(np.float32)
    dy[100:] = 7.5
    args = _motion_args(h, w, dy, np.ones((h, w), np.float32))
    ja, ta = _jax(args), _torch(args)
    bounds = trep.motion_bounds(ta[0], ta[2], ta[4], 64, 16)
    near, _ = jrep.motion_bounds(ja[0], ja[2], ja[4])
    assert not bool(near) and not bool(bounds[0])
    fx, fy, _, _, _ = jrep._reproj_base(ja[0], ja[2]["position"], ja[4])
    valid = args[2]["geom_id"] >= 0
    dyv = np.where(valid, np.asarray(fy) - np.arange(h)[:, None], 0)
    want = []
    for b in range(-(-h // 64)):
        r0, r1 = b * 64, min((b + 1) * 64, h)
        cnt = np.float32(max(valid[r0:r1].sum(), 1))
        s_b = int(np.floor(np.float32(dyv[r0:r1].sum()) / cnt
                           + np.float32(0.5)))
        want.append(int(np.clip(r0 + s_b - 16, 0, h + 2 - (64 + 33))))
    assert bounds[1:].tolist() == want


@pytest.mark.parametrize("blur", [False, True])
def test_back_projection_atrous1_matches_pallas(blur):
    """Kernel L's plain version (C's, then D's at level 1) against
    back_projection_atrous1_pallas in interpret mode on the stencil's
    domain, to the JAX package's own tolerances
    (tests/test_denoise.py:384-392): 2e-5 color and variance, 2e-6
    moments, histories equal."""
    args = _stencil_args()
    ref = back_projection_atrous1_pallas(
        *_jax(args), sigma_l=jnp.float32(SIG[0]), sigma_n=jnp.float32(SIG[1]),
        sigma_x=jnp.float32(SIG[2]), blur_variance=blur, interpret=True)
    targs = _torch(args)
    static = D.pack_static_planes(targs[2]["position"], targs[2]["normal"])
    got = L.back_projection_atrous1(*targs, *SIG, blur, static)
    for i, (name, tol) in enumerate((("color", 2e-5), ("variance", 2e-5),
                                     ("moments", 2e-6))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=tol, err_msg=name)
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("h,w,edges_only", [
    (64, 64, False), (50, 70, False),        # every block, ragged edges
    (800, 800, True), (600, 600, True)])     # cornell's and room's edges
def test_reproject_atrous1_reads_lie_in_its_staged_tile(h, w, edges_only):
    """Kernel L's blocks, as ops/cuda/reproject_atrous.py:l_block_pixels
    mirrors its code: every pixel of the image is filtered by one block,
    and each of its 25 level-1 taps and 9 pre-blur neighbours inside the
    image is read, at the staged index the kernel computes (StagedTaps.at
    at step 2, TileIn.blur_var), from a slot that holds that very pixel.
    At 800x800 and 600x600 the blocks on the image's edges alone."""
    nby, nbx = L.l_blocks(h, w)
    n_slots = L.STAGED
    filtered = np.zeros((h, w), np.int64)
    blocks = [(by, bx) for by in range(nby) for bx in range(nbx)
              if not edges_only or by in (0, nby - 1) or bx in (0, nbx - 1)]
    for by, bx in blocks:
        (y0, x0), (y, x), (slot, sy, sx) = L.l_block_pixels(h, w, by, bx)
        holds = np.full(n_slots, -1)
        holds[slot] = sy * w + sx
        np.add.at(filtered, (y, x), 1)
        c = (y - y0) * L.SIDE + (x - x0)
        reads = [(2 * j, 2 * i, c + j * 2 * L.SIDE + i * 2)
                 for j in range(-2, 3) for i in range(-2, 3)]
        reads += [(dy, dx, (y + dy - y0) * L.SIDE + (x + dx - x0))
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        for dy, dx, k in reads:
            qy, qx = y + dy, x + dx
            inb = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
            k = k[inb]
            assert bool(((k >= 0) & (k < n_slots)).all())
            assert np.array_equal(holds[k], (qy * w + qx)[inb])
    if edges_only:
        edge = np.zeros((h, w), bool)
        edge[:L.TILE_H], edge[(nby - 1) * L.TILE_H:] = True, True
        edge[:, :L.TILE_W], edge[:, (nbx - 1) * L.TILE_W:] = True, True
        assert np.array_equal(filtered, edge.astype(np.int64))
    else:
        assert bool((filtered == 1).all())


@pytest.fixture(scope="module")
def scenes(scenes_dir):
    out = {}
    for name in ("cornell", "diamond"):
        js = JScene(str(scenes_dir / f"{name}.txt"))
        jds = js.device()
        ds = interop.device_scene_from_numpy(
            {f.name: np.asarray(getattr(jds, f.name))
             for f in dataclasses.fields(jds)}, device="cpu")
        out[name] = (js, jds, ds, A.geom_info(Scene(str(
            scenes_dir / f"{name}.txt")), "cpu"))
    return out


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 9.0],
                  size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["cornell", "diamond"])
def test_scene_intersect_matches_pallas(scenes, name, cull):
    """Kernel M's plain version against scene_intersect_pallas in
    interpret mode, 2048 seeded rays, with the chunk cull on and off
    (work, not results): geom and triangle indices equal, t and normal
    within 1e-5."""
    js, jds, ds, gi = scenes[name]
    o, d = _rays(2048, 1)
    ref = scene_intersect_pallas(jds, js.geom_types, jnp.asarray(o),
                                 jnp.asarray(d), js.n_tris, cull=cull,
                                 interpret=True)
    got = A.scene_intersect(ds, gi, torch.from_numpy(o), torch.from_numpy(d),
                            cull)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert (got["tri_m"].numpy() >= 0).sum() > 20
    for k in ("geom_a", "tri_m"):
        assert np.array_equal(got[k].numpy(), ref[k]), k
    for k in ("t_a", "normal_a", "t_m"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _render(scenes_dir, cfg, frames=3, res=(64, 64)):
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), cfg, res,
                 device="cpu")
    auto = CameraAutomation(cfg)
    for _ in range(frames):
        if auto.step(r.camera):
            r.cam_changed = True
        left, right = r.render_frame()
    return r, left.numpy(), right.numpy()


def test_fused_l1_frame_equals_unfused(scenes_dir):
    """Cornell 64x64, 3 frames of SVGF with fuse_reproject_l1 (frame 0
    far: C's band mode, then D at level 1; frames 1-2 near: L) equal bit
    for bit to the frames without it: L's plain version is C's then D's,
    and level 1's output feeds the color history either way."""
    fused, fl, fr = _render(scenes_dir, RenderConfig(
        **_SVGF, fuse_reproject_l1=True))
    plain, pl_, pr = _render(scenes_dir, RenderConfig(**_SVGF))
    assert fused.step.denoiser.fuse_l1 and not plain.step.denoiser.fuse_l1
    assert np.array_equal(fl, pl_) and np.array_equal(fr, pr)
    for k in ("color_history", "moment_history", "history_length"):
        assert torch.equal(getattr(fused.step.denoiser, k),
                           getattr(plain.step.denoiser, k)), k


def test_fused_l1_gate():
    """The gate of the JAX package, term for term, w <= 1024 included:
    the port takes the same path as the JAX package on the same config."""
    from ptdn_tpu_torch.denoise.svgf import SVGFDenoiser

    on = dict(_SVGF, fuse_reproject_l1=True)
    cases = [({}, (64, 64), True), ({}, (1025, 8), False),
             ({}, (1024, 8), True), (dict(atrous_nlevel=1), (64, 64), False),
             (dict(history_level=2), (64, 64), False),
             (dict(right_view_option=1), (64, 64), False),
             (dict(temporal_enable=False), (64, 64), False),
             (dict(spatial_enable=False), (64, 64), False)]
    for kw, res, want in cases:
        den = SVGFDenoiser(RenderConfig(**dict(on, **kw)), res, "cpu")
        assert den.fuse_l1 == want, (kw, res)


@pytest.mark.parametrize("name", sorted(ANIM))
def test_animated_frames_match_pallas_golden(scenes_dir, name):
    """The port with its own CameraAutomation against the JAX pallas
    backend's animated goldens (the camera moves every frame: the far
    branch runs on all 3), within cornell_svgf_d3's budgets."""
    _, left, right = _render(scenes_dir, RenderConfig(**ANIM[name]))
    g = np.load(os.path.join(GOLDEN, f"{name}.pallas.npz"))
    for img, ref in ((left, g["left"]), (right, g["right"])):
        diff = np.abs(img - ref).max(axis=-1)
        assert (diff > 1e-3).mean() < FRAC_BUDGET
        assert np.sqrt(((img - ref) ** 2).mean()) < RMSE_BUDGET


def test_camera_automation_matches_jax(scenes_dir):
    """Ten steps of both automations on both cameras: look-at, theta and
    phi equal after each."""
    cfg = RenderConfig(**ANIM["cornell_svgf_anim_fast"], camera_speed_x=0.3,
                       camera_speed_z=0.7)
    spec = Scene(str(scenes_dir / "cornell.txt")).camera
    jspec = JScene(str(scenes_dir / "cornell.txt")).camera
    cam, jcam = OrbitCamera(spec, (64, 64)), JCam(jspec, resolution=(64, 64))
    auto, jauto = CameraAutomation(cfg), JAutomation(cfg)
    for _ in range(10):
        assert auto.step(cam) and jauto.step(jcam)
        assert np.array_equal(cam.look_at, jcam.look_at)
        assert cam.theta == jcam.theta and cam.phi == jcam.phi
    assert not CameraAutomation(RenderConfig()).step(cam)


def test_set_config_rebuilds_on_structural_change(scenes_dir):
    """set_config keeps the frame step on a continuous change (only the
    parameters move) and rebuilds it, with a state reset, on a
    structural one; the camera controls mark the camera changed."""
    cfg = RenderConfig(**_SVGF)
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), cfg, (16, 16),
                 device="cpu")
    r.render_frame()
    step = r.step
    r.set_config(dataclasses.replace(cfg, sigma_l=0.9))
    assert r.step is step and r.frame == 1
    assert r._params["sigma_l"] == np.float32(0.9)
    r.set_config(dataclasses.replace(cfg, sigma_l=0.9, atrous_nlevel=2))
    assert r.step is not step and r.frame == 0
    for move in (lambda: r.orbit(0.1, 0.1), lambda: r.dolly(0.5),
                 lambda: r.pan((0.1, 0.0, 0.0)), r.reset_camera):
        r.cam_changed = False
        move()
        assert r.cam_changed
    r.render_frame()


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
