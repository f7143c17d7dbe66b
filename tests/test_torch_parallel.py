"""The row-sharded frame step (ptdn_tpu_torch/parallel/) on the CPU: the
in-process group's halos against the directly computed rows, kernel D's
shard mode and kernel C's row offset (plain versions) against the
unsharded passes' rows, the stitched sharded frame against the whole
image's in every branch, and two gloo ranks against the in-process
group; all bit for bit (torch.equal). The comparisons with the JAX
package are tests/test_torch_parallel_jax.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.parallel import sharded as S
from ptdn_tpu_torch.parallel.dryrun import CFG as DRYRUN_CFG
from ptdn_tpu_torch.parallel.dryrun import run_ranks
from ptdn_tpu_torch.parallel.halo import halo_rows
from ptdn_tpu_torch.parallel.mesh import InProcessGroup
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_kernels import _reproj_inputs
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)
from test_torch_motion import _motion_args, _torch

RES = (64, 64)       # W x H: 8 shards of 8 rows
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True)
# name: (scene, config, frames, the engine the scene takes)
SLICES = {
    "cornell_svgf_d3": ("cornell", dict(SVGF, trace_depth=3,
                                        atrous_nlevel=3), 2, "whole_path"),
    # level 5's 64-row halo spans the eight 8-row shards
    "cornell_svgf_l5": ("cornell", dict(SVGF, trace_depth=2,
                                        atrous_nlevel=5), 2, "whole_path"),
    "room_sorted_l2": ("room", dict(SVGF, trace_depth=2, atrous_nlevel=2),
                       2, "sorted"),
    "diamond_raw": ("diamond", dict(denoise_enable=False, trace_depth=2), 2,
                    "sorted"),
    "cornell_native": ("cornell", dict(SVGF, trace_depth=3, atrous_nlevel=3,
                                       compat=False), 3, "whole_path"),
    # the camera moves every frame: C's band mode, one 64-row band across
    # every shard
    "cornell_anim_slow": ("cornell", dict(SVGF, trace_depth=3,
                                          atrous_nlevel=3,
                                          automate_camera=True,
                                          camera_speed_theta=0.4,
                                          camera_speed_phi=0.08), 3,
                          "whole_path"),
}


def _padded(x, halo):
    pad = torch.zeros((halo,) + tuple(x.shape[1:]), dtype=x.dtype)
    return torch.cat([pad, x, pad])


# ---------------------------------------------------------------------------
# halos

@pytest.mark.parametrize("halo", [4, 8, 24])
def test_halo_rows_in_process(halo):
    """halo_rows on the in-process group (h = 64, 8 shards of 8 rows;
    24 rows take three hops) against the image's rows above and below
    each shard, zeros past the image (tests/test_sharding.py:196-221)."""
    h, w, n = 64, 16, 8
    x = torch.arange(h * w, dtype=torch.float32).reshape(h, w)
    slabs = list(x.reshape(n, h // n, w))
    tops, bottoms = halo_rows(InProcessGroup(n), slabs, halo)
    padded = _padded(x, halo)
    for i, (t, s, b) in enumerate(zip(tops, slabs, bottoms)):
        want = padded[i * 8:i * 8 + 8 + 2 * halo]
        assert torch.equal(torch.cat([t, s, b]), want)


# ---------------------------------------------------------------------------
# kernel D's shard mode

@pytest.fixture(scope="module")
def atrous_inputs():
    """tests/test_torch_kernels.py's atrous_inputs: a 64x48 image."""
    r = np.random.default_rng(3)
    h, w = 64, 48
    x = {"color": r.uniform(size=(h, w, 3)),
         "variance": r.uniform(size=(h, w)),
         "position": r.normal(size=(h, w, 3)),
         "normal": r.normal(size=(h, w, 3)),
         "albedo": r.uniform(size=(h, w, 3))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in x.items()}


def atrous_shards(x, hl, level, blur, albedo):
    """Kernel D's shard mode (plain) on each hl-row shard of the image,
    its inputs extended by the image's rows (zeros past it): the halo
    the level's taps reach, the G-buffer's level 5's."""
    h = x["variance"].shape[0]
    halo, sh = D.atrous_halo(level), D.atrous_halo(5)
    cv = _padded(torch.cat([x["color"], x["variance"][..., None]], -1),
                 halo)
    static = _padded(D.pack_static_planes(x["position"], x["normal"]), sh)
    out = []
    for r0 in range(0, h, hl):
        ext = cv[r0:r0 + hl + 2 * halo]
        out.append(D.atrous_level(
            ext[..., :3], ext[..., 3], static[r0:r0 + hl + 2 * sh],
            x["albedo"][r0:r0 + hl] if albedo else None, level, 0.45, 0.2,
            0.35, blur, row0=r0, full_h=h, halo=halo, static_halo=sh))
    return out


@pytest.mark.parametrize("hl", [16, 8])
@pytest.mark.parametrize("level,blur,albedo", [
    (1, True, False), (2, True, False), (3, True, False), (4, True, False),
    (5, True, False), (1, False, False), (3, False, False),
    (5, False, False), (5, True, True)])
def test_atrous_shard_mode_equals_unsharded(atrous_inputs, hl, level, blur,
                                            albedo):
    """D's shard mode on shards of 16 and 8 rows of a 64x48 image, levels
    1-5 with and without the variance blur and level 5 with the albedo,
    against the unsharded level's rows: bit for bit."""
    x = atrous_inputs
    want = D.atrous_level(x["color"], x["variance"],
                          D.pack_static_planes(x["position"], x["normal"]),
                          x["albedo"] if albedo else None, level, 0.45, 0.2,
                          0.35, blur)
    got = atrous_shards(x, hl, level, blur, albedo)
    assert torch.equal(torch.cat([g[0] for g in got]), want[0])
    assert torch.equal(torch.cat([g[1] for g in got]), want[1])


def test_atrous_shard_mode_checks_its_halos():
    """A halo short of the level's reach, or a G-buffer halo short of the
    color's, is refused."""
    ext = torch.zeros((8 + 2 * 4, 48, 4))
    static = torch.zeros((8 + 2 * 8, 48, 8))
    with pytest.raises(ValueError):
        D.atrous_level(ext[..., :3], ext[..., 3], static, None, 2, 0.45,
                       0.2, 0.35, True, row0=8, full_h=64, halo=4,
                       static_halo=8)
    with pytest.raises(ValueError):
        D.atrous_level(ext[..., :3], ext[..., 3], static[4:-4], None, 1,
                       0.45, 0.2, 0.35, True, row0=8, full_h=64, halo=4,
                       static_halo=2)


# ---------------------------------------------------------------------------
# kernel C's row offset

def _shard_reproj(args, hl, banded, starts=None):
    """Kernel C (plain) on each hl-row shard of `args` (the unsharded
    call's arguments): the shard's current rows, the previous frame's
    stencil window (two rows past the shard, zeros past the image) or
    the whole previous frame for the band mode."""
    (w, h), color, gb, prev_gb, view, ch, mh, hl_prev, ca, ma = args
    prev = [prev_gb["normal"], prev_gb["geom_id"], ch, mh, hl_prev]
    outs = []
    for r0 in range(0, h, hl):
        cur = slice(r0, r0 + hl)
        if banded:
            win, p0 = prev, 0
        else:
            win, p0 = [_padded(t, 2)[r0:r0 + hl + 4] for t in prev], r0 - 2
        sargs = ((w, hl), color[cur], {k: v[cur] for k, v in gb.items()},
                 {"normal": win[0], "geom_id": win[1]}, view, win[2], win[3],
                 win[4], ca, ma)
        if banded:
            outs.append(C.back_projection_banded(
                *sargs, starts, trep.BAND_ROWS, trep.BAND_MARGIN,
                rows=(r0, h, p0)))
        else:
            outs.append(C.back_projection_stencil(*sargs, rows=(r0, h, p0)))
    return [torch.cat([o[k] for o in outs]) for k in range(4)]


@pytest.mark.parametrize("hl", [8, 20])
def test_stencil_row_offset_equals_unsharded(hl):
    """C's stencil mode with a row offset on shards of test_torch_kernels'
    40x48 still-camera inputs against the unsharded pass's rows: bit for
    bit, every output."""
    res, cur, st = _reproj_inputs(7)
    t = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    gb = {k: torch.from_numpy(cur[k]) for k in ("position", "normal",
                                                 "geom_id")}
    args = (res, torch.from_numpy(cur["color"]), gb,
            {"normal": t["prev_normal"], "geom_id": t["prev_geom_id"]},
            t["prev_view"], t["color_history"], t["moment_history"],
            t["history_length"], 0.2, 0.2)
    assert bool(trep.motion_bounds(res, gb, t["prev_view"])[0])
    want = C.back_projection_stencil(*args)
    for g, w_ in zip(_shard_reproj(args, hl, False), want):
        assert torch.equal(g, w_)


def test_band_row_offset_equals_unsharded():
    """C's band mode with a row offset on 4 shards of 48 rows of a
    192x48 pan with one pixel flowing 40 rows down (out of its band's
    slab: rejected); bands of 64 rows straddle the shards. Each shard's
    motion parts reduced over the group give motion_bounds' flag and
    band starts; the shards' rows equal the unsharded pass's: bit for
    bit."""
    h, w = 192, 48
    dy = np.zeros((h, w), np.float32)
    dy[60, 7] = 40.0
    dx = np.full((h, w), 3.0, np.float32)
    args = _torch(_motion_args(h, w, dy, dx))
    res, _, gb, _, view = args[:5]
    want_bounds = trep.motion_bounds(res, gb, view)
    group = InProcessGroup(4)
    parts = [trep.motion_parts((w, 48), {k: v[r0:r0 + 48]
                                         for k, v in gb.items()},
                               view, trep.BAND_ROWS, r0, h)
             for r0 in range(0, h, 48)]
    reach = group.reduce([p[0] for p in parts], "max")
    sums = group.reduce([torch.stack(p[1:]) for p in parts], "sum")
    bounds = trep.bounds_from_parts(reach, sums[0], sums[1], h)
    assert torch.equal(bounds, want_bounds) and not bool(bounds[0])
    want = C.back_projection_banded(*args, bounds[1:], trep.BAND_ROWS,
                                    trep.BAND_MARGIN)
    assert int(want[3][60, 7]) == 1
    for g, w_ in zip(_shard_reproj(args, 48, True, bounds[1:]), want):
        assert torch.equal(g, w_)


def test_row_offset_refuses_a_short_window():
    """The previous rows must hold every row the taps may read."""
    res, cur, st = _reproj_inputs(7)
    t = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    gb = {k: torch.from_numpy(cur[k][8:16]) for k in ("position", "normal",
                                                       "geom_id")}
    args = ((48, 8), torch.from_numpy(cur["color"][8:16]), gb,
            {"normal": t["prev_normal"][8:16],
             "geom_id": t["prev_geom_id"][8:16]}, t["prev_view"],
            t["color_history"][8:16], t["moment_history"][8:16],
            t["history_length"][8:16], 0.2, 0.2)
    with pytest.raises(ValueError):
        C.back_projection_stencil(*args, rows=(8, 40, 8))


# ---------------------------------------------------------------------------
# the slice

def _frames(renderer, cfg, frames):
    auto = CameraAutomation(cfg)
    out = []
    for _ in range(frames):
        if auto.step(renderer.camera):
            renderer.cam_changed = True
        out.append(renderer.render_frame())
    return out


@pytest.mark.parametrize("name", sorted(SLICES))
def test_sharded_frames_equal_unsharded(scenes_dir, name):
    """8 shards of 8 rows in one process, at 64x64 on the CPU, against
    the whole image's frames: left and right bit for bit on every frame
    (tests/test_sharding.py's configs: cornell with temporal SVGF at 3
    and 5 levels, room through the sorted engine, diamond's raw frame
    through G; and cornell in native mode (R) and with the anim_slow
    camera (C's band mode)). The image is square, where a still camera
    reprojects within a pixel: frame 0 takes C's band mode, the still
    frames after it C's stencil mode (at test_sharding.py's 48x64 every
    frame takes the band mode)."""
    scene_name, kw, frames, engine = SLICES[name]
    scene = Scene(str(scenes_dir / f"{scene_name}.txt"))
    cfg = RenderConfig(**kw)
    want = _frames(Renderer(scene, cfg, RES, device="cpu"), cfg, frames)
    r = S.ShardedRenderer(scene, cfg, RES, InProcessGroup(8), device="cpu")
    assert all(s.tracer.engine == engine for s in r.step.steps)
    got = _frames(r, cfg, frames)
    for (gl, gr), (wl, wr) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gr, wr)
    if cfg.temporal_enable and cfg.denoise_enable:
        # the last frame's branch: near (C's stencil) unless the camera
        # moves
        assert r.step.steps[0].denoiser.near == (not cfg.automate_camera)


def test_sharded_step_returns_shard_rows(scenes_dir):
    """forward gives each shard's (left, right) rows, gather the image,
    frame_state the image's state (the whole image's, bit for bit); the
    shards share one scene build."""
    scene = Scene(str(scenes_dir / "cornell.txt"))
    cfg = RenderConfig(**SLICES["cornell_svgf_d3"][1])
    step = S.make_sharded_step(scene, cfg, RES, InProcessGroup(8), "cpu")
    one = Renderer(scene, cfg, RES, device="cpu")
    one.render_frame()
    cam, vm = one._cam
    outs = step(cam, vm, cfg.traced_params(), 0, True)
    assert len(outs) == 8
    assert all(o[1].shape == (8, 64, 3) for o in outs)
    left, right = step.gather(outs)
    assert left.shape == right.shape == (64, 64, 3)
    state, want = step.frame_state(), one.step.frame_state()
    assert state.keys() == want.keys()
    for k in want:
        assert torch.equal(state[k], want[k]), k
    tracers = [s.tracer for s in step.steps]
    assert all(t.gi is tracers[0].gi for t in tracers)
    assert all(t.mat_attr is tracers[0].mat_attr for t in tracers)


def test_uneven_height_rejected(scenes_dir):
    scene = Scene(str(scenes_dir / "cornell.txt"))
    with pytest.raises(ValueError):
        S.make_sharded_step(scene, RenderConfig(), (48, 31),
                            InProcessGroup(8), "cpu")


def test_sharded_step_on_cuda_without_card_raises(scenes_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        S.make_sharded_step(Scene(str(scenes_dir / "cornell.txt")),
                            RenderConfig(), (48, 64), InProcessGroup(8))


def test_two_gloo_ranks_equal_in_process(scenes_dir, tmp_path):
    """Two torch.distributed ranks over gloo on the CPU, each holding one
    32-row shard of a 32x64 cornell frame (2 frames, 5 levels: level 5's
    64-row halo spans both shards and the image's edge), rendezvousing
    through a file in tmp_path, within 240 s: the stitched frame equals
    the in-process group's bit for bit."""
    res = (32, 64)
    got = run_ranks(2, "cornell", DRYRUN_CFG, res, 2, "cpu", timeout=240,
                    tmp=str(tmp_path))
    r = S.ShardedRenderer(Scene(str(scenes_dir / "cornell.txt")),
                          RenderConfig(**DRYRUN_CFG), res, InProcessGroup(2),
                          device="cpu")
    r.render_frame()
    want = r.render_frame()
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())
