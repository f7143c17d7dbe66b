"""The moved frame's glue kernels S1 (camera rays), S2 (the primary
hit's position, albedo and hit flag) and T (the motion bounds) against their plain
versions on the card, and a moved room frame's launches. The file
imports no JAX, so that it runs where the card is:

    python3 -m pytest --noconftest tests/test_torch_glue_card.py

It skips without a card. The CPU tests of the same wrappers are
tests/test_torch_glue.py."""

import pytest
import torch

from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.camera import generate_camera_rays_plain
from ptdn_tpu_torch.ops.cuda import camera as S
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from torch_card import scenes_dir  # noqa: F401 (fixture)

SVGF5 = dict(trace_depth=8, denoise_enable=True, temporal_enable=True,
             spatial_enable=True, atrous_nlevel=5)
# bench.py's room_1080p_animated camera speeds (profile_frame's)
ORBIT = dict(automate_camera=True, camera_speed_x=0.02,
             camera_speed_theta=0.01, camera_speed_phi=0.015)
# case -> (scene, resolution, moved frames, the shard's rows (row0, h)
# or None, show_texture)
CASES = {"room 1920x1080 orbit": ("room", (1920, 1080), 3, None, True),
         "cornell 800x800 moved": ("cornell", (800, 800), 1, None, True),
         "cornell 100-row shard": ("cornell", (800, 800), 1, (300, 100),
                                   True),
         "room show_texture off": ("room", (480, 270), 1, None, False)}


def same(a, b) -> bool:
    """Equal on every lane, NaN where NaN, the dtype and shape alike."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def with_misses(gb):
    """gb with miss pixels: NaN and infinite positions with and without
    geometry, and geometry -1 on pixels that had a hit."""
    pos, geom = gb["position"].clone(), gb["geom_id"].clone()
    pos[0, :7] = float("nan")
    pos[1, :7] = float("inf")
    pos[2, :7, 1] = -float("inf")
    geom[0, :3] = 0
    geom[1, :3] = 2
    geom[3:5, 10:40] = -1
    return {"position": pos, "geom_id": geom}


def check_glue(r, rows, show):
    """S1, S2 and T on renderer r's last frame (its camera moved) against
    their plain versions: on the whole image or on a shard's `rows`."""
    tr = r.step.tracer
    ds, gi, cam = tr.ds, tr.gi, r._cam[0]
    w, h = r.resolution
    row0, sh = (0, h) if rows is None else rows
    full = None if rows is None else h
    o, d = S._camera_rays_kernel(cam, (w, sh), row0, full)
    po, pd = generate_camera_rays_plain(cam, (w, sh), row0, full)
    assert same(o, po) and same(d, pd)
    isect = A.scene_intersect_full(ds, gi, o, d, hit=False)
    t = isect["t"]
    # misses: a distance of NaN and infinity, geometry -1
    t_odd = t.clone()
    t_odd[:5] = float("nan")
    t_odd[5:10] = float("inf")
    geom_odd = isect["geom_id"].clone()
    geom_odd[:7] = -1
    for tt, hit in ((t, isect), (t_odd, dict(isect, geom_id=geom_odd))):
        got = S._primary_finish_kernel(ds, o, d, tt, hit, show)
        want = S.primary_finish_plain(ds, o, d, tt, hit, show)
        assert all(same(a, b) for a, b in zip(got, want))
        pos, alb, flag = S._primary_finish_kernel(ds, o, d, tt)
        assert alb is None and flag is None and same(pos, want[0])
    assert not bool(want[2].all())
    pos, alb, hit = S.primary_finish_plain(ds, o, d, t, isect, show)
    # textured and untextured materials among the hits
    assert bool(hit.any())
    texid = ds.mat_attr[isect["mat_id"].long(), 11]
    assert bool((texid < 0).any())
    if show and tr.show_texture:
        assert bool((texid >= 0).any())
    if rows is None:
        # the frame's own position, albedo and hit flag are S2's
        assert same(tr.position, pos) and same(tr.pcache_hit, hit)
        if show == tr.show_texture:
            assert same(tr.pcache_albedo, alb)
    gb_full = {"position": tr.position.reshape(h, w, 3),
               "geom_id": tr.pcache_geom_id.reshape(h, w)}
    view = r.step.denoiser.prev_view
    eye = torch.eye(4, device=view.device)
    for gb in (gb_full, with_misses(gb_full)):
        for v in (view, eye):
            if rows is None:
                for band_rows, margin in ((64, 16), (32, 16), (7, 3)):
                    got = C._motion_kernel((w, h), gb, v, band_rows, margin)
                    want = trep.motion_bounds_plain((w, h), gb, v,
                                                    band_rows, margin)
                    assert same(got, want)
            else:
                part = {k: x[row0:row0 + sh].contiguous()
                        for k, x in gb.items()}
                got = C._motion_kernel((w, sh), part, v, 64,
                                       rows=(row0, h))
                want = trep.motion_parts_plain((w, sh), part, v, 64, row0,
                                               h)
                assert all(same(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_glue_kernels_match_plain_on_card(case, scenes_dir):
    """S1, S2 and T equal their plain versions bit for bit on every lane
    of every output: room 1920x1080 frames of an orbit, cornell 800x800
    after a move, a 100-row shard from row 300, miss pixels (NaN and
    infinite positions and distances, geometry -1), textured and
    untextured materials, show_texture off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    scene, res, frames, rows, show = CASES[case]
    cfg = RenderConfig(**SVGF5, **ORBIT, show_texture=show)
    r = Renderer(Scene(str(scenes_dir / f"{scene}.txt")), cfg, res, "cuda")
    auto = CameraAutomation(cfg)
    r.render_frame()
    for _ in range(frames):
        auto.step(r.camera)
        r.cam_changed = True
        r.render_frame()
        check_glue(r, rows, show)


@pytest.mark.cuda
def test_moved_room_frame_launches_the_glue_once(scenes_dir):
    """A moved room 1920x1080 frame launches A, S1, S2 and T once each,
    every kernel as chip_smoke.expected_launches counts it, and inside
    the camera and motion spans nothing else (no fp.fma chain); a
    restored state's frame launches S1 and S2 (its position) alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import chip_smoke
    from ptdn_tpu_torch.profile_frame import profiled

    cfg = RenderConfig(**SVGF5, **ORBIT)
    r = Renderer(Scene(str(scenes_dir / "room.txt")), cfg, (1920, 1080),
                 "cuda")
    motion = chip_smoke.Motion(r)
    motion.frame()
    chip_smoke.reset_counts()
    motion = chip_smoke.Motion(r)
    for _ in range(3):
        motion.frame()
    torch.cuda.synchronize()
    got = chip_smoke.counts()
    assert got == chip_smoke.expected_launches(r, motion)
    assert all(got[k] == 3 for k in ("scene_intersect_full", "camera_rays",
                                     "primary_finish", "motion_bounds"))
    step, auto = r.render_frame, CameraAutomation(cfg)

    def moved():
        auto.step(r.camera)
        r.cam_changed = True
        return step()
    r.render_frame = moved
    st, _ = profiled(r, 2)
    camera = sorted(n for n, _, c in st.kernels if "ptdn.tracer.camera" in c)
    assert camera == sorted(["camera_rays_kernel", "primary_finish_kernel",
                             "scene_intersect_full_kernel"] * 2)
    assert [n for n, _, c in st.kernels
            if "ptdn.denoiser.motion" in c] == ["motion_kernel"] * 2
    # a restored state remakes its rays and position, not its hit
    r.render_frame = step
    state = {k: v.clone() for k, v in r.step.frame_state().items()}
    r.step.load_frame_state(state)
    chip_smoke.reset_counts()
    r.render_frame()
    torch.cuda.synchronize()
    got = chip_smoke.counts()
    assert (got["camera_rays"], got["primary_finish"],
            got["scene_intersect_full"]) == (1, 1, 0)
