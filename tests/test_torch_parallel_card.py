"""The row-sharded frame step on the card: kernel D's shard mode and
kernel C's row offset against their plain versions and against the
unsharded kernels' rows, and the in-process group's stitched frames
against the whole image's, at 96x96 (chip_smoke.py does this at the
main path's shapes). The file imports no JAX, so that it runs where the
card is:

    python3 -m pytest --noconftest tests/test_torch_parallel_card.py

It skips without a card. The CPU tests are tests/test_torch_parallel.py
and tests/test_torch_parallel_jax.py."""

import pytest
import torch

from ptdn_tpu_torch.app.automate import CameraAutomation
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.parallel.mesh import InProcessGroup
from ptdn_tpu_torch.parallel.sharded import (ShardedRenderer,
                                             back_projection_shards)
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from torch_card import scenes_dir  # noqa: F401 (fixture)

RES = (96, 96)      # square: a still camera reprojects within a pixel
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            trace_depth=3, atrous_nlevel=5)
ANIM_SLOW = dict(automate_camera=True, camera_speed_theta=0.4,
                 camera_speed_phi=0.08)


@pytest.fixture
def card():
    """Skip where there is no card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _padded(x, halo):
    pad = torch.zeros((halo,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([pad, x, pad])


@pytest.mark.cuda
def test_shard_kernels_match_plain_on_card(card, scenes_dir):
    """On cornell's fourth frame at 96x96: D's shard mode on 4, 8 and 16
    shards (24, 12 and 6 rows) at every level, its halo rows apart from
    its own (the G-buffer's halo 64 rows), and C's shard mode on 4, 8
    and 16 shards in both modes (the stencil on the still frame, the band
    mode on a moved view), its own rows in place and its halo rows from
    halo_pack through halo_rows, equal their plain versions and the
    unsharded kernels' rows bit for bit."""
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), RenderConfig(**SVGF),
                 RES, "cuda")
    for _ in range(3):
        r.render_frame()
    st = r.step.frame_state()
    rad, gb = r.step.tracer(r._cam[0], r._params, 3, False)
    w, h = RES
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    prev = [st["prev_normal"], st["prev_geom_id"], st["color_history"],
            st["moment_history"], st["history_length"]]
    moved = torch.eye(4, device="cuda")
    moved[0, 3] = 0.3
    for view, banded in ((st["prev_view"], False),
                         (st["prev_view"] @ moved, True)):
        args = (RES, rad.reshape(h, w, 3), gb,
                {"normal": prev[0], "geom_id": prev[1]}, view, *prev[2:],
                0.2, 0.2)
        bounds = trep.motion_bounds(RES, gb, view)
        assert bool(bounds[0]) != banded
        starts = bounds[1:].tolist() if banded else None
        want = (C._back_projection_banded_kernel(
            *args, bounds[1:], trep.BAND_ROWS, trep.BAND_MARGIN) if banded
            else C._back_projection_stencil_kernel(*args))
        kfn, pfn = ((C._back_projection_banded_kernel,
                     C.back_projection_banded_plain) if banded else
                    (C._back_projection_stencil_kernel,
                     C.back_projection_stencil_plain))
        for n in (4, 8, 16):
            got = []
            for sargs, kw in back_projection_shards(args, n, starts)[0]:
                k = kfn(*sargs, **kw)
                p = pfn(*sargs, **kw)
                assert all(torch.equal(a, b) for a, b in zip(k, p))
                got.append(k)
            for i, w_ in enumerate(want):
                assert torch.equal(torch.cat([g[i] for g in got]), w_)
    var, color = want[0], want[1]
    static = D.pack_static_planes(gb["position"], gb["normal"])
    cv = torch.cat([color, var[..., None]], -1)
    sh = D.atrous_halo(5)
    for level in range(1, 6):
        want = D._atrous_level_kernel(color, var, static, None, level, 0.45,
                                      0.2, 0.35, True)
        halo = D.atrous_halo(level)
        ext, sext = _padded(cv, halo), _padded(static, sh)
        for n in (4, 8, 16):
            hl, outs = h // n, []
            for r0 in range(0, h, hl):
                own = ext[halo + r0:halo + r0 + hl]
                rows = (ext[r0:r0 + halo],
                        ext[r0 + hl + halo:r0 + hl + 2 * halo])
                dargs = (own[..., :3], own[..., 3],
                         sext[r0:r0 + hl + 2 * sh], None, level, 0.45, 0.2,
                         0.35, True, False, r0, h, rows, sh)
                k = D._atrous_level_kernel(*dargs)
                p = D.atrous_level_plain(*dargs)
                assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
                outs.append(k)
            assert torch.equal(torch.cat([o[0] for o in outs]), want[0])
            assert torch.equal(torch.cat([o[1] for o in outs]), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("cornell", {}),
                                     ("cornell", ANIM_SLOW),
                                     ("cornell", dict(compat=False)),
                                     ("room", {}), ("diamond", {})])
def test_sharded_frames_equal_unsharded_on_card(card, scenes_dir, name, kw):
    """8 shards of 12 rows in one process on the card against the whole
    image's frames, 3 frames: left and right bit for bit, D in shard
    mode at every level of every shard."""
    cfg = RenderConfig(**SVGF, **kw)
    scene = Scene(str(scenes_dir / f"{name}.txt"))
    one = Renderer(scene, cfg, RES, "cuda")
    many = ShardedRenderer(scene, cfg, RES, InProcessGroup(8), "cuda")
    autos = CameraAutomation(cfg), CameraAutomation(cfg)
    for _ in range(3):
        for r, auto in zip((one, many), autos):
            if auto.step(r.camera):
                r.cam_changed = True
        want = one.render_frame()
        before = D.atrous_level.shard_launches
        got = many.render_frame()
        assert D.atrous_level.shard_launches - before == 8 * 5
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
