"""The moved frame's glue on the CPU: kernels S1, S2 and T
(csrc/motion.cu) have no CPU build, so CPU tensors take their plain
versions, the PyTorch code the kernels replace on the card, unchanged.
These tests hold the wrappers' CPU path to those plain versions bit for
bit (and to the composition the tracer ran before the kernels), and the
ctypes mirrors to the source. The kernels' card tests are
tests/test_torch_glue_card.py."""

import ctypes
import re

import pytest
import torch

from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops import camera as cam_ops
from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda import camera as S
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.ops.fp import fma
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig

RES = (48, 40)


@pytest.fixture(autouse=True, scope="module")
def torch_on_one_thread():
    """The plain versions' torch ops on one thread (as
    tests/test_torch_mesh.py's fixture: the suite's workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moved(scenes_dir):
    """A CPU renderer of cornell (textured) whose camera moved on its
    last frame."""
    cfg = RenderConfig(trace_depth=2, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=2)
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), cfg, RES, "cpu")
    r.render_frame()
    r.orbit(dphi=0.05, dtheta=0.03)
    r.render_frame()
    return r


def launches():
    return (S.camera_rays.launches, S.primary_finish.launches,
            C.motion_bounds.launches, C.motion_bounds.row_launches)


def same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def gbuffer(r):
    tr = r.step.tracer
    w, h = r.resolution
    return {"position": tr.position.reshape(h, w, 3),
            "geom_id": tr.pcache_geom_id.reshape(h, w)}


def glue_case(r, case):
    """(the wrapper's output on the CPU, the plain version's) of `case`
    on renderer r's moved frame."""
    tr = r.step.tracer
    ds, gi, cam = tr.ds, tr.gi, r._cam[0]
    w, h = RES
    view = r.step.denoiser.prev_view
    if case == "rays":
        return (cam_ops.generate_camera_rays(cam, RES),
                cam_ops.generate_camera_rays_plain(cam, RES))
    if case == "rays of a shard":
        return (cam_ops.generate_camera_rays(cam, (w, 10), 8, h),
                cam_ops.generate_camera_rays_plain(cam, (w, 10), 8, h))
    o, d = tr.ray_o, tr.ray_d
    isect = A.scene_intersect_full(ds, gi, o, d, hit=False)
    if case in ("finish", "finish, show_texture off"):
        show = case == "finish"
        return (S.primary_finish(ds, o, d, isect["t"], isect, show),
                (fma(isect["t"][:, None], d, o),
                 S.albedo_from(ds, isect["mat_id"], isect["uv"], show),
                 isect["geom_id"] >= 0))
    if case == "finish, restored":
        return (S.primary_finish(ds, o, d, tr.pcache_t)[:1],
                (fma(tr.pcache_t[:, None], d, o),))
    gb = gbuffer(r)
    if case == "bounds":
        return ((trep.motion_bounds(RES, gb, view),),
                (trep.bounds_from_parts(*trep.motion_parts_plain(
                    RES, gb, view), h),))
    assert case == "parts of a shard"
    rows = {k: v[8:24] for k, v in gb.items()}
    return (trep.motion_parts((w, 16), rows, view, 16, 8, h),
            trep.motion_parts_plain((w, 16), rows, view, 16, 8, h))


@pytest.mark.parametrize("case", ["rays", "rays of a shard", "finish",
                                  "finish, show_texture off",
                                  "finish, restored", "bounds",
                                  "parts of a shard"])
def test_cpu_glue_runs_the_plain_versions(moved, case):
    """On CPU tensors generate_camera_rays, primary_finish, motion_bounds
    and motion_parts give their plain versions' bits, and launch
    nothing."""
    before = launches()
    got, want = glue_case(moved, case)
    assert launches() == before
    assert len(got) == len(want)
    assert all(same(a, b) for a, b in zip(got, want))


def test_tracer_camera_stage_on_cpu(moved):
    """The tracer's camera stage on the CPU: a moved frame's rays, hit,
    position, albedo and hit flag as the composition it ran before the
    kernels (the plain rays, kernel A's plain version, fma(t, d, o),
    albedo_from, geom_id >= 0), and a restored state's position made
    again from the restored hit."""
    r = moved
    tr = r.step.tracer
    ds, cam = tr.ds, r._cam[0]
    o, d = cam_ops.generate_camera_rays_plain(cam, RES)
    assert same(tr.ray_o, o) and same(tr.ray_d, d)
    isect = A.scene_intersect_full_plain(ds, tr.gi, o, d)
    for k in ("t", "normal", "uv", "mat_id", "geom_id", "hit"):
        assert same(getattr(tr, "pcache_" + k), isect[k]), k
    assert same(tr.pcache_albedo, S.albedo_from(ds, isect["mat_id"],
                                                isect["uv"],
                                                tr.show_texture))
    assert tr.show_texture and bool((ds.mat_attr[isect["mat_id"].long(),
                                                 11] >= 0).any())
    assert same(tr.position, fma(isect["t"][:, None], d, o))
    position = tr.position
    r.step.load_frame_state({k: v.clone() for k, v in
                             r.step.frame_state().items()})
    assert tr.rays_stale
    before = A.scene_intersect_full.launches
    tr(cam, r._params, 3, False)
    assert same(tr.position, position) and tr.position is not position
    assert not tr.rays_stale and A.scene_intersect_full.launches == before


def test_scene_intersect_full_hit_flag(moved):
    """scene_intersect_full's hit=False leaves the hit flag out (S2
    writes it) and every other output as it was."""
    tr = moved.step.tracer
    full = A.scene_intersect_full(tr.ds, tr.gi, tr.ray_o, tr.ray_d)
    part = A.scene_intersect_full(tr.ds, tr.gi, tr.ray_o, tr.ray_d,
                                  hit=False)
    assert "hit" not in part and set(full) == set(part) | {"hit"}
    assert all(same(full[k], part[k]) for k in part)
    assert same(full["hit"], full["geom_id"] >= 0)


def test_glue_mirrors_match_csrc():
    """The ctypes mirrors of csrc/motion.cu's argument structs
    (CameraArgs, FinishArgs in ops/cuda/camera.py; MotionArgs in
    ops/cuda/reproject.py) by name, order and type, and the kernel
    library's declared entry points by their C arguments."""
    src = (_lib.CSRC / "motion.cu").read_text()
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    for struct in (S.CameraArgs, S.FinishArgs, C.MotionArgs):
        body = re.search(rf"struct {struct.__name__} {{(.*?)\n}};", src,
                         re.S).group(1)
        fields = re.findall(r"^\s*(?:const )?((?:unsigned |long )?\w+)"
                            r"(\*?) (\w+);", body, re.M)
        assert [f[0] for f in struct._fields_] == [f[2] for f in fields]
        for (_, t), (base, star, _) in zip(struct._fields_, fields):
            assert t is (ctypes.c_void_p if star else ctype[base])
    for name in ("ptdn_camera_rays", "ptdn_primary_finish",
                 "ptdn_motion_bounds"):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                        re.S).group(1)
        assert len(sig.split(",")) == len(_lib.ENTRIES[name])
