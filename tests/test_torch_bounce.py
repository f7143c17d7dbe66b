"""The unsorted per-bounce engines (fuse_path=False): kernels H
(bounce_fused), I (light_visibility), J (scene_intersect_full_tex) and K
(sparse_gather) through their plain PyTorch versions against the JAX
functions they port (Pallas kernels in interpret mode, as the JAX
package's own tests run them), whole frames of both engines against the
committed goldens and the JAX package's live render, the engine choice,
and, on a card only, each kernel against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.engine import wavefront as JW
from ptdn_tpu.ops.camera import OrbitCamera as JCam
from ptdn_tpu.ops.camera import generate_camera_rays as jgen
from ptdn_tpu.ops.pallas.bounce import bounce_fused_pallas
from ptdn_tpu.ops.pallas.compact import (compact_rows_pallas,
                                         gather_compacted, sparse_gather)
from ptdn_tpu.ops.pallas.scene_intersect import (
    light_visibility_pallas, scene_intersect_full_tex_pallas)
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.ops.cuda import bounce as H
from ptdn_tpu_torch.ops.cuda import compact as K
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import _bits_equal, _scenes
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)
from test_torch_bounce_card import ENGINES, _capture_bounce  # noqa: F401

GOLDEN = "tests/golden"
# tests/test_golden.py's FRAC_BUDGET and RMSE bound for these configs
_SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
             trace_depth=3, atrous_nlevel=3)
CONFIGS = {"cornell_raw_d3": ("cornell", dict(denoise_enable=False,
                                              trace_depth=3)),
           "diamond_raw_d4": ("diamond", dict(denoise_enable=False,
                                              trace_depth=4)),
           "room_svgf_d3": ("room", _SVGF)}
FRAC_BUDGET = {"cornell_raw_d3": 0.01, "diamond_raw_d4": 0.01,
               "room_svgf_d3": 0.16}
RMSE_BUDGET = 0.012
# which engines render each config against the goldens
GOLDEN_RUNS = [("cornell_raw_d3", "bounce_fused"),
               ("cornell_raw_d3", "bounce_split"),
               ("diamond_raw_d4", "bounce_fused"),
               ("diamond_raw_d4", "bounce_split"),
               ("room_svgf_d3", "bounce_fused")]


def _light(js):
    return [float(x) for x in js.geoms[0].translation]


# ---------------------------------------------------------------------------
# kernel H


@pytest.mark.parametrize("do_next", [True, False])
@pytest.mark.parametrize("name", ["cornell", "diamond"])
def test_bounce_fused_matches_pallas(scenes_dir, name, do_next):
    """H's plain version against bounce_fused_pallas at 64x64 on a real
    bounce-2 state of the port's engine: cornell (the textured mesh wall)
    and diamond (refraction), with and without the next hit. The RNG
    draws are exact, so dif, act and the lit lanes follow the same
    branches; the shading planes (spawn, direction, throughput) agree to
    1e-4 as E's do (test_shade_bounce_matches_pallas: XLA on the CPU
    fuses the spawn point's multiply-adds, the plain version rounds each
    operation; measured: 1 ulp on ~15% of the spawn lanes, the
    throughput bit-equal). With do_next the hit (material, act) agrees
    on >= 99.9% of lanes; where the ray is bit-equal too, t, normal and uv
    agree to 1e-5 (the F test's criteria), and to 1e-4 where the ray is
    an ulp apart (measured: one lane in 4096, t 2.2e-5 off at a grazing
    hit). The lit lanes (radiance moved by the NEE add, against each
    side's do_vis=False radiance) agree on >= 99.9% (measured: all).
    Without do_next the current t, normal and material stay, uv is 0."""
    js, jds, ds = _scenes(scenes_dir, name)
    tr, (planes, kw) = _capture_bounce(scenes_dir, name)
    kw = dict(kw, do_next=do_next)
    got = H.bounce_fused(ds, tr.gi, planes, **kw).numpy()
    jp = jnp.asarray(planes.numpy())

    def ref_of(do_vis):
        pv = jnp.asarray(_light(js) + [kw["lrad"], kw["sint"],
                                       float(kw["alb_skip"]),
                                       float(do_next), 0.0], jnp.float32)
        return np.asarray(bounce_fused_pallas(
            jp, pv, jnp.asarray([kw["fd"], kw["lane0"]], jnp.uint32), jds,
            mats=JW._static_mats(js), shadow_ray=True, reduce_var=True,
            geom_types=js.geom_types, geom_mats=js.geom_material_ids,
            n_tris=js.n_tris, light_geom=0, do_vis=do_vis,
            light_emit=kw["emit"], compat=True, interpret=True))
    ref = ref_of(True)
    for k in (H.B_DIF, H.B_ACT, H.B_TR, H.B_TG, H.B_TB):
        assert _bits_equal(got[k], ref[k]), k
    for k in (H.B_SPX, H.B_SPY, H.B_SPZ, H.B_DX, H.B_DY, H.B_DZ):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=str(k))
    if not do_next:
        for b, i in ((H.B_T, 6), (H.B_NX, 7), (H.B_NY, 8), (H.B_NZ, 9),
                     (H.B_MAT, 19)):
            assert np.array_equal(got[b], planes[i].numpy())
            assert np.array_equal(ref[b], planes[i].numpy())
        assert not got[H.B_UU].any() and not got[H.B_VV].any()
        return
    agree = (got[H.B_MAT] == ref[H.B_MAT]) & (got[H.B_ACT] == ref[H.B_ACT])
    assert agree.mean() >= 0.999
    same_ray = agree & np.all([got[k] == ref[k] for k in range(6)], axis=0)
    for k in (H.B_T, H.B_NX, H.B_NY, H.B_NZ, H.B_UU, H.B_VV):
        np.testing.assert_allclose(got[k][same_ray], ref[k][same_ray],
                                   rtol=1e-5, atol=1e-5, err_msg=str(k))
        np.testing.assert_allclose(got[k][agree], ref[k][agree], rtol=1e-4,
                                   atol=1e-4, err_msg=str(k))
    base = H.bounce_fused(ds, tr.gi, planes,
                          **dict(kw, do_vis=False)).numpy()
    ref_base = ref_of(False)
    lit_got = (got[H.B_RR:H.B_RB + 1] != base[H.B_RR:H.B_RB + 1]).any(0)
    lit_ref = (ref[H.B_RR:H.B_RB + 1] != ref_base[H.B_RR:H.B_RB + 1]).any(0)
    assert lit_got.any()
    assert (lit_got == lit_ref).mean() >= 0.999


# ---------------------------------------------------------------------------
# kernels I, J and K

def _shadow_rays(js, n, seed):
    """n seeded shadow rays: origins in the scene's box, directions
    toward jittered points around the light's center, so that some see
    the light and some are occluded."""
    r = np.random.default_rng(seed)
    o = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], size=(n, 3))
    target = np.asarray(_light(js)) + r.uniform(-1.5, 1.5, size=(n, 3))
    d = target - o
    return (o.astype(np.float32),
            (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))


@pytest.mark.parametrize("name", ["cornell", "bunny"])
def test_light_visibility_matches_pallas(scenes_dir, name):
    """I's plain version against light_visibility_pallas on 4096 seeded
    shadow rays of cornell (38 triangles) and bunny (4968): equal on
    >= 99.9% of rays (measured: every ray), some lit, some occluded."""
    js, jds, ds = _scenes(scenes_dir, name)
    gi = A.geom_info(Scene(str(scenes_dir / f"{name}.txt")), "cpu")
    o, d = _shadow_rays(js, 4096, 7)
    ref = np.asarray(light_visibility_pallas(jds, js.geom_types,
                                             jnp.asarray(o), jnp.asarray(d),
                                             js.n_tris, light_geom=0,
                                             interpret=True))
    got = A.light_visibility(ds, gi, torch.from_numpy(o),
                             torch.from_numpy(d), 0).numpy()
    assert got.dtype == np.bool_ and got.shape == (4096,)
    assert (got == ref).mean() >= 0.999
    assert 0.05 < got.mean() < 0.95


def _camera_rays(js, res=(64, 64)):
    o, d = jgen(JCam(js.camera, res).frame().as_pytree(), res)
    return np.array(o), np.array(d)


@pytest.mark.parametrize("name", ["cornell", "room"])
def test_scene_intersect_full_tex_matches_pallas(scenes_dir, name):
    """J's plain version against scene_intersect_full_tex_pallas on the
    64x64 camera rays of cornell (one texture) and room (two: texid 1's
    atlas offsets): the hit as A's test holds it (geom on >= 99.9% of
    rays, material and hit there, t, normal and uv to 1e-5); the texel
    index equal to the JAX kernel's wherever the geom agrees; and the
    albedo that K reads from J's indices equal to the JAX engine's
    albedo_from_comp (the compacted indices, the tiered gather and
    uncompact_rows_pallas) there."""
    js, jds, ds = _scenes(scenes_dir, name)
    gi = A.geom_info(Scene(str(scenes_dir / f"{name}.txt")), "cpu")
    o, d = _camera_rays(js)
    ref, comp4 = scene_intersect_full_tex_pallas(
        jds, js.geom_types, js.geom_material_ids, jnp.asarray(o),
        jnp.asarray(d), js.n_tris, tuple(m.texid for m in js.materials),
        tuple((t.shape[1], t.shape[0]) for t in js.textures), 32,
        interpret=True)
    got, tidx = A.scene_intersect_full_tex(ds, gi, torch.from_numpy(o),
                                           torch.from_numpy(d))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    agree = got["geom_id"].numpy() == ref["geom_id"]
    assert agree.mean() >= 0.999
    assert np.array_equal(got["mat_id"].numpy()[agree], ref["mat_id"][agree])
    assert np.array_equal(got["hit"].numpy(), ref["hit"])
    for k in ("t", "normal", "uv"):
        np.testing.assert_allclose(got[k].numpy()[agree], ref[k][agree],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    ref_tidx = np.asarray(comp4[0]).reshape(-1)
    assert tidx.dtype == torch.int32
    assert np.array_equal(tidx.numpy()[agree], ref_tidx[agree])
    assert (ref_tidx >= 0).mean() > 0.05
    alb = K.sparse_gather(ds.tex_flat_u32.view(torch.int32), tidx,
                          got["mat_id"], ds.mat_attr).numpy().T
    mv = {"color": jds.mat_color[jnp.asarray(ref["mat_id"])]}
    ref_alb = np.asarray(JW.albedo_from_comp(jds, mv, comp4, 32,
                                             interpret=True))
    assert np.array_equal(alb[agree], ref_alb[agree])


def _index_rows(r, counts, size):
    """(len(counts), 128) int32 indices into a table of `size`: row k has
    counts[k] valid lanes at random places, -1 elsewhere."""
    idx = np.full((len(counts), 128), -1, np.int32)
    for k, c in enumerate(counts):
        lanes = r.choice(128, size=c, replace=False)
        idx[k, lanes] = r.integers(0, size, c)
    return idx


def _albedo_of(packed, idx, color):
    """The JAX engine's unpack and select after its sparse gather
    (wavefront.py:albedo_from, :141-144), as (3,) + idx.shape."""
    rgb = jnp.stack([packed & 0xFF, (packed >> 8) & 0xFF,
                     (packed >> 16) & 0xFF], axis=-1)
    tex = rgb.astype(jnp.float32) * JW.COLORDIVIDOR
    return np.moveaxis(np.asarray(jnp.where((idx >= 0)[..., None], tex,
                                            color)), -1, 0)


@pytest.mark.parametrize("rows", ["under", "tier2", "over", "empty", "full"])
def test_sparse_gather_matches_pallas(rows):
    """K's plain version against sparse_gather and gather_compacted (the
    TPU path: compact_rows_pallas, the tiered take, uncompact_rows_pallas)
    followed by the JAX engine's unpack and select, with cap 32 on 16
    rows whose valid counts stay under the cap, reach the second tier
    (<= 64), pass it on one row (the dense fallback), are all 0, or all
    128; seeded texels, materials and colors: equal on every lane."""
    r = np.random.default_rng(11)
    size = 1000
    table = r.integers(-2 ** 31, 2 ** 31 - 1, size, dtype=np.int64).astype(
        np.int32)
    counts = {"under": r.integers(0, 33, 16),
              "tier2": np.r_[r.integers(0, 33, 12), [33, 40, 63, 64]],
              "over": np.r_[r.integers(0, 65, 15), [100]],
              "empty": np.zeros(16, int), "full": np.full(16, 128)}[rows]
    idx = _index_rows(r, counts, size)
    mat = r.integers(0, 6, idx.shape).astype(np.int32)
    mat_attr = r.uniform(size=(6, 16)).astype(np.float32)
    jt, ji = jnp.asarray(table), jnp.asarray(idx)
    color = jnp.asarray(mat_attr[:, 0:3])[jnp.asarray(mat)]
    ref = _albedo_of(sparse_gather(jt, ji, 32, interpret=True), ji, color)
    cidx, slot, count = compact_rows_pallas(ji, 64, interpret=True)
    ref2 = _albedo_of(gather_compacted(jt, cidx, slot, count, 32,
                                       idx_fallback=ji, interpret=True),
                      ji, color)
    got = K.sparse_gather(torch.from_numpy(table), torch.from_numpy(idx),
                          torch.from_numpy(mat),
                          torch.from_numpy(mat_attr)).numpy()
    assert got.dtype == np.float32 and got.shape == (3,) + idx.shape
    assert np.array_equal(got, ref)
    assert np.array_equal(got, ref2)


# ---------------------------------------------------------------------------
# whole frames

@pytest.fixture(scope="module")
def port_frames(scenes_dir):
    """The port's frames of a config through an engine, rendered once:
    the last of 3 frames at 64x64 on the CPU (the plain versions)."""
    cache = {}

    def frames(name, engine):
        if (name, engine) not in cache:
            scene, kw = CONFIGS[name]
            r = Renderer(Scene(str(scenes_dir / f"{scene}.txt")),
                         RenderConfig(**kw, **ENGINES[engine]), (64, 64),
                         device="cpu")
            cache[name, engine] = r.render(3)
            assert r.step.tracer.engine == engine
        return cache[name, engine]
    return frames


def _within_budget(name, images, refs):
    for img, ref in zip(images, refs):
        diff = np.abs(img - ref).max(axis=-1)
        assert (diff > 1e-3).mean() < FRAC_BUDGET[name]
        assert np.sqrt(((img - ref) ** 2).mean()) < RMSE_BUDGET


@pytest.mark.parametrize("name,engine", GOLDEN_RUNS)
def test_per_bounce_frames_match_goldens(port_frames, name, engine):
    """Cornell (textured mesh wall: K's texels, and J's on the split
    engine) and diamond (refraction through 5 chunks) raw, and room with
    SVGF (two textures) through bounce_fused, 3 frames at 64x64, against
    the XLA goldens and, for room, the pallas golden too, within
    tests/test_golden.py's budgets."""
    families = ("npz", "pallas.npz") if name == "room_svgf_d3" else ("npz",)
    for family in families:
        g = np.load(f"{GOLDEN}/{name}.{family}")
        _within_budget(name, port_frames(name, engine),
                       (g["left"], g["right"]))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_per_bounce_frames_match_live_jax(port_frames, scenes_dir, engine):
    """Cornell 64x64 depth 3 raw through each per-bounce engine against
    the JAX package's live render of the same engine
    (RenderConfig(backend="pallas", fuse_path=False, ...), interpret
    mode), 3 frames, within the raw-frame budget. Measured: 5 pixels of
    4096 (0.12%) off by more than 1e-3, RMSE 0.0014, through either
    engine (the two engines' frames are equal: the same plain pieces)."""
    r = JRenderer(JScene(str(scenes_dir / "cornell.txt")),
                  JConfig(backend="pallas", **CONFIGS["cornell_raw_d3"][1],
                          **ENGINES[engine]), resolution=(64, 64))
    ref = r.render(3)
    got = port_frames("cornell_raw_d3", engine)
    _within_budget("cornell_raw_d3", got, ref)


# ---------------------------------------------------------------------------
# engine choice and launches

def test_per_bounce_engine_choice(scenes_dir):
    """The JAX package's engine choice (wavefront.py:936-965, 1392-1476):
    the sort where use_sort (more than four chunks or sort_rays=True, and
    fuse_bounce), else the whole path where fuse_path, else bounce_fused
    where fuse_bounce, else the split per-bounce engine (bounce_pallas)."""
    cornell = Scene(str(scenes_dir / "cornell.txt"))
    bunny = Scene(str(scenes_dir / "bunny.txt"))

    def engine(scene, **kw):
        return Renderer(scene, RenderConfig(**kw), (16, 16),
                        device="cpu").step.tracer.engine
    for scene, kw, want in (
            (cornell, {}, "whole_path"),
            (cornell, dict(sort_rays=True), "sorted"),
            (cornell, dict(fuse_path=False), "bounce_fused"),
            (cornell, dict(fuse_bounce=False), "whole_path"),
            (cornell, dict(fuse_path=False, fuse_bounce=False),
             "bounce_split"),
            (bunny, {}, "sorted"),
            (bunny, dict(fuse_path=False), "sorted"),
            (bunny, dict(sort_rays=False), "whole_path"),
            (bunny, dict(fuse_path=False, sort_rays=False), "bounce_fused"),
            (bunny, dict(fuse_bounce=False), "whole_path"),
            (bunny, dict(fuse_path=False, fuse_bounce=False),
             "bounce_split")):
        assert engine(scene, **kw) == want, (kw, want)


def test_per_bounce_engines_launch_no_kernel_on_cpu(port_frames):
    """On CPU tensors H, I, J and K took their plain versions."""
    for engine in ENGINES:
        port_frames("cornell_raw_d3", engine)
    assert (H.bounce_fused.launches + A.light_visibility.launches
            + A.scene_intersect_full_tex.launches
            + K.sparse_gather.launches) == 0
