"""Each kernel module's plain PyTorch version against the JAX function it
ports (Pallas kernels in interpret mode, as the JAX package's own tests
run them), on seeded inputs; and, on a card only, each CUDA kernel
against its plain version."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.denoise import atrous as jatrous
from ptdn_tpu.denoise import reproject as jrep
from ptdn_tpu.engine.wavefront import make_trace_fn
from ptdn_tpu.ops.camera import OrbitCamera as JCam
from ptdn_tpu.ops.camera import generate_camera_rays as jgen
from ptdn_tpu.ops.pallas.atrous import atrous_level_pallas, pack_static_planes
from ptdn_tpu.ops.pallas.reproject import back_projection_stencil_pallas
from ptdn_tpu.ops.pallas.scene_intersect import scene_intersect_full_pallas
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch import interop
from ptdn_tpu_torch.denoise import atrous as tatrous
from ptdn_tpu_torch.denoise import reproject as trep
from ptdn_tpu_torch.ops.cuda import atrous as D
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.ops.cuda import reproject as C
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def cornell(scenes_dir):
    js = JScene(str(scenes_dir / "cornell.txt"))
    jds = js.device()
    ds = interop.device_scene_from_numpy(
        {f.name: np.asarray(getattr(jds, f.name))
         for f in dataclasses.fields(jds)}, device="cpu")
    ts = Scene(str(scenes_dir / "cornell.txt"))
    return js, jds, ts, ds, A.geom_info(ts, "cpu")


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 9.0],
                  size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def test_scene_intersect_full_matches_pallas(cornell):
    """Kernel A's plain version on 4096 random rays: the geom (and so the
    material and hit) agrees on >= 99.9% of rays, t, normal and uv to
    1e-5 on those (XLA's fused multiply-adds and rsqrt estimate differ
    from the port by float32 ulps, which can flip a near tie)."""
    js, jds, ts, ds, gi = cornell
    o, d = _rays(4096, 0)
    ref = scene_intersect_full_pallas(jds, js.geom_types,
                                      js.geom_material_ids, jnp.asarray(o),
                                      jnp.asarray(d), js.n_tris,
                                      interpret=True)
    got = A.scene_intersect_full(ds, gi, torch.from_numpy(o),
                                 torch.from_numpy(d))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    agree = got["geom_id"].numpy() == ref["geom_id"]
    assert agree.mean() >= 0.999
    assert np.array_equal(got["mat_id"].numpy()[agree], ref["mat_id"][agree])
    assert np.array_equal(got["hit"].numpy(), ref["hit"])
    for k in ("t", "normal", "uv"):
        np.testing.assert_allclose(got[k].numpy()[agree], ref[k][agree],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_wrappers_refuse_other_devices(cornell):
    _, _, _, ds, gi = cornell
    o = torch.zeros((8, 3), device="meta")
    with pytest.raises(RuntimeError):
        A.scene_intersect_full(ds, gi, o, o)


def test_path_trace_deferred_radiance_match_pallas(cornell):
    """Kernels B1 + B2's plain versions from the JAX package's own primary
    hit, against its whole-path kernel + deferred radiance at 64x64,
    depth 3. B1 takes that kernel's baked row dots for the analytic geoms
    (zero terms dropped, fused as XLA fuses them), so no bounce flips to
    another geom: no pixel off by > 1e-3 (0.17% before the baked form),
    and the RMSE of the last-bit differences left is below 1e-5."""
    js, jds, ts, ds, gi = cornell
    res, depth, frame = (64, 64), 3, 5
    cfg = JConfig(backend="pallas", trace_depth=depth)
    trace = jax.jit(make_trace_fn(js, cfg, res, interpret=True))
    cam = JCam(js.camera, res).frame().as_pytree()
    params = cfg.traced_params()
    rad, _, prim = trace(jds, cam, params, jnp.uint32(frame))
    jo, jd = jgen(cam, res)
    prim = {k: torch.from_numpy(np.array(v)) for k, v in prim.items()}
    prim.update(o=torch.from_numpy(np.array(jo)),
                d=torch.from_numpy(np.array(jd)))
    emit = (np.asarray(js.materials[js.geom_material_ids[0]].color,
                       np.float32) * np.float32(5.0))
    light = {"geom": 0, "pos": [float(x) for x in js.geoms[0].translation],
             "emit": [float(x) for x in emit],
             "radius": float(params["light_radius"]),
             "intensity": float(params["shadow_intensity"])}
    flags = {"shadow_ray": True, "reduce_var": True, "do_vis": True,
             "alb_skip1": False, "show_tex": True}
    contrib, texidx = B.path_trace(ds, gi, prim, frame=frame, lane0=0,
                                   depth=depth, light=light, flags=flags)
    assert contrib.shape == (6 * depth, 64 * 64)
    assert texidx.shape == (depth - 1, 64 * 64)
    assert texidx.dtype == torch.int32
    got = B.deferred_radiance(ds, contrib, texidx, depth).numpy()
    ref = np.asarray(rad)
    diff = np.abs(got - ref).max(axis=-1)
    assert (diff > 1e-3).mean() == 0.0
    assert np.sqrt(((got - ref) ** 2).mean()) < 1e-5


def _baked_row_terms(row, v, bias):
    """The JAX whole-path kernel's baked row (scene_intersect.py:_row_dot
    with static=True) term by term: exactly-zero coefficients drop out,
    1 and -1 give v and -v, the terms sum left to right, and each add
    contracts its left product operand, else its right one, as XLA on the
    CPU does (ops/fp.py). A lone product stays unrounded, (c, v)."""
    from ptdn_tpu_torch.ops.fp import fma

    def value(t):
        return t[0] * t[1] if isinstance(t, tuple) else t

    def add(x, y):
        if isinstance(x, tuple):
            return fma(x[0], x[1], value(y))
        if isinstance(y, tuple):
            return fma(y[0], y[1], x)
        return x + y
    acc = None
    for c, x in zip(row[:3], v):
        if c == 0.0:
            continue
        t = x if c == 1.0 else (-x if c == -1.0 else (c, x))
        acc = t if acc is None else add(acc, t)
    if bias and row[3] != 0.0:
        acc = row[3] if acc is None else add(acc, row[3])
    return 0.0 if acc is None else acc


def _plan_value(plan, v):
    """The three-term baked row plan (ops/intersect.py:baked_row_plan)
    evaluated whole: fma(a2, v[s2], fma(a0, v[s0], a1 * v[s1])) + b."""
    from ptdn_tpu_torch.ops.fp import fma
    (a0, a1, a2, b), code = plan
    var = tuple(v) + (1.0,)
    s = [var[(code >> (2 * k)) & 3] for k in range(3)]
    return fma(a2, s[2], fma(a0, s[0], a1 * s[1])) + b


def test_baked_row_plans_match_plain():
    """Kernel B1 and its plain version evaluate each baked row dot by the
    form the host resolved it into (ops/intersect.py:baked_row_form, the
    switch of csrc/path.cu:form_row). On 96 seeded rows with zero, -0,
    +-1 and other coefficients, with and without a bias, at inputs that
    include zeros of both signs, subnormals and +-inf, the form's value
    and its world-distance subtraction o - row (a lone product fuses into
    it) equal the three-term plan (baked_row_plan) and the baked row
    evaluated term by term under XLA's contraction rules, bit for bit,
    the sign of a zero included (NaN, from inf - inf, equals NaN).
    test_path_trace_deferred_radiance_match_pallas holds the result
    against the JAX kernel itself."""
    from ptdn_tpu_torch.ops import intersect
    from ptdn_tpu_torch.ops.fp import fma

    r = np.random.default_rng(5)
    n_rows, n = 96, 512
    coefs = np.float32([0.0, -0.0, 1.0, -1.0, 0.333, -2.121, 100.0, 6e-15])
    rows = np.where(r.uniform(size=(n_rows, 4)) < 0.75,
                    r.choice(coefs, size=(n_rows, 4)),
                    r.normal(size=(n_rows, 4))).astype(np.float32)
    v = (r.normal(size=(3, n)) * 10.0 ** r.integers(-3, 3, (3, n))).astype(
        np.float32)
    v[:, :8] = 0.0          # zero products, whose sign the plan keeps
    v[1, 4:8] = -0.0
    tiny = np.float32([1e-45, -1e-45, 3e-39, -1.17e-38, 1e-40, -7e-42])
    v[:, 8:20] = r.choice(tiny, size=(3, 12))           # subnormals
    v[:, 20:26] = np.float32([np.inf, -np.inf, 1.0, -np.inf, 2.5, np.inf])
    v[r.integers(0, 3, 6), 26 + np.arange(6)] = np.inf
    o = r.normal(size=n).astype(np.float32)
    o[:4] = v[0, :4]
    o[8:12] = v[0, 8:12]
    o[20:23] = np.float32([np.inf, -np.inf, 0.0])
    vt = tuple(torch.from_numpy(x) for x in v)
    ot = torch.from_numpy(o)

    def bits(x):
        x = torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32),
                               (n,))
        return torch.where(torch.isnan(x), np.nan, x).numpy().view(np.int32)
    m = [row.tolist() for row in rows]
    forms = set()
    for k, row in enumerate(m):
        for bias in (False, True):
            ref = _baked_row_terms(row, vt, bias)
            value = ref[0] * ref[1] if isinstance(ref, tuple) else ref
            plan = _plan_value(intersect.baked_row_plan(row, bias), vt)
            got = intersect.row_dot(m, k, vt, bias, static=True)
            forms.add(intersect.baked_row_form(row, bias)[0] & 15)
            assert np.array_equal(bits(got), bits(value)), (row, bias)
            assert np.array_equal(bits(got), bits(plan)), (row, bias)
        ref = _baked_row_terms(row, vt, True)
        sub = (fma(-ref[0], ref[1], ot) if isinstance(ref, tuple)
               else ot - ref)
        got = intersect._sub_row(ot, m, k, vt, True)
        assert np.array_equal(bits(got), bits(sub)), row
    assert forms == set(range(11)), forms       # every form was exercised


def test_path_scene_header_holds_the_forms(cornell):
    """Kernel B1 is built per scene with a generated header
    (ops/cuda/scene_intersect.py:path_scene_header): its geom types and
    materials, each baked row's form and coefficients, and the material
    table. Read back from the header's C text, every constant equals the
    float32 the plain version uses, bit for bit (hex-float literals), and
    every row's form is baked_row_form's."""
    import re

    from ptdn_tpu_torch.ops.intersect import baked_row_form
    js, jds, ts, ds, gi = cornell
    text = gi.path_scene

    def array(name):
        m = re.search(name + r"(?:\[\d*\])+ = \{(.*?)\};", text, re.S)
        return re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f|-?\d+", m.group(1))
    g = len(ts.geoms)
    assert f"constexpr int kGeoms = {g};" in text
    assert [int(v) for v in array("kType")] == list(ts.geom_types)
    assert [int(v) for v in array("kMat")] == list(ts.geom_material_ids)
    codes = [int(v) for v in array("kCode")]
    coefs = np.float32([float.fromhex(v[:-1]) for v in array("kCoef")])
    want_codes, want_coefs = [], []
    for geom in ts.geoms:
        for m, bias in ((geom.inverse, True), (geom.inverse, False),
                        (geom.transform, True), (geom.transform, False),
                        (geom.inv_transpose, False)):
            for row in np.asarray(m, np.float32)[:3]:
                code, c = baked_row_form(row, bias)
                want_codes.append(code)
                want_coefs += c
    assert codes == want_codes
    assert np.array_equal(coefs.view(np.int32),
                          np.float32(want_coefs).view(np.int32))
    mats = np.float32([float.fromhex(v[:-1]) for v in array("kMatAttr")])
    assert np.array_equal(mats.view(np.int32),
                          ds.mat_attr.numpy().reshape(-1).view(np.int32))


def _reproj_inputs(seed, shift_px=0.0):
    """A seeded mid-sequence SVGF state (as test_denoise.py builds one):
    positions that reproject within a pixel of their own (plus a shift),
    random geoms, normals, history; carried in through interop."""
    r = np.random.default_rng(seed)
    h, w = 40, 48
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    px = xs + 0.5 + r.uniform(-0.45, 0.45, size=(h, w)) + shift_px
    py = ys + 0.5 + r.uniform(-0.45, 0.45, size=(h, w))
    pos = np.stack([-((px + 0.5) / w - 0.5) * 2.0,
                    -((py + 0.5) / h - 0.5) * 2.0,
                    -np.ones_like(px)], -1).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    nrm = r.normal(size=(h, w, 3)).astype(np.float32)
    state = {
        "color_history": r.uniform(size=(h, w, 3)).astype(np.float32),
        "moment_history": r.uniform(size=(h, w, 2)).astype(np.float32),
        "history_length": r.integers(0, 6, size=(h, w)).astype(np.int32),
        "prev_normal": (nrm + 0.01 * r.normal(size=(h, w, 3))).astype(
            np.float32),
        "prev_geom_id": r.integers(-1, 3, size=(h, w)).astype(np.int32),
        "prev_view": vm,
    }
    cur = {"color": r.uniform(size=(h, w, 3)).astype(np.float32),
           "position": pos, "normal": nrm,
           "geom_id": r.integers(-1, 3, size=(h, w)).astype(np.int32)}
    return (w, h), cur, state


def _reproj_call(fn, res, cur, st, as_torch):
    conv = ((lambda x: torch.from_numpy(np.array(x))) if as_torch
            else jnp.asarray)
    gb = {"position": conv(cur["position"]), "normal": conv(cur["normal"]),
          "geom_id": conv(cur["geom_id"])}
    prev = {"position": conv(cur["position"]),
            "normal": st["prev_normal"], "geom_id": st["prev_geom_id"]}
    return fn(res, conv(cur["color"]), gb, prev, st["prev_view"],
              st["color_history"], st["moment_history"],
              st["history_length"], 0.2, 0.2)


@pytest.mark.parametrize("branch", ["stencil", "far"])
def test_back_projection_matches_jax(branch):
    """Kernel C's plain version against back_projection_stencil_pallas on
    its gated domain, and the far branch (C's band mode, plain) against
    the XLA oracle back_projection on a 3-pixel shift, which stays inside
    every band's slab; both to 1e-5, history lengths equal (the same
    reprojection math; only XLA's fused multiply-add choices can move the
    last bit)."""
    shift = 0.0 if branch == "stencil" else 3.0
    res, cur, st_np = _reproj_inputs(7, shift)
    st_t = interop.frame_state_from_numpy(st_np, device="cpu")
    st_j = {k: jnp.asarray(v) for k, v in st_np.items()}
    gb_t = {"position": torch.from_numpy(cur["position"]),
            "geom_id": torch.from_numpy(cur["geom_id"])}
    near = bool(trep.motion_bounds(res, gb_t, st_t["prev_view"])[0])
    assert near == (branch == "stencil")
    if branch == "stencil":
        ref = _reproj_call(lambda *a: back_projection_stencil_pallas(
            *a, interpret=True), res, cur, st_j, False)
    else:
        ref = _reproj_call(jrep.back_projection, res, cur, st_j, False)
    got = _reproj_call(trep.back_projection_auto, res, cur, st_t, True)
    for name, g, r_ in zip(("variance", "color", "moments", "history"), got,
                           ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r_), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.fixture(scope="module")
def atrous_inputs():
    r = np.random.default_rng(3)
    h, w = 64, 48
    return {
        "color": r.uniform(size=(h, w, 3)).astype(np.float32),
        "variance": r.uniform(size=(h, w)).astype(np.float32),
        "position": r.normal(size=(h, w, 3)).astype(np.float32),
        "normal": r.normal(size=(h, w, 3)).astype(np.float32),
        "albedo": r.uniform(size=(h, w, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_atrous_level_matches_pallas(atrous_inputs, level):
    """Kernel D's plain version against atrous_level_pallas, levels 1-5
    (level 5 with the albedo remodulation of the last level), to the 1e-5
    of the JAX package's own pallas-vs-oracle test."""
    x = atrous_inputs
    h, w = x["variance"].shape
    gb = {"position": jnp.asarray(x["position"]),
          "normal": jnp.asarray(x["normal"]),
          "albedo": jnp.asarray(x["albedo"]),
          "ialbedo": jnp.ones((h, w, 3), jnp.float32)}
    sp, halo = pack_static_planes(gb, max_level=5)
    last = level == 5
    rc, rv = atrous_level_pallas(jnp.asarray(x["color"]),
                                 jnp.asarray(x["variance"]), sp, halo,
                                 (h, w), level, last, 0.45, 0.2, 0.35, True,
                                 last, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    gc, gv = D.atrous_level(t["color"], t["variance"],
                            D.pack_static_planes(t["position"], t["normal"]),
                            t["albedo"] if last else None, level, 0.45, 0.2,
                            0.35, True)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5)


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("blur", [True, False])
def test_atrous_level_packed_matches_pallas(blur, level):
    """Kernel D's plain version on the packed layout the frame passes
    between levels (color and variance as the views of one (H, W, 4)
    buffer, position and normal in pack_static_planes' (H, W, 8) one,
    the output packed again below the last level) against
    atrous_level_pallas in interpret mode, 64x64, levels 1-5, the blur on
    and off, the last level with its albedo; to the 1e-5 of the JAX
    package's own pallas-vs-oracle test. The packed views pass through
    unchanged: the same level on separate tensors gives the same bits."""
    r = np.random.default_rng(11)
    h = w = 64
    x = {"color": r.uniform(size=(h, w, 3)),
         "variance": r.uniform(size=(h, w)),
         "position": r.normal(size=(h, w, 3)),
         "normal": r.normal(size=(h, w, 3)),
         "albedo": r.uniform(size=(h, w, 3))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    gb = {"position": jnp.asarray(x["position"]),
          "normal": jnp.asarray(x["normal"]),
          "albedo": jnp.asarray(x["albedo"]),
          "ialbedo": jnp.ones((h, w, 3), jnp.float32)}
    sp, halo = pack_static_planes(gb, max_level=5)
    last = level == 5
    rc, rv = atrous_level_pallas(jnp.asarray(x["color"]),
                                 jnp.asarray(x["variance"]), sp, halo,
                                 (h, w), level, last, 0.45, 0.2, 0.35, blur,
                                 last, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    static = D.pack_static_planes(t["position"], t["normal"])
    assert static.shape == (h, w, 8)
    assert torch.equal(static[..., 0:3], t["position"])
    assert torch.equal(static[..., 4:7], t["normal"])
    cv = torch.cat((t["color"], t["variance"][..., None]), -1)
    args = (static, t["albedo"] if last else None, level, 0.45, 0.2, 0.35,
            blur)
    gc, gv = D.atrous_level(cv[..., :3], cv[..., 3], *args,
                            pack_out=not last)
    if not last:
        assert gc.shape == (h, w, 3) and gc.stride() == (4 * w, 4, 1)
        assert gv.data_ptr() == gc.data_ptr() + 12
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5)
    sc, sv = D.atrous_level(t["color"], t["variance"], *args)
    assert torch.equal(gc, sc) and torch.equal(gv, sv)


@pytest.mark.parametrize("h,w", [(800, 800), (1080, 1920), (48, 64),
                                 (29, 37)])
def test_atrous_tiling_covers_every_pixel_once(h, w):
    """Kernel D's launch geometry (ops/cuda/atrous.py:atrous_tiling, the
    block and thread mapping of csrc/atrous.cu spelt out by
    atrous_tile_pixels): at every step from 1 to 64 each pixel is
    filtered by exactly one thread, and the bytes a level stages (48 a
    pixel: color, variance, position, normal) stay within twice its
    compulsory bytes (56 a pixel: the same inputs once, color and
    variance out)."""
    for level in range(7):
        (y, x), (sy, sx) = D.atrous_tile_pixels(h, w, level)
        hits = np.zeros((h, w), np.int64)
        np.add.at(hits, (y, x), 1)
        assert (hits == 1).all(), (level, hits.min(), hits.max())
        assert 48 * sy.size <= 2 * 56 * h * w, (level, sy.size / (h * w))
        blocks, phases, ty, tx = D.atrous_tiling(h, w, level)
        assert phases == min(4, 1 << level)
        assert blocks == (1 << level) ** 2 // phases * ty * tx


@pytest.mark.parametrize("blur", [True, False])
def test_atrous_oracle_matches_jax(atrous_inputs, blur):
    """The plain oracle (three clamped exps) against the JAX package's."""
    x = atrous_inputs
    h, w = x["variance"].shape
    jgb = {"position": jnp.asarray(x["position"]),
           "normal": jnp.asarray(x["normal"]),
           "albedo": jnp.asarray(x["albedo"]),
           "ialbedo": jnp.ones((h, w, 3), jnp.float32)}
    tgb = {k: torch.from_numpy(np.array(v)) for k, v in jgb.items()}
    for level in (1, 3):
        rc, rv = jax.jit(functools.partial(
            jatrous.atrous_level, level=level, is_last=True,
            blur_variance=blur, add_color=True))(
                jnp.asarray(x["color"]), jnp.asarray(x["variance"]), jgb,
                sigma_l=0.45, sigma_n=0.2, sigma_x=0.35)
        gc, gv = tatrous.atrous_level(torch.from_numpy(x["color"]),
                                      torch.from_numpy(x["variance"]), tgb,
                                      level, True, 0.45, 0.2, 0.35, blur,
                                      True)
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(scenes_dir):
    """Every CUDA kernel against its plain version on the card, at a small
    size (chip_smoke.py does this at the main path's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ptdn_tpu_torch.engine import Renderer
    from ptdn_tpu_torch.ops.camera import generate_camera_rays

    res = (128, 96)
    cfg = RenderConfig(trace_depth=4, denoise_enable=True,
                       temporal_enable=True, spatial_enable=True,
                       atrous_nlevel=5)
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")), cfg, res, "cuda")
    for _ in range(3):
        r.render_frame()
    tr = r.step.tracer
    ds, gi = tr.ds, tr.gi
    o, d = generate_camera_rays(r._cam[0], res)
    ka = A._scene_intersect_full_kernel(ds, gi, o, d)
    pa = A.scene_intersect_full_plain(ds, gi, o, d)
    assert (ka["geom_id"] == pa["geom_id"]).float().mean() >= 0.999
    prim = dict({k: getattr(tr, "pcache_" + k) for k in
                 ("t", "normal", "uv", "mat_id", "geom_id", "hit",
                  "albedo")}, o=o, d=d)
    light = dict(tr.light, radius=1.4, intensity=2.7)
    kc, kt = B._path_trace_kernel(ds, gi, prim, 3, 0, 4, light, tr.flags)
    pc, pt = B.path_trace_plain(ds, gi, prim, frame=3, lane0=0, depth=4,
                                light=light, flags=tr.flags)
    diff = (B._deferred_radiance_kernel(ds, kc, kt, 4)
            - B.deferred_radiance_plain(ds, pc, pt, 4)).abs().max(-1).values
    assert (diff > 1e-3).float().mean() < 0.01
    st = r.step.frame_state()
    rad, gb = tr(r._cam[0], r._params, 3, False)
    w, h = res
    gb = {k: v.reshape((h, w) + tuple(v.shape[1:])).contiguous()
          for k, v in gb.items()}
    args = (res, rad.reshape(h, w, 3), gb,
            {"position": st["prev_position"], "normal": st["prev_normal"],
             "geom_id": st["prev_geom_id"]}, st["prev_view"],
            st["color_history"], st["moment_history"], st["history_length"],
            0.2, 0.2)
    for a, b in zip(C._back_projection_stencil_kernel(*args),
                    C.back_projection_stencil_plain(*args)):
        assert torch.allclose(a.double(), b.double(), rtol=1e-5, atol=1e-5)
    src, var = C.back_projection_stencil_plain(*args)[1::-1]
    static = D.pack_static_planes(gb["position"], gb["normal"])
    for level in range(1, 6):
        dargs = (src, var, static, None, level, 0.45, 0.2, 0.35, True,
                 level < 5)
        for a, b in zip(D._atrous_level_kernel(*dargs),
                        D.atrous_level_plain(*dargs)):
            assert torch.equal(a, b)
        src, var = D.atrous_level_plain(*dargs)


def test_reference_knobs_on():
    """The port follows the JAX package's default knobs (reciprocal slab,
    rsqrt normalization); a run with them turned off would compare unlike
    math, so it fails here instead."""
    from ptdn_tpu.ops import intersect as jint
    from ptdn_tpu.ops.pallas import scene_intersect as jsi
    assert jint.RECIP_SLAB and jsi.RECIP_SLAB and jsi.FAST_NORM
