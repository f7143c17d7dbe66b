"""The mesh scenes' sorted wavefront: kernels E (shade_bounce), F
(trace_bounce) and G (inrow_permute) through their plain PyTorch versions
against the JAX functions they port (Pallas kernels in interpret mode),
the range, key and permute glue against the JAX engine's, whole frames
of diamond, bunny and room against the committed goldens, and, on a card
only, each kernel against its plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.engine import wavefront as JW
from ptdn_tpu.ops.pallas.bounce import trace_bounce_pallas
from ptdn_tpu.ops.pallas.inrow import inrow_permute_pallas
from ptdn_tpu.ops.pallas.shade import shade_bounce_pallas
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu_torch import interop
from ptdn_tpu_torch.bounce_bench import capture_bounce
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import bounce as F
from ptdn_tpu_torch.ops.cuda import inrow as G
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.ops.cuda.ranges import new_allp
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh_card import _bits_equal

GOLDEN = "tests/golden"
# tests/test_golden.py's FRAC_BUDGET and RMSE bound for these configs
_SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
             trace_depth=3, atrous_nlevel=3)
CONFIGS = {"diamond_raw_d4": ("diamond", dict(denoise_enable=False,
                                              trace_depth=4)),
           "bunny_svgf_d3": ("bunny", _SVGF),
           "room_svgf_d3": ("room", _SVGF)}
FRAC_BUDGET = {"diamond_raw_d4": 0.01, "bunny_svgf_d3": 0.16,
               "room_svgf_d3": 0.16}
RMSE_BUDGET = 0.012


@pytest.fixture(autouse=True, scope="module")
def torch_on_one_thread():
    """Run the plain versions' torch ops on one thread. The suite's
    workers share the machine's cores: a torch op spread over every core
    in each worker makes the workers wait on one another (a 5 s frame
    test took minutes), while one thread alone is as fast as many here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(scenes_dir, name):
    """The JAX package's scene, its DeviceScene, and the same arrays as
    the port's DeviceScene."""
    js = JScene(str(scenes_dir / f"{name}.txt"))
    jds = js.device()
    ds = interop.device_scene_from_numpy(
        {f.name: np.asarray(getattr(jds, f.name))
         for f in dataclasses.fields(jds)}, device="cpu")
    return js, jds, ds


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).T


# ---------------------------------------------------------------------------
# kernel E

@pytest.mark.parametrize("alb_skip", [False, True])
def test_shade_bounce_matches_pallas(scenes_dir, alb_skip):
    """E's plain version against shade_bounce_pallas with a pixel plane,
    on 4096 seeded lanes of every diamond material (refractive and mirror
    ones included), a fifth of them dead, pixels permuted. The RNG draws
    are exact and every lane takes the same branch, so the act, dif and
    nee planes are equal; the float planes agree to 1e-4 (XLA on the CPU
    fuses multiply-adds and expands 1/sqrt as rsqrt plus a Newton step,
    where the plain version rounds every operation: 1 ulp on most lanes,
    more after cancellation near the light)."""
    js, _, ds = _scenes(scenes_dir, "diamond")
    r = np.random.default_rng(0)
    n = 4096
    p = np.zeros((E.N_IN + 1, n), np.float32)
    p[0:3] = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5], size=(n, 3)).T
    p[3:6] = _unit(r, n)
    p[E.I_T] = r.uniform(0.1, 5, n)
    p[7:10] = _unit(r, n)
    p[10:13] = r.uniform(size=(3, n))
    p[13:16] = r.uniform(0.2, 1, size=(3, n))
    p[16:19] = r.uniform(0, 0.5, size=(3, n))
    p[E.I_MAT] = r.integers(0, len(js.materials), n)
    p[E.I_ACT] = r.uniform(size=n) < 0.8
    p[E.I_DIF] = r.uniform(size=n) < 0.3
    p[E.I_PIX] = r.permutation(n)
    planes = p.reshape(E.N_IN + 1, n // 128, 128)
    light = [float(x) for x in js.geoms[0].translation]
    fd, lane0 = 9, 64
    pv = jnp.asarray(light + [1.4, 2.7, float(alb_skip), 1.0, 0.0],
                     jnp.float32)
    ref = np.asarray(shade_bounce_pallas(
        jnp.asarray(planes), pv, jnp.asarray([fd, lane0], jnp.uint32),
        JW._static_mats(js), True, True, interpret=True))
    got = E.shade_bounce(torch.from_numpy(planes), ds.mat_attr, fd=fd,
                         lane0=lane0, light_pos=light,
                         lrad=float(np.float32(1.4)),
                         sint=float(np.float32(2.7)), alb_skip=alb_skip,
                         shadow_ray=True, reduce_var=True).numpy()
    for k in (E.O_ACT, E.O_DIF, E.O_NEE):
        assert np.array_equal(got[k], ref[k]), k
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# kernel G and the permute

def test_inrow_permute_matches_pallas():
    """G's plain version against inrow_permute_pallas: bit-equal."""
    r = np.random.default_rng(1)
    planes = r.normal(size=(26, 16, 128)).astype(np.float32)
    planes[3, 2, 5] = np.nan
    order = np.stack([r.permutation(128) for _ in range(16)]).astype(
        np.int32)
    ref = np.asarray(inrow_permute_pallas(jnp.asarray(planes),
                                          jnp.asarray(order),
                                          interpret=True))
    got = G.inrow_permute(torch.from_numpy(planes),
                          torch.from_numpy(order)).numpy()
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("regroup", [0, 4])
def test_permute_planes_matches_jax(regroup):
    """The port's permute against the JAX engine's permute_planes, below
    the gather cliff (one batch): keys with many ties and dead lanes
    (the sentinel). Both sorts are stable, so the orders are the same
    and every plane moves bit for bit alike, read through the port's
    order as kernel F reads them."""
    r = np.random.default_rng(2)
    nb = 32
    n = nb * 128
    key = r.integers(0, 50, n).astype(np.int32)
    key[r.uniform(size=n) < 0.2] = W.SENTINEL
    allp = r.normal(size=(26, nb, 128)).astype(np.float32)
    ref = np.asarray(JW.permute_planes(jnp.asarray(allp), jnp.asarray(key),
                                       n, nb, regroup=regroup,
                                       interpret=True))
    inp = torch.from_numpy(allp)
    planes, order = W.permute_planes(inp, torch.from_numpy(key), regroup)
    assert order.dtype == torch.int64
    # no copy of the planes but kernel G's in-row permute
    assert (planes is inp) == (regroup == 0)
    # the planes as kernel F reads them: through the order
    got = planes.reshape(26, n).index_select(1, order).reshape(26, nb, 128)
    assert np.array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# ranges and key

def _shaded(r, n):
    """Seeded planes in E's output layout: spawn points in the room box,
    unit next and shadow directions, 85% live lanes, 60% NEE lanes."""
    sh = r.normal(size=(E.N_OUT, n)).astype(np.float32)
    sh[E.O_SPX:E.O_SPZ + 1] = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 4.5],
                                        size=(n, 3)).T
    sh[E.O_DX:E.O_DZ + 1] = _unit(r, n)
    sh[E.O_SDX:E.O_SDZ + 1] = _unit(r, n)
    sh[E.O_ACT] = r.uniform(size=n) < 0.85
    sh[E.O_NEE] = r.uniform(size=n) < 0.6
    return sh.reshape(E.N_OUT, n // 128, 128)


@pytest.mark.parametrize("name", ["diamond", "bunny", "room", "terrain30k"])
def test_ranges_and_key_match_jax(scenes_dir, name):
    """chunk_range_planes and ranges_and_key against the JAX engine's
    (jitted, as the engine runs them) on 4096 seeded lanes: the range
    planes and the morton key equal. Diamond, bunny and room (textured)
    test every chunk; terrain30k's 233 chunks take the supergroup branch
    (G = 4). The
    shadow-range margin, the light AABB's half diagonal, equals the
    engine's jitted float32 value."""
    js, jds, ds = _scenes(scenes_dir, name)
    nc = -(-js.n_tris // 128)
    r = np.random.default_rng(3)
    n = 4096
    nb = n // 128
    sh = _shaded(r, n)
    pix = np.arange(n, dtype=np.float32).reshape(nb, 128)
    lp = jds.geom_translation[0]
    lhd = jax.jit(lambda a, b: 0.5 * jnp.sqrt(jnp.sum((a - b) ** 2)))(
        jds.geom_bb_max[0], jds.geom_bb_min[0])
    assert W.static_light_radius(ds, 0) == float(lhd)
    ref_p, ref_k = jax.jit(lambda s, q: JW.ranges_and_key(
        jds, s, q, n, nb, nc, True, light_pos=lp, light_radius=lhd))(
            jnp.asarray(sh), jnp.asarray(pix))
    got_p, got_k = W.ranges_and_key(ds, new_allp(torch.from_numpy(sh)),
                                    torch.from_numpy(pix), nc, True,
                                    [float(x) for x in np.asarray(lp)],
                                    float(lhd))
    assert np.array_equal(got_p.numpy(), np.asarray(ref_p))
    assert np.array_equal(got_k.numpy(), np.asarray(ref_k))
    o = [sh[k] for k in (E.O_SPX, E.O_SPY, E.O_SPZ)]
    d = [sh[k] for k in (E.O_DX, E.O_DY, E.O_DZ)]
    ref_r = jax.jit(lambda *a: JW.chunk_range_planes(jds, *a, nc))(
        *(jnp.asarray(x) for x in o + d))
    got_r = W.chunk_range_planes(ds, tuple(map(torch.from_numpy, o)),
                                 tuple(map(torch.from_numpy, d)), nc)
    for a, b in zip(got_r, ref_r):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# kernel F

@pytest.mark.parametrize("name", ["diamond", "room"])
def test_trace_bounce_matches_pallas(scenes_dir, name):
    """F's arithmetic (trace_lanes_plain, its plain version on the lanes
    in sorted order) against trace_bounce_pallas at 64x64 from a real
    shade output (the port's first bounce, coherence-sorted). The hit
    (material, act) agrees on >= 99.9% of lanes, t, normal and uv to 1e-5
    there (XLA's fused multiply-adds can flip a near tie), the lit mask
    (the radiance planes) on >= 99.9%. F's next albedo equals the JAX
    engine's on the agreeing lanes: the material color on diamond, and on
    room the texel that the JAX engine fetches through its tile
    compaction (fetch_alb: albedo_from_tilepack, uncompact_tiles_pallas;
    texid 1's atlas offsets)."""
    js, jds, ds = _scenes(scenes_dir, name)
    rend = Renderer(Scene(str(scenes_dir / f"{name}.txt")),
                    RenderConfig(trace_depth=3, denoise_enable=False),
                    (64, 64), device="cpu")
    rend.render_frame()
    tr = rend.step.tracer
    captured = {}
    real_trace = W.trace_bounce

    def spy(ds_, gi_, allp, order, **kw):
        # F's input planes in the sorted order it reads them in
        captured.setdefault("planes", allp.reshape(F.N_TIN, -1).index_select(
            1, order)[:F.R_PIX].reshape((F.R_PIX,) + allp.shape[1:]))
        captured.setdefault("kw", {k: v for k, v in kw.items()
                                   if k != "out"})
        return real_trace(ds_, gi_, allp, order, **kw)

    W.trace_bounce = spy
    try:
        rend.render_frame()
    finally:
        W.trace_bounce = real_trace
    planes, kw = captured["planes"], captured["kw"]
    got, alb = F.trace_lanes_plain(ds, tr.gi, planes, **kw)
    light = [float(x) for x in js.geoms[0].translation]
    pv = jnp.asarray(light + [1.4, 2.7, 0.0, 1.0, 0.0], jnp.float32)
    ref, comp = trace_bounce_pallas(
        jnp.asarray(planes.numpy()), pv, jds, geom_types=js.geom_types,
        geom_mats=js.geom_material_ids, n_tris=js.n_tris, light_geom=0,
        do_vis=True, light_emit=kw["emit"], compat=True,
        emit_tex=kw["show_tex"],
        mat_texids=tuple(m.texid for m in js.materials),
        tex_whs=tuple((t.shape[1], t.shape[0]) for t in js.textures),
        interpret=True)
    got, ref = got.numpy(), np.asarray(ref)
    agree = ((got[F.B_MAT] == ref[F.B_MAT])
             & (got[F.B_ACT] == ref[F.B_ACT]))
    assert agree.mean() >= 0.999
    for k in (F.B_T, F.B_NX, F.B_NY, F.B_NZ, F.B_UU, F.B_VV):
        np.testing.assert_allclose(got[k][agree], ref[k][agree], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
    inp = planes.numpy()
    lit_got = got[F.B_RR:F.B_RB + 1] != inp[E.O_RR:E.O_RB + 1]
    lit_ref = ref[F.B_RR:F.B_RB + 1] != inp[E.O_RR:E.O_RB + 1]
    assert (lit_got == lit_ref).all(axis=0).mean() >= 0.999
    for k in (F.B_SPX, F.B_DX, F.B_TR, F.B_DIF):
        assert _bits_equal(got[k], ref[k])
    assert kw["show_tex"] == (name == "room")
    n = got[0].size
    mat = jnp.asarray(ref[F.B_MAT].reshape(n).astype(np.int32))
    mv = {"color": jds.mat_color[mat]}
    ref_alb = np.asarray(JW.albedo_from_tilepack(jds, mv, comp, True)
                         if kw["show_tex"] else mv["color"])
    got_alb = alb.numpy().reshape(3, n).T
    assert np.array_equal(got_alb[agree.reshape(n)],
                          ref_alb[agree.reshape(n)])


def _old_bounce(ds, gi, allp, order, kw):
    """The sorted bounce's F as it ran before F read through the order:
    every plane gathered by index_select, F's arithmetic on them, then
    the next bounce's planes cat from F's output and albedo with the
    gathered pixel plane, or on the last depth the radiance scattered to
    the pixels' rows."""
    n = allp[0].numel()
    p = allp.reshape(F.N_TIN, n).index_select(1, order).reshape(allp.shape)
    out, alb = F.trace_lanes_plain(ds, gi, p[:-1], **kw)
    planes = torch.cat([out[0:10], out[0:3] if alb is None else alb,
                        out[10:19]])
    pix = p[-1]
    if kw["do_next"]:
        return torch.cat([planes, pix[None]])
    radiance = torch.empty((n, 3))
    radiance[pix.reshape(-1).to(torch.int64)] = planes[16:19].reshape(3, n).T
    return radiance


@pytest.mark.parametrize("do_next", [True, False])
@pytest.mark.parametrize("name,show_tex", [("room", True), ("room", False),
                                           ("diamond", False)])
def test_trace_bounce_reads_through_the_order(scenes_dir, name, show_tex,
                                              do_next):
    """F's plain version in its contract (the bounce's unsorted planes,
    the sort's order, the carry as its output buffer) on a real 64x64
    sorted bounce 2 equals, bit for bit, the sequence it replaced
    (_old_bounce): below the last depth the next bounce's 23 planes,
    written into the buffer it was given; on the last the radiance in
    pixel order. Room (22 chunks) with and without textures takes the
    plain stable sort, diamond (5) kernel G's in-row permute first."""
    r = Renderer(Scene(str(scenes_dir / f"{name}.txt")),
                 RenderConfig(trace_depth=3 if do_next else 2,
                              show_texture=show_tex, denoise_enable=False),
                 (64, 64), device="cpu")
    cap = capture_bounce(r, 2, ("trace_bounce", "inrow_permute"))
    (ds, gi, allp, order), kw = cap["trace_bounce"]
    assert ("inrow_permute" in cap) == (name == "diamond")
    assert (kw.pop("out") is not None) == do_next
    assert kw["do_next"] == do_next and kw["show_tex"] == show_tex
    n = allp[0].numel()
    assert not torch.equal(order, torch.arange(n))   # the sort moved lanes
    want = _old_bounce(ds, gi, allp, order, kw)
    dest = torch.full((F.N_NEXT,) + tuple(allp.shape[1:]), float("nan"))
    got = F.trace_bounce(ds, gi, allp, order,
                         out=dest if do_next else None, **kw)
    if do_next:
        assert got is dest
    else:
        assert got.shape == (n, 3)
    assert _bits_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# whole frames

@pytest.fixture(scope="module")
def mesh_renders(scenes_dir):
    return {name: Renderer(Scene(str(scenes_dir / f"{scene}.txt")),
                           RenderConfig(**kw), (64, 64),
                           device="cpu").render(3)
            for name, (scene, kw) in CONFIGS.items()}


@pytest.mark.parametrize("family", ["npz", "pallas.npz"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_frames_match_goldens(mesh_renders, name, family):
    """Diamond (5 chunks: sort with the in-row regroup), bunny (39) and
    room (22, two textures) at 64x64 for 3 frames through the sorted
    wavefront, against the XLA and the pallas goldens, within
    tests/test_golden.py's budgets."""
    g = np.load(f"{GOLDEN}/{name}.{family}")
    for img, ref in zip(mesh_renders[name], (g["left"], g["right"])):
        diff = np.abs(img - ref).max(axis=-1)
        assert (diff > 1e-3).mean() < FRAC_BUDGET[name]
        assert np.sqrt(((img - ref) ** 2).mean()) < RMSE_BUDGET


def _frames(scenes_dir, scene, n=2, **kw):
    r = Renderer(Scene(str(scenes_dir / f"{scene}.txt")),
                 RenderConfig(trace_depth=3, denoise_enable=False, **kw),
                 (64, 64), device="cpu")
    return [r.render_frame()[0].numpy().copy() for _ in range(n)]


@pytest.mark.parametrize("scene", ["diamond", "cornell"])
def test_sorted_matches_unsorted(scenes_dir, monkeypatch, scene):
    """The coherence sort only reorders lanes: the RNG follows the pixel
    plane and every lane's arithmetic is placement-free, so the sorted
    wavefront equals itself with the permute taken out (the same
    engine, lanes in pixel order: the identity order) on > 95% of pixels
    with max |d| < 1e-4,
    as tests/test_engine.py:166-191 holds the JAX package's sorted path
    (measured: every pixel bit-equal). Cornell takes the sort by request
    and runs the texture path (F's texel albedo)."""
    sorted_ = _frames(scenes_dir, scene, sort_rays=True)
    monkeypatch.setattr(W, "permute_planes", lambda allp, key, rg: (
        allp, torch.arange(allp[0].numel())))
    unsorted = _frames(scenes_dir, scene, sort_rays=True)
    for a, b in zip(sorted_, unsorted):
        assert (a == b).all(axis=-1).mean() > 0.95
        assert np.abs(a - b).max() < 1e-4


def test_sorted_matches_whole_path(scenes_dir):
    """Diamond through the sorted wavefront against the whole-path kernel
    B1 (sort_rays=False). B1 takes the TPU whole-path kernel's baked row
    dots for the analytic geoms and F the full dot products (as the two
    TPU kernels do), so some bounces flip between near-tied geoms: within
    tests/test_golden.py's raw-frame budgets."""
    for a, b in zip(_frames(scenes_dir, "diamond", sort_rays=True),
                    _frames(scenes_dir, "diamond", sort_rays=False)):
        assert ((np.abs(a - b).max(axis=-1) > 1e-3).mean()
                < FRAC_BUDGET["diamond_raw_d4"])
        assert np.sqrt(((a - b) ** 2).mean()) < RMSE_BUDGET


def test_mesh_engine_choice(scenes_dir):
    """The JAX package's engine choice: the sort for more than four
    chunks, B1 at any chunk count with sort_rays=False, regroup 4 on at
    most 8 chunks, native mode (compat=False) with one light on the same
    engines as compat mode; the options that are not ported raise (the
    per-bounce engines render: tests/test_torch_bounce.py)."""
    bunny = Scene(str(scenes_dir / "bunny.txt"))
    diamond = Scene(str(scenes_dir / "diamond.txt"))

    def tracer(scene, **kw):
        return Renderer(scene, RenderConfig(**kw), (16, 16),
                        device="cpu").step.tracer
    assert tracer(bunny).engine == "sorted" and tracer(bunny).regroup == 0
    assert tracer(diamond).engine == "sorted"
    assert tracer(diamond).regroup == 4
    assert tracer(bunny, sort_rays=False).engine == "whole_path"
    for kw in (dict(sort_group=2), dict(sort_every=2)):
        with pytest.raises(NotImplementedError):
            tracer(bunny, **kw)
    native = tracer(bunny, compat=False)
    assert native.engine == "sorted" and not native.gi.compat
    assert tracer(bunny, compat=False, sort_rays=False).engine == "whole_path"


def test_renderer_defaults_to_the_card(scenes_dir):
    """Renderer(scene) with no device runs on the card; without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Renderer(Scene(str(scenes_dir / "diamond.txt")))


def test_sorted_wavefront_launches_no_kernel_on_cpu(mesh_renders):
    """On CPU tensors every wrapper of the sorted path took its plain
    version."""
    assert (E.shade_bounce.launches + F.trace_bounce.launches
            + G.inrow_permute.launches) == 0
