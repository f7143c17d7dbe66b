"""The port's plain device math against the JAX package's functions on
seeded random batches: TEA + LCG bit-exact, camera rays and ray/primitive
intersection to float32 rounding, the shade body lane for lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.ops import camera as jcam
from ptdn_tpu.ops import intersect as jint
from ptdn_tpu.ops import rng as jrng
from ptdn_tpu.ops.pallas.shade import shade_tiles
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu_torch.ops import bsdf, camera, intersect, rng
from ptdn_tpu_torch.scene import Scene

# Float tolerance of the non-RNG comparisons: XLA on the CPU fuses
# multiply-adds and evaluates rsqrt with an approximation that the plain
# versions reproduce only in part (ops/fp.py), so results agree to a few
# float32 ulps, not bit for bit.
RTOL = 1e-5
ATOL = 1e-5


def _u32(rng_, n):
    return rng_.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def test_tea_lcg_bit_exact():
    r = np.random.default_rng(0)
    v0, v1 = _u32(r, 4096), _u32(r, 4096)
    ref = np.asarray(jrng.init_rand(jnp.asarray(v0), jnp.asarray(v1)))
    got = rng.init_rand(torch.from_numpy(v0.astype(np.int64)),
                        torch.from_numpy(v1.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint32), ref)
    js, ts = jnp.asarray(ref), got
    mask = r.uniform(size=4096) < 0.5
    for _ in range(6):
        js, jv = jrng.next_rand_masked(js, jnp.asarray(mask))
        ts, tv = rng.next_rand_masked(ts, torch.from_numpy(mask))
        assert np.array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
        assert np.array_equal(tv.numpy()[mask], np.asarray(jv)[mask])


@pytest.fixture(scope="module")
def scenes(scenes_dir):
    path = str(scenes_dir / "cornell.txt")
    return JScene(path), Scene(path)


def test_camera_rays(scenes):
    js, ts = scenes
    for res in [(64, 64), (48, 80)]:
        jf = jcam.OrbitCamera(js.camera, res).frame()
        tf = camera.OrbitCamera(ts.camera, res).frame()
        for k in ("position", "view", "up", "right", "pixel_length"):
            assert np.array_equal(getattr(jf, k), getattr(tf, k)), k
        assert np.array_equal(jcam.view_matrix(jf), camera.view_matrix(tf))
        jo, jd = jcam.generate_camera_rays(jf.as_pytree(), res)
        to, td = camera.generate_camera_rays(tf.as_tensors("cpu"), res)
        assert np.array_equal(to.numpy(), np.asarray(jo))
        # the norm is a reduction; one ulp where XLA orders it otherwise
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=6e-8)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([-4.5, 0.5, -4.5], [4.5, 9.5, 9.0],
                  size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _cols(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, k]))
                 for k in range(x.shape[1]))


def test_box_sphere_intersect(scenes):
    js, ts = scenes
    o, d = _rays(4096, 1)
    jds = js.device()
    for g, gtype in enumerate(js.geom_types):
        tf, inv, invt = (np.array(jds.geom_transform[g]),
                         np.array(jds.geom_inverse[g]),
                         np.array(jds.geom_inv_transpose[g]))
        if gtype == 1:
            jt, _, jn, _, jh = jint.box_intersect(tf, inv, jnp.asarray(o),
                                                  jnp.asarray(d))
            tt, tn, th = intersect.box_intersect(
                torch.from_numpy(tf), torch.from_numpy(inv), _cols(o),
                _cols(d))
        elif gtype == 0:
            jt, _, jn, _, jh = jint.sphere_intersect(
                tf, inv, invt, jnp.asarray(o), jnp.asarray(d))
            tt, tn, th = intersect.sphere_intersect(
                torch.from_numpy(tf), torch.from_numpy(inv),
                torch.from_numpy(invt), _cols(o), _cols(d))
        else:
            continue
        jh = np.asarray(jh)
        assert np.array_equal(th.numpy(), jh), g
        np.testing.assert_allclose(tt.numpy()[jh], np.asarray(jt)[jh],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(torch.stack(tn, -1).numpy()[jh],
                                   np.asarray(jn)[jh], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("compat", [True, False])
def test_triangle_and_interpolation(compat):
    r = np.random.default_rng(2)
    n = 4096
    o, d = _rays(n, 3)
    v = [r.uniform(-3, 3, size=(n, 3)).astype(np.float32) for _ in range(3)]
    jt, ju, jv, jh = jint.ray_triangle(*(jnp.asarray(x) for x in (o, d, *v)))
    tt, tu, tv, th = intersect.ray_triangle(_cols(o), _cols(d),
                                            *(_cols(x) for x in v))
    jh = np.asarray(jh)
    assert (th.numpy() == jh).mean() > 0.999
    both = th.numpy() & jh
    for a, b in ((tt, jt), (tu, ju), (tv, jv)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=RTOL, atol=ATOL)
    nrm = [r.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    uvs = [r.uniform(size=(n, 2)).astype(np.float32) for _ in range(3)]
    u = r.uniform(0, 0.5, n).astype(np.float32)
    w = r.uniform(0, 0.5, n).astype(np.float32)
    jn, juv = jint.interpolate_tri_hit(
        jnp.asarray(u), jnp.asarray(w), *(jnp.asarray(x) for x in nrm),
        *(jnp.asarray(x) for x in uvs), compat=compat)
    tn, tuv = intersect.interpolate_tri_hit(
        torch.from_numpy(u), torch.from_numpy(w), *(_cols(x) for x in nrm),
        *(_cols(x) for x in uvs), compat=compat)
    np.testing.assert_allclose(torch.stack(tn, -1).numpy(), np.asarray(jn),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch.stack(tuv, -1).numpy(), np.asarray(juv),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shadow_ray,reduce_var", [(True, True),
                                                   (False, True),
                                                   (True, False)])
def test_shade_matches_shade_tiles(scenes, shadow_ray, reduce_var):
    """The shade body lane for lane against the JAX package's fused one
    (ops/pallas/shade.py:shade_tiles) on random states of every material.
    The RNG draws are exact, so each lane takes the same branch unless a
    Schlick or reflect test sits within rounding of its variate: at least
    99.9% of lanes agree on every output within the float tolerance."""
    from ptdn_tpu.engine.wavefront import _static_mats
    from ptdn_tpu.ops.pallas.shade import lane_seed

    js, ts = scenes
    r = np.random.default_rng(4)
    shape = (8, 128)
    n = 1024
    o, d = _rays(n, 5)
    nrm = r.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    t = r.uniform(0.1, 5, n).astype(np.float32)
    alb = r.uniform(size=(n, 3)).astype(np.float32)
    tr = r.uniform(0.2, 1, size=(n, 3)).astype(np.float32)
    mat = r.integers(0, len(js.materials), n)
    act = r.uniform(size=n) < 0.8
    dif = r.uniform(size=n) < 0.3
    light = [float(x) for x in js.geoms[0].translation]
    frame_depth = 7

    def pl(x):
        return jnp.asarray(x.reshape(shape))
    tiles = {"ox": pl(o[:, 0]), "oy": pl(o[:, 1]), "oz": pl(o[:, 2]),
             "dx": pl(d[:, 0]), "dy": pl(d[:, 1]), "dz": pl(d[:, 2]),
             "t": pl(t), "nx": pl(nrm[:, 0]), "ny": pl(nrm[:, 1]),
             "nz": pl(nrm[:, 2]), "ar": pl(alb[:, 0]), "ag": pl(alb[:, 1]),
             "ab": pl(alb[:, 2]), "tr": pl(tr[:, 0]), "tg": pl(tr[:, 1]),
             "tb": pl(tr[:, 2]), "rr": pl(np.zeros(n, np.float32)),
             "rg": pl(np.zeros(n, np.float32)),
             "rb": pl(np.zeros(n, np.float32)),
             "mat": pl(mat.astype(np.float32)),
             "act": pl(act.astype(np.float32)),
             "dif": pl(dif.astype(np.float32))}
    seed = lane_seed(0, jnp.uint32(frame_depth), shape)
    ref = shade_tiles(tiles, seed, (*light, np.float32(1.4), np.float32(2.7),
                                    0.0),
                      mats=_static_mats(js), shadow_ray=shadow_ray,
                      reduce_var=reduce_var)
    s = {"o": _cols(o), "d": _cols(d), "t": torch.from_numpy(t),
         "n": _cols(nrm), "alb": _cols(alb), "tr": _cols(tr),
         "mat": torch.from_numpy(mat), "act": torch.from_numpy(act),
         "dif": torch.from_numpy(dif)}
    pix = torch.arange(n, dtype=torch.int64)
    out = bsdf.shade(s, rng.init_rand(pix, torch.full_like(pix, frame_depth)),
                     ts.device("cpu").mat_attr, light, 1.4, 2.7, False,
                     shadow_ray, reduce_var)

    def flat(k):
        return np.asarray(ref[k]).reshape(n)
    agree = np.ones(n, bool)
    for k, got in (("act", out["act"]), ("dif", out["dif"]),
                   ("nee", out["nee"])):
        agree &= got.numpy() == (flat(k) > 0.5)
    pairs = (list(zip(("dx", "dy", "dz"), out["d"]))
             + list(zip(("spx", "spy", "spz"), out["sp"]))
             + list(zip(("tr", "tg", "tb"), out["tr"]))
             + list(zip(("er", "eg", "eb"), out["er"]))
             + list(zip(("sdx", "sdy", "sdz"), out["sd"]))
             + list(zip(("cr", "cg", "cb"), out["c"])))
    for k, got in pairs:
        a, b = got.numpy(), flat(k)
        finite = np.isfinite(b)
        agree &= ~finite | np.isclose(a, b, rtol=1e-4, atol=1e-4)
    assert agree.mean() >= 0.999
