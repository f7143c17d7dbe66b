"""Kernel B1's table build (csrc/path_trace_table.cu): the scenes past the
per-scene build's limits (more than 64 geoms, more than 1,024
materials, a constant that is not finite) keep the whole-path engine and
take it, where the per-scene build refused them on the card. Its tables
against the constants the per-scene header writes, its fixed paths
against the baked row forms on every float32 class, its per-geom cull
against every hit of the 65-geom scene's rays, the three causes on
generated cornell variants, a 65-geom frame against the JAX package's
live render, and, on a card only, the table build against the per-scene
build and the plain version."""

import re

import numpy as np
import pytest
import torch

from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch.ops.cuda import path as B
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.ops.fp import fma
from ptdn_tpu_torch.ops.intersect import (FMA_X, FMA_Y, FMA_Z, MUL_X, MUL_Y,
                                          MUL_Z, TWO, TWO_B, box_intersect,
                                          form_value)
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.scene.parser import CUBE
from ptdn_tpu_torch.utils.assets import write_cornell_plus
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)
from test_torch_b1_table_card import RAW_D3, CAUSES, _bits, frames, _b1_args, _b1_plain, _assert_same  # noqa: F401

FRAC_BUDGET, RMSE_BUDGET = 0.01, 0.012


@pytest.mark.parametrize("name", ["cornell", "bunny"])
def test_row_table_holds_the_header_constants(scenes_dir, name):
    """The tables B1's table build reads (GeomInfo.row_code, row_coef, the
    (G, 2) geom table and the material table) hold, bit for bit, the
    constants path_scene_header writes for the per-scene build, read back
    from the header's C text: each geom's 15 row forms after its head,
    its 15 rows' coefficients after its box, with c3 = -0.0 where the
    row is a lone product (0.0 in the header; no form reads it there);
    each head names the geom's path (_row_path) and lets the kernel skip
    only cubes; scene_dev hands the tables to the kernels."""
    scene = Scene(str(scenes_dir / f"{name}.txt"))
    gi = A.geom_info(scene, "cpu")
    ds = scene.device("cpu")
    n_g = len(scene.geoms)

    def array(key):
        m = re.search(key + r"(?:\[\d*\])+ = \{(.*?)\};", gi.path_scene, re.S)
        return re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f|-?\d+", m.group(1))

    def floats(key):
        return np.float32([float.fromhex(v[:-1]) for v in array(key)])
    assert gi.table[:, 0].tolist() == [int(v) for v in array("kType")]
    assert gi.table[:, 1].tolist() == [int(v) for v in array("kMat")]
    assert gi.row_code.shape == (n_g, 16) and gi.row_coef.shape == (n_g, 17, 4)
    codes = [int(v) for v in array("kCode")]
    assert gi.row_code[:, 1:].reshape(-1).tolist() == codes
    header = floats("kCoef").reshape(n_g, 15, 4)
    rows = gi.row_coef[:, 2:].numpy()
    lone = (np.int32(codes).reshape(n_g, 15) >= MUL_X) & (
        np.int32(codes).reshape(n_g, 15) <= MUL_Z)
    assert lone.any()
    assert np.array_equal(_bits(rows[..., :3]), _bits(header[..., :3]))
    assert np.array_equal(_bits(rows[..., 3][~lone]),
                          _bits(header[..., 3][~lone]))
    assert (_bits(rows[..., 3][lone]) == _bits(np.float32(-0.0))).all()
    assert (_bits(header[..., 3][lone]) == 0).all()
    head = gi.row_code[:, 0].numpy()
    for g, geom in enumerate(scene.geoms):
        assert head[g] & 3 == A._row_path(geom.type, codes[15 * g:
                                                           15 * g + 15])
        assert not head[g] & A.HEAD_CULL or geom.type == CUBE
    assert np.array_equal(_bits(ds.mat_attr.numpy()).reshape(-1),
                          _bits(floats("kMatAttr")))
    sd = A.scene_dev(ds, gi, torch.device("cpu"))
    assert (sd.row_code, sd.row_coef) == (gi.row_code.data_ptr(),
                                          gi.row_coef.data_ptr())


# float32 values of every class: signed zeros, subnormals, the extremes,
# infinities and NaN, then ordinary values
SPECIAL = np.float32([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.1754942e-38,
                      3.4028235e38, -3.4028235e38, np.inf, -np.inf, np.nan,
                      1.0, -1.0, 0.5, -2.75])


def _specials(n, seed):
    """(x, y, z, o): float32 tensors of n values each, every SPECIAL value
    in every slot, the rest normal."""
    r = np.random.default_rng(seed)
    cols = r.normal(size=(4, n)).astype(np.float32) * np.float32(3)
    for k in range(4):
        cols[k, :len(SPECIAL) ** 2] = np.tile(SPECIAL, len(SPECIAL)) if (
            k % 2) else np.repeat(SPECIAL, len(SPECIAL))
        cols[k] = np.roll(cols[k], 7 * k)
    return [torch.from_numpy(c) for c in cols]


def table_row(path, c, r, v):
    """Row r of a geom on `path` from its table coefficients c (c0..c3)
    at v = (x, y, z), as csrc/path_trace_table.cu:CubeRows::row computes
    it."""
    if path == A.PATH_YROT and r != 1:
        return fma(c[0], v[0], c[1] * v[2]) + c[3]
    return fma(c[0], v[r], c[3])


def table_sub_row(path, c, r, o, v):
    """o - that row, as CubeRows::sub_row computes it: a lone product (c3
    is 0) fused into fma(-c0, v, o)."""
    if path == A.PATH_YROT and r != 1:
        return o - table_row(path, c, r, v)
    if c[3] == 0.0:
        return fma(-c[0], v[r], o)
    return o - fma(c[0], v[r], c[3])


def _same(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("path", ["diag", "yrot"])
def test_table_paths_compute_form_row_bits(tmp_path, path):
    """Each fixed path of the table build (a cube's rows read one slot
    each, or x then z on rows 0 and 2 of a rotation about y) computes,
    from the table's coefficients, the bits of form_value (the plain
    version's baked row, the per-scene build's form_row) and of o - row
    as the plain version fuses it (ops/intersect.py:_sub_row), on every
    row of every geom of the 65-geom scene on that path, at inputs that
    take every float32 class: +-0, subnormals, the extremes, +-inf, NaN.
    Both kinds of single-term rows (lone products and fmas) and both of
    two-term rows (with and without a bias) occur."""
    want = {"diag": A.PATH_DIAG, "yrot": A.PATH_YROT}[path]
    scene = Scene(write_cornell_plus(tmp_path, **CAUSES["65 geoms"]))
    gi = A.geom_info(scene, "cpu")
    codes, coefs = A.baked_rows(scene)
    codes, coefs = codes.reshape(-1, 15), coefs.reshape(-1, 15, 4)
    x, y, z, o = _specials(4096, seed=1)
    forms = set()
    geoms = [g for g in range(len(scene.geoms))
             if int(gi.row_code[g, 0]) & 3 == want]
    assert len(geoms) >= 10
    for g in geoms:
        for i in range(15):
            code, r = int(codes[g, i]), i % 3
            ref_c = [float(v) for v in coefs[g, i]]
            tab_c = [float(v) for v in gi.row_coef[g, 2 + i]]
            forms.add(code & 15)
            assert _same(table_row(want, tab_c, r, (x, y, z)),
                         torch.as_tensor(form_value(code, ref_c, (x, y, z)),
                                         dtype=torch.float32).expand(x.shape))
            if MUL_X <= code <= MUL_Z:
                ref_sub = fma(-ref_c[0], (x, y, z)[code - MUL_X], o)
            else:
                ref_sub = o - form_value(code, ref_c, (x, y, z))
            assert _same(table_sub_row(want, tab_c, r, o, (x, y, z)),
                         ref_sub)
    assert forms == ({MUL_X, MUL_Y, MUL_Z, FMA_X, FMA_Y, FMA_Z}
                     if path == "diag" else {MUL_Y, FMA_Y, TWO, TWO_B})


def test_cull_never_skips_a_hit(frames, monkeypatch):
    """On every ray B1 traces in the 65-geom scene at 64 x 64 (its
    closest-hit and shadow rays of depths 1-8 from the third frame's
    primary state) and on the scene's camera rays, no geom that the
    table build may skip (HEAD_CULL) and whose box the ray misses has a
    hit in the plain version's analytic test (box_intersect on the baked
    rows, t > 0), so the skip changes no closest hit, winner or not; and
    the cull skips most of those (ray, cube) tests of rays with finite
    components (a lane that left the scene carries NaN, and a NaN keeps
    every geom)."""
    r, _, _ = frames("65 geoms")
    args = _b1_args(r, 2)
    ds, gi = args[0], args[1]
    rays, real = [], A.analytic_best

    def spy(ds_, types, o, d, static=False):
        rays.append((o, d))
        return real(ds_, types, o, d, static)
    monkeypatch.setattr(A, "analytic_best", spy)
    _b1_plain(*args[:5], 8, *args[6:])
    monkeypatch.undo()
    cam_o, cam_d = args[2]["o"], args[2]["d"]
    rays.append((tuple(cam_o[:, k] for k in range(3)),
                 tuple(cam_d[:, k] for k in range(3))))
    assert len(rays) == 8 + 7 + 1   # shadow rays, next rays, camera
    culled = [g for g in range(len(gi.types))
              if int(gi.row_code[g, 0]) & A.HEAD_CULL]
    assert len(culled) == 55   # the small cubes, not cornell's
    tests = missed_total = hits = 0
    for o, d in rays:
        for g in culled:
            t, _, _ = box_intersect(ds.geom_transform[g], ds.geom_inverse[g],
                                    o, d, static=True)
            missed = A.table_box_missed(gi.row_coef[g, :2], o, d)
            assert not bool((missed & (t > 0.0)).any()), g
            live = torch.isfinite(torch.stack(o + d)).all(dim=0)
            tests += int(live.sum())
            missed_total += int((missed & live).sum())
            hits += int((t > 0.0).sum())
    print(f"{missed_total} of {tests} tests skipped, {hits} hits")
    assert hits > 1000 and missed_total > 0.6 * tests


@pytest.mark.parametrize("cause", sorted(CAUSES))
def test_scene_past_the_per_scene_build_keeps_the_whole_path(frames, cause):
    """Each cause alone makes path_scene None (B1's table build on the
    card) and the engine stays whole_path. The variants with materials no
    geom uses render cornell's frames bit for bit (an unused material's
    REFRIOR inf reaches no arithmetic; the JAX package renders that scene
    as cornell too); the 65-geom frame is finite."""
    r, (left, right), _ = frames(cause)
    tr = r.step.tracer
    assert tr.gi.path_scene is None and tr.engine == "whole_path"
    n_geoms, n_mats = len(tr.gi.types), tr.ds.mat_attr.shape[0]
    assert (n_geoms > A.B1_MAX_GEOMS) == (cause == "65 geoms")
    assert (n_mats > A.B1_MAX_MATS) == (cause == "1025 materials")
    assert (not torch.isfinite(tr.ds.mat_attr).all()) == (
        cause == "non-finite constant")
    if cause == "65 geoms":
        assert n_geoms == 65
        assert np.isfinite(left).all() and np.isfinite(right).all()
    else:
        _, (ref_left, ref_right), _ = frames(None)
        assert np.array_equal(_bits(left), _bits(ref_left))
        assert np.array_equal(_bits(right), _bits(ref_right))


def test_cornell65_frame_matches_live_jax(frames):
    """The port's 65-geom frame (cornell plus 55 cubes, cornell_raw_d3 at
    64 x 64, 3 frames: B1's baked rows over 65 geoms in the plain
    version) against the JAX package's live render of the same scene,
    within tests/test_golden.py's budgets for that config. The JAX
    whole-path Pallas kernel takes ~5 minutes to compile in interpret mode
    at 65 geoms, so the reference is the JAX XLA backend. Its cost is the
    cold compile of one frame program, whose 65 geoms are unrolled: a
    smaller image, one frame or depth 2 do not shorten it, and depth 1
    runs no bounce past the primary hit, which is B1's loop.
    Measured: 0.27% of pixels off by more than 1e-3, RMSE 0.0017."""
    _, got, path = frames("65 geoms")
    ref = JRenderer(JScene(path), JConfig(backend="xla", **RAW_D3),
                    resolution=(64, 64)).render(3)
    for img, want in zip(got, ref):
        diff = np.abs(img - np.asarray(want)).max(axis=-1)
        assert (diff > 1e-3).mean() < FRAC_BUDGET
        assert np.sqrt(((img - np.asarray(want)) ** 2).mean()) < RMSE_BUDGET


def test_table_build_launches_nothing_on_cpu(frames):
    """On CPU tensors B1 took its plain version, whichever build the
    scene would take on the card."""
    for cause in CAUSES:
        frames(cause)
    assert B.path_trace.launches == B.path_trace.table_launches == 0
