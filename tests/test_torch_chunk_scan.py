"""The block-level chunk scan of kernels F, H, A, J, I and M
(csrc/chunk_scan.cuh) as plain PyTorch, held to the per-lane scans it
replaces: F's joint scan of next and shadow rays, A's, J's and M's
closest-hit scan alone (the shadow query compiled out; M's with the
chunk cull on and off) and I's any-hit scan alone (the closest-hit query
compiled out); the Moller
predicate with its reciprocal deferred (the variant PERF.md measured)
held to moller; and the scene constants of the per-scene builds of F, H,
A and J (path_scene_header's matrices). The CUDA kernels themselves are
held to their plain versions on the card (tests/test_torch_mesh.py,
tests/test_torch_bounce.py, chip_smoke.py)."""

import functools
import re
import warnings

import numpy as np
import pytest
import torch

from ptdn_tpu_torch import trace_bench
from ptdn_tpu_torch.bounce_bench import capture_bounce
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import bounce as F
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.ops.cuda.shade import (O_ACT, O_DX, O_NEE, O_SDX,
                                           O_SPX)
from ptdn_tpu_torch.ops.fp import dot3
from ptdn_tpu_torch.ops.intersect import FLT_EPSILON, FLT_MAX, cross, moller
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import write_cornell_plus
from ptdn_tpu_torch.utils.config import RenderConfig

BLOCK = 128          # csrc/chunk_scan.cuh:kScanBlock
EMPTY = np.iinfo(np.int64).max   # an empty key (~0ull in the kernel)


@pytest.fixture(autouse=True, scope="module")
def torch_on_one_thread():
    """Run torch on one thread (see tests/test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.contiguous().view(torch.int32)


@functools.cache
def _scene(path):
    """Each scene loaded once for the module (terrain30k's BVH build alone
    takes ~14 s here)."""
    return Scene(str(path))


# ---------------------------------------------------------------------------
# the Moller predicate with its reciprocal deferred

def moller_deferred(o, d, v0, e1, e2):
    """moller in the order of the deferred-reciprocal variant that
    PERF.md measured: a, then q and t's numerator, and the reciprocal, u, v
    and t only where a >= FLT_EPSILON and dot(e2, q) > 0. Returns (t, ok),
    t defined where ok."""
    p = cross(d, e2)
    a = dot3(e1, p)
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    q = cross(s, e1)
    nt = dot3(e2, q)
    possible = (a >= FLT_EPSILON) & (nt > 0.0)
    f = torch.where(possible, 1.0 / torch.where(possible, a, 1.0), 0.0)
    u = f * dot3(s, p)
    v = f * dot3(d, q)
    t = f * nt
    ok = (possible & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 0.0))
    return t, ok


def _adversarial(n=20000, seed=0):
    """Seeded (o, d, v0, e1, e2) float32 rows: normal ones; +-0 and
    values whose products underflow; a exactly at FLT_EPSILON, just
    below it, and at huge magnitudes (1 / a subnormal, a infinite); rays
    through a triangle edge (u + v = 1 exactly) and vertex; inf and NaN
    components."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 15)).astype(np.float32)
    k = n // 8
    # zeros of either sign and underflowing products
    z = r.uniform(size=(k, 15)) < 0.3
    x[:k][z] = np.where(r.uniform(size=z.sum()) < 0.5, 0.0, -0.0)
    x[k:2 * k] *= np.float32(1e-22)
    # a = -e1y with d = (1, 0, 0), e2 = (0, 0, 1): at, below and far
    # above FLT_EPSILON, and overflowing to inf
    eps = np.float32(FLT_EPSILON)
    rows = x[2 * k:3 * k]
    rows[:, 3:6] = (1, 0, 0)
    rows[:, 12:15] = (0, 0, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 3e38 * 1e8 overflows to inf
        rows[:, 10] = -r.choice(
            [eps, np.nextafter(eps, np.float32(0)), np.float32(1e30),
             np.float32(3e38)], size=k) * np.float32(
                 r.choice([1, 1e8], size=k))
    # rays down the z axis onto the triangle (0,0,0) (1,0,0) (0,1,0)
    # scaled: u + v = 1 on the edge, u = v = 0 at the vertex
    rows = x[3 * k:4 * k]
    sc = np.float32(2.0) ** r.integers(-20, 20, size=k).astype(np.float32)
    uu = r.integers(0, 5, size=k).astype(np.float32) / 4
    edge = r.uniform(size=k) < 0.8
    vv = np.where(edge, 1 - uu, 0).astype(np.float32)
    rows[:, 0:3] = np.stack([uu * sc, vv * sc, sc], 1)
    rows[:, 3:6] = (0, 0, -1)
    rows[:, 6:9] = 0
    rows[:, 9:12] = np.stack([sc, 0 * sc, 0 * sc], 1)
    rows[:, 12:15] = np.stack([0 * sc, sc, 0 * sc], 1)
    # inf and NaN components
    bad = r.uniform(size=(k, 15)) < 0.1
    x[4 * k:5 * k][bad] = r.choice([np.inf, -np.inf, np.nan], size=bad.sum())
    t = torch.from_numpy(x)
    cols = [tuple(t[:, j + i] for i in range(3)) for j in range(0, 15, 3)]
    return cols


def test_deferred_reciprocal_predicate_is_moller():
    """The deferred-reciprocal Moller test equals moller (ops/intersect.py,
    the kernels' arithmetic) bit for bit on seeded adversarial rows: the
    predicate everywhere, t wherever it holds. Only the order of the work
    differs, so its loss on the card (PERF.md) is one of speed."""
    o, d, v0, e1, e2 = _adversarial()
    t_ref, ok_ref = moller(o, d, v0, e1, e2)
    t, ok = moller_deferred(o, d, v0, e1, e2)
    assert torch.equal(ok, ok_ref)
    assert torch.equal(_bits(t[ok]), _bits(t_ref[ok_ref]))
    # every class occurs: hits, edge hits, a at FLT_EPSILON on both sides
    a = dot3(e1, cross(d, e2))
    assert int(ok.sum()) > 500
    assert bool((ok & ((o[0] + o[1]) == o[2])).any())
    assert bool((a == np.float32(FLT_EPSILON)).any())
    assert bool(((a > 0) & (a < np.float32(FLT_EPSILON))).any())
    assert bool(torch.isinf(a).any()) and bool(torch.isnan(a).any())


# ---------------------------------------------------------------------------
# the block-level scan

def _query(o, d, lim, lo, hi, on, cull=True):
    return {"o": o, "d": d, "inv": tuple(1.0 / c for c in d),
            "lim": lim.clone(), "lo": lo, "hi": hi, "on": on.clone(),
            "best": torch.full(lim.shape, -1, dtype=torch.int64),
            "cull": cull}


def block_scan(ds, n_tris, nq, sq, visits):
    """chunk_scan (csrc/chunk_scan.cuh) on one block's lanes, in plain
    PyTorch: the union of the lanes' ranges; the vote for the next chunk
    cast before the current one is tested; at a chunk's turn each lane's
    own cull, then every triangle of the chunk against the rays that want
    it, each ray's result the smallest key (t's bits, index) among the
    hits below its limit at the chunk's start (a query whose "cull" is
    False wants every chunk of its range, the AABB test skipped). nq, sq
    (_query) are updated in place; `visits` counts the chunks the block
    tests."""
    n_chunks = -(-n_tris // BLOCK)
    for q in (nq, sq):
        q["lo"] = q["lo"].clamp(min=0)
        q["hi"] = q["hi"].clamp(max=n_chunks - 1)
    live = [q["on"] & (q["lo"] <= q["hi"]) for q in (nq, sq)]
    if not bool(live[0].any() | live[1].any()):
        return
    lo = int(torch.cat([q["lo"][m] for q, m in zip((nq, sq), live)]).min())
    hi = int(torch.cat([q["hi"][m] for q, m in zip((nq, sq), live)]).max())

    def wants(q, c):
        w = q["on"] & (q["lo"] <= c) & (q["hi"] >= c)
        return w & A._crossed(ds, c, q["o"], q["inv"], q["lim"]) \
            if q["cull"] else w

    def next_voted(c):
        for c in range(c + 1, hi + 1):
            if bool((wants(nq, c) | wants(sq, c)).any()):
                return c
        return hi + 1

    c = next_voted(lo - 1)
    while c <= hi:
        c2 = next_voted(c)
        want = [wants(nq, c), wants(sq, c)]
        visits[0] += 1
        base, end = c * BLOCK, min((c + 1) * BLOCK, n_tris)
        rows = ds.tri_moller[base:end]
        tri = [tuple(rows[:, 3 * j + i][None, :] for i in range(3))
               for j in range(3)]
        idx = torch.arange(base, end, dtype=torch.int64)[None, :]
        for q, w in zip((nq, sq), want):
            sel = w.nonzero().squeeze(1)
            if sel.numel() == 0:
                continue
            o = tuple(x[sel][:, None] for x in q["o"])
            d = tuple(x[sel][:, None] for x in q["d"])
            t, ok = moller(o, d, *tri)
            hit = ok & (t < q["lim"][sel][:, None])
            key = torch.where(hit, (_bits(t).to(torch.int64) << 32) | idx,
                              EMPTY).amin(dim=1)
            found = key != EMPTY
            got = sel[found]
            q["best"][got] = key[found] & 0xFFFFFFFF
            if q is nq:
                q["lim"][got] = (key[found] >> 32).to(torch.int32).view(
                    torch.float32)
            else:
                q["on"][got] = False
        c = c2


def scan_blocks(ds, n_tris, nq, sq):
    """block_scan over consecutive blocks of BLOCK lanes of the queries
    nq, sq (updated in place); returns the blocks' chunk visits."""
    visits = [0]
    for b in range(0, nq["lim"].numel(), BLOCK):
        sl = slice(b, b + BLOCK)
        part = [{k: (tuple(x[sl] for x in v) if isinstance(v, tuple)
                     else v[sl] if torch.is_tensor(v) else v)
                 for k, v in q.items()} for q in (nq, sq)]
        block_scan(ds, n_tris, *part, visits)
        for q, sub in zip((nq, sq), part):
            for k in ("lim", "best", "on"):
                q[k][sl] = sub[k]
    return visits[0]


def joint_scan(ds, gi, planes, do_next, light_geom):
    """The block scans of F's lanes (planes: its (25, NB, 128) input) as
    the kernel sets them up: the analytic part of both rays, then per
    block of BLOCK lanes one joint scan. Returns (the next query, its
    starting limit, the shadow query, the lanes whose closest analytic
    hit is the light, the blocks' chunk visits)."""
    p = planes.reshape(planes.shape[0], -1)
    o = (p[O_SPX], p[O_SPX + 1], p[O_SPX + 2])
    d = (p[O_DX], p[O_DX + 1], p[O_DX + 2])
    sd = (p[O_SDX], p[O_SDX + 1], p[O_SDX + 2])
    rng = p[F.R_NLO:F.R_SHI + 1].to(torch.int64)
    ts, gs, _ = A.analytic_best(ds, gi.types, o, sd)
    to_light = (p[O_NEE] > 0.5) & (gs == light_geom)
    tn, gn, _ = A.analytic_best(ds, gi.types, o, d)
    alive = (p[O_ACT] > 0.5) & torch.tensor(do_next and gi.n_tris > 0)
    lim0 = torch.where(alive, torch.where(gn >= 0, tn, FLT_MAX), -FLT_MAX)
    nq = _query(o, d, lim0, rng[0], rng[1], alive)
    sq = _query(o, sd, ts, rng[2], rng[3], to_light)
    visits = scan_blocks(ds, gi.n_tris, nq, sq)
    return nq, lim0, sq, to_light, visits


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("name", ["diamond", "bunny"])
def test_block_scan_equals_the_lane_scans(scenes_dir, monkeypatch, name,
                                          last):
    """The block-level scan, emulated over 128-lane blocks of F's real
    bounce-2 input (64x64, the first frame, coherence-sorted; dead lanes
    and empty ranges among them; `last`: bounce 2 is the last depth, no
    next ray), gives the closest (t, index) of mesh_best and the lit mask
    of light_visible bit for bit; and F's arithmetic (trace_lanes_plain)
    with its scans replaced by the block scan's results gives every one
    of its 24 planes bit for bit. F reads its lanes through the sort's
    order: the blocks are 128 consecutive sorted lanes."""
    r = Renderer(_scene(scenes_dir / f"{name}.txt"),
                 RenderConfig(trace_depth=2 if last else 3), (64, 64),
                 device="cpu")
    (ds, gi, allp, order), kw = capture_bounce(r, 2, ("trace_bounce",))[
        "trace_bounce"]
    kw = {k: v for k, v in kw.items() if k != "out"}
    planes = allp.reshape(allp.shape[0], -1).index_select(1, order)[
        :F.R_PIX].reshape((F.R_PIX,) + tuple(allp.shape[1:]))
    assert kw["do_next"] is not last and kw["do_vis"]
    p = planes.reshape(planes.shape[0], -1)
    assert bool((p[O_ACT] <= 0.5).any())                 # dead lanes
    assert bool((p[F.R_NLO] > p[F.R_NHI]).any())         # empty ranges
    nq, lim0, sq, to_light, visits = joint_scan(
        ds, gi, planes, kw["do_next"], kw["light_geom"])
    n_chunks = -(-gi.n_tris // BLOCK)
    assert 0 < visits < (p.shape[1] // BLOCK) * n_chunks
    o, d = nq["o"], nq["d"]
    if kw["do_next"]:
        bt, bi = A.mesh_best(ds, gi.n_tris, o, d, lim0)
        assert torch.equal(nq["best"], bi)
        assert torch.equal(_bits(nq["lim"]), _bits(bt))
        assert bool((bi >= 0).any())
    lit = A.light_visible(ds, gi, o, sq["d"], kw["light_geom"],
                          p[O_NEE] > 0.5)
    assert torch.equal(to_light & (sq["best"] < 0), lit)
    assert bool(lit.any()) and bool((to_light & ~lit).any())

    ref = F.trace_lanes_plain(ds, gi, planes, **kw)

    def scanned_best(ds_, n_tris, o_, d_, bt0, cull=True):
        assert torch.equal(_bits(bt0), _bits(lim0))
        return nq["lim"], nq["best"]

    monkeypatch.setattr(A, "mesh_best", scanned_best)
    monkeypatch.setattr(F, "light_visible",
                        lambda *a, **k: to_light & (sq["best"] < 0))
    got = F.trace_lanes_plain(ds, gi, planes, **kw)
    for a, b in zip(got, ref):
        if b is not None:
            assert torch.equal(_bits(a), _bits(b))


@functools.cache
def _split_calls(path, name):
    """The arguments of every call of the engine function `name` (A's
    scene_intersect_full, J's scene_intersect_full_tex or I's
    light_visibility) in the first frame of the scene at `path` through
    the split per-bounce engine (64x64, depth 3): A's primary hit first,
    then one call per bounce below the last; I's one call per bounce."""
    r = Renderer(_scene(path), RenderConfig(trace_depth=3, fuse_path=False,
                                            fuse_bounce=False), (64, 64),
                 device="cpu")
    real, calls = getattr(W, name), []

    def spy(*args, **kw):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return real(*args, **kw)
    setattr(W, name, spy)
    try:
        r.render_frame()
    finally:
        setattr(W, name, real)
    return calls


def hit_scan(ds, gi, o, d, cull=True):
    """The block scans of kernel A's, J's or M's rays o, d (N, 3) as the
    kernel sets them up: per ray the closest analytic hit, then per block
    of BLOCK rays the closest-hit query over every chunk (each ray behind
    its own cull, or with `cull` False none) and no shadow query. Returns
    (the query, its starting limit, the blocks' chunk visits)."""
    ot = tuple(o[:, k] for k in range(3))
    dt = tuple(d[:, k] for k in range(3))
    ta, ga, _ = A.analytic_best(ds, gi.types, ot, dt)
    lim0 = torch.where(ga >= 0, ta, FLT_MAX)
    n = lim0.numel()
    lo = torch.zeros(n, dtype=torch.int64)
    hi = torch.full((n,), -(-gi.n_tris // BLOCK) - 1, dtype=torch.int64)
    q = _query(ot, dt, lim0, lo, hi,
               torch.full((n,), gi.n_tris > 0, dtype=torch.bool), cull)
    off = _query(ot, dt, lim0, lo, hi, torch.zeros(n, dtype=torch.bool))
    visits = scan_blocks(ds, gi.n_tris, q, off)
    assert torch.equal(off["best"], torch.full((n,), -1))
    return q, lim0, visits


@pytest.mark.parametrize("name,kernel,call", [
    ("cornell", "scene_intersect_full", 0),        # A, camera rays
    ("bunny", "scene_intersect_full", 0),          # A, camera rays
    ("room", "scene_intersect_full_tex", 1),       # J, bounce 2
    ("bunny", "scene_intersect_full", 2)])         # A, bounce 2
def test_hit_scan_equals_mesh_best(scenes_dir, monkeypatch, name, kernel,
                                   call):
    """The closest-hit scan alone (the shadow query off), emulated over
    128-ray blocks of kernel A's and J's real calls in the split engine's
    first 64x64 frame (the camera rays of A's primary hit; the bounce-2
    rays of J on room and of A on bunny), gives mesh_best's closest (t,
    index) bit for bit; and A's and J's plain versions with mesh_best
    replaced by the scan's results give every output bit for bit: t,
    normal, uv, material, geom and J's texel index."""
    ds, gi, o, d = _split_calls(scenes_dir / f"{name}.txt", kernel)[call]
    q, lim0, visits = hit_scan(ds, gi, o, d)
    n_blocks = -(-o.shape[0] // BLOCK)
    assert 0 < visits <= n_blocks * -(-gi.n_tris // BLOCK)
    bt, bi = A.mesh_best(ds, gi.n_tris, tuple(o[:, k] for k in range(3)),
                         tuple(d[:, k] for k in range(3)), lim0)
    assert torch.equal(q["best"], bi)
    assert torch.equal(_bits(q["lim"]), _bits(bt))
    assert bool((bi >= 0).any()) and bool((bi < 0).any())

    plain = {"scene_intersect_full": A.scene_intersect_full_plain,
             "scene_intersect_full_tex": A.scene_intersect_full_tex_plain}[
                 kernel]
    ref = plain(ds, gi, o, d)

    def scanned_best(ds_, n_tris, o_, d_, bt0, cull=True):
        assert torch.equal(_bits(bt0), _bits(lim0))
        return q["lim"], q["best"]

    monkeypatch.setattr(A, "mesh_best", scanned_best)
    got = plain(ds, gi, o, d)
    if kernel == "scene_intersect_full_tex":
        (got, got_idx), (ref, ref_idx) = got, ref
        assert torch.equal(got_idx, ref_idx)
        assert bool((ref_idx >= 0).any())
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k].view(torch.int8), ref[k].view(torch.int8)), k


def _m_rays(scenes_dir, rays):
    """Kernel M's arguments (ds, gi, o, d) on CPU rays: "trace bench",
    the first 64 x 64 of the trace bench's 800 x 800 random rays (numpy
    seed 0) in cornell; "bunny camera", bunny's 64 x 64 camera rays (A's
    primary-hit call in the split engine's first frame)."""
    if rays == "bunny camera":
        return _split_calls(scenes_dir / "bunny.txt",
                            "scene_intersect_full")[0]
    scene = _scene(scenes_dir / "cornell.txt")
    o, d = trace_bench.random_rays(trace_bench.RES[0] * trace_bench.RES[1])
    return (scene.device("cpu"), A.geom_info(scene, "cpu"),
            torch.from_numpy(o[:64 * 64]), torch.from_numpy(d[:64 * 64]))


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("rays", ["trace bench", "bunny camera"])
def test_m_scan_equals_mesh_best(scenes_dir, monkeypatch, rays, cull):
    """Kernel M's closest-hit scan, emulated over 128-ray blocks with the
    chunk cull on or off (off: every block tests every chunk for every
    ray), gives mesh_best's closest (t, index) with the same switch bit
    for bit, and the same with the switch the other way; M's plain
    version with mesh_best replaced by the scan's results gives every
    output bit for bit (t_a, geom_a, normal_a, t_m, tri_m), on the trace
    bench's random rays (one chunk, hit by some lanes of every direction)
    and on bunny's camera rays (39 chunks). Without the cull the kernel
    walks each ray over the staged triangles in mesh_best's order; the
    emulation's list of every ray gives the same bits."""
    ds, gi, o, d = _m_rays(scenes_dir, rays)
    q, lim0, visits = hit_scan(ds, gi, o, d, cull)
    n_blocks = -(-o.shape[0] // BLOCK)
    n_chunks = -(-gi.n_tris // BLOCK)
    if cull:
        assert 0 < visits <= n_blocks * n_chunks
    else:
        assert visits == n_blocks * n_chunks
    ot = tuple(o[:, k] for k in range(3))
    dt = tuple(d[:, k] for k in range(3))
    for c in (cull, not cull):
        bt, bi = A.mesh_best(ds, gi.n_tris, ot, dt, lim0, c)
        assert torch.equal(q["best"], bi)
        assert torch.equal(_bits(q["lim"]), _bits(bt))
    assert bool((bi >= 0).any()) and bool((bi < 0).any())

    ref = A.scene_intersect_plain(ds, gi, o, d, cull)

    def scanned_best(ds_, n_tris, o_, d_, bt0, cull_=True):
        assert torch.equal(_bits(bt0), _bits(lim0)) and cull_ == cull
        return q["lim"], q["best"]

    monkeypatch.setattr(A, "mesh_best", scanned_best)
    got = A.scene_intersect_plain(ds, gi, o, d, cull)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k].view(torch.int8), ref[k].view(torch.int8)), k
    assert bool((ref["tri_m"] >= 0).any()) and bool((ref["geom_a"] >= 0).any())


def vis_scan(ds, gi, o, d, light_geom):
    """The block scans of kernel I's shadow rays o, d (N, 3) as the kernel
    sets them up: per ray the closest analytic hit, then per block of
    BLOCK rays the any-hit query over every chunk (each ray behind its own
    cull at the light's distance), on for the rays whose closest analytic
    hit is the light, and no closest-hit query. Returns (the query, the
    rays toward the light, the blocks' chunk visits)."""
    ot = tuple(o[:, k] for k in range(3))
    dt = tuple(d[:, k] for k in range(3))
    ta, ga, _ = A.analytic_best(ds, gi.types, ot, dt)
    to_light = ga == light_geom
    n = ta.numel()
    lo = torch.zeros(n, dtype=torch.int64)
    hi = torch.full((n,), -(-gi.n_tris // BLOCK) - 1, dtype=torch.int64)
    q = _query(ot, dt, ta, lo, hi, to_light & torch.tensor(gi.n_tris > 0))
    off = _query(ot, dt, ta, lo, hi, torch.zeros(n, dtype=torch.bool))
    visits = scan_blocks(ds, gi.n_tris, off, q)
    assert torch.equal(off["best"], torch.full((n,), -1))
    return q, to_light, visits


@pytest.mark.parametrize("name", ["cornell", "bunny", "room"])
def test_any_hit_scan_equals_light_visibility(scenes_dir, name):
    """The any-hit scan alone (the closest-hit query off), emulated over
    128-ray blocks of kernel I's real bounce-2 call in the split engine's
    first 64x64 frame, marks occluded exactly the rays that
    light_visibility_plain does not find lit: lit = toward the light and
    no occluder, on every lane. Lit and unlit rays occur on every scene,
    and rays toward the light that a triangle occludes on bunny and
    room."""
    ds, gi, o, d, light_geom = _split_calls(scenes_dir / f"{name}.txt",
                                            "light_visibility")[1]
    q, to_light, visits = vis_scan(ds, gi, o, d, light_geom)
    lit = to_light & (q["best"] < 0)
    ref = A.light_visibility_plain(ds, gi, o, d, light_geom)
    assert torch.equal(lit, ref)
    assert bool(lit.any()) and bool((~lit).any())
    n_blocks = -(-o.shape[0] // BLOCK)
    assert 0 <= visits <= n_blocks * -(-gi.n_tris // BLOCK)
    if name != "cornell":
        assert visits > 0 and bool((to_light & ~lit).any())


# ---------------------------------------------------------------------------
# the per-scene build's constants

def _floats(header, key):
    m = re.search(key + r"(?:\[\d*\])+ = \{(.*?)\};", header, re.S)
    return np.float32([float.fromhex(v[:-1]) for v in re.findall(
        r"-?0x[0-9a-f.]+p[+-]\d+f", m.group(1))])


@pytest.mark.parametrize("name", ["cornell", "diamond", "bunny", "room",
                                  "terrain30k"])
def test_scene_header_holds_the_matrices(scenes_dir, name):
    """path_scene_header writes each geom's inverse, transform and inverse
    transpose (kInvM, kTfM, kInvTM), which the per-scene builds of F, H, A
    and J (csrc/scene/scene_mats.cuh) fold into their code, as hex-float
    literals that parse back to the scene's float32 matrices bit for
    bit."""
    scene = _scene(scenes_dir / f"{name}.txt")
    gi = A.geom_info(scene, "cpu")
    ds = scene.device("cpu")
    n_g = len(scene.geoms)
    for key, m in (("kInvM", ds.geom_inverse), ("kTfM", ds.geom_transform),
                   ("kInvTM", ds.geom_inv_transpose)):
        want = m[:n_g].contiguous().view(torch.int32).numpy().reshape(-1)
        assert np.array_equal(_floats(gi.path_scene, key).view(np.int32),
                              want), key


def test_scene_header_is_none_past_the_limits(scenes_dir, tmp_path):
    """Past the per-scene builds' limits (65 geoms) or with a matrix that
    is not finite the header is None: F, H, A and J then launch from the
    kernel library (csrc/bounce.cu, csrc/scene_intersect.cu)."""
    gi = A.geom_info(Scene(write_cornell_plus(tmp_path, cubes=55)), "cpu")
    assert gi.path_scene is None
    scene = _scene(scenes_dir / "cornell.txt")
    ds = scene.device("cpu")
    codes, coefs = A.baked_rows(scene)
    mats = [m.numpy().copy() for m in (ds.geom_inverse, ds.geom_transform,
                                       ds.geom_inv_transpose)]
    args = (scene, ds.mat_attr.numpy(), codes, coefs)
    assert A.path_scene_header(*args, mats) is not None
    mats[1][2, 0, 0] = np.inf
    assert A.path_scene_header(*args, mats) is None
