"""Kernel Q (ranges_and_key, the sorted wavefront's range and key glue)
through its plain PyTorch version against the JAX engine's XLA code on
the shared edge inputs (ops/cuda/ranges.py:edge_inputs; the scenes' own
chunk tables, room's among them, are test_torch_mesh.py's
test_ranges_and_key_match_jax); the wrappers of Q and N dispatching CPU
tensors to their plain versions; bounce_bench's Q case on a captured
call; and, on a card only, Q and N against their plain versions."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdn_tpu.engine import wavefront as JW
from ptdn_tpu_torch import bounce_bench as BB
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import ranges as Q
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.ops.cuda import texgather as N
from ptdn_tpu_torch.ops.fp import dot3, sqrt
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)
from test_torch_ranges_card import EDGE  # noqa: F401


def _jax_ranges_and_key(case):
    """The JAX engine's ranges_and_key, jitted as the engine runs it, on
    an edge_inputs case."""
    sh, pix = case["sh"], case["pix"]
    nb = sh.shape[1]
    jds = types.SimpleNamespace(tri_chunk_min=jnp.asarray(case["cmin"]),
                                tri_chunk_max=jnp.asarray(case["cmax"]))
    lp = case["light_pos"]
    kw = ({} if lp is None else
          dict(light_pos=jnp.asarray(lp),
               light_radius=jnp.float32(case["light_radius"])))
    p, k = jax.jit(lambda s, q: JW.ranges_and_key(
        jds, s, q, nb * 128, nb, case["n_chunks"], case["do_vis"], **kw))(
            jnp.asarray(sh), jnp.asarray(pix))
    return np.asarray(p), np.asarray(k)


@pytest.mark.parametrize("label", list(EDGE))
def test_ranges_and_key_edge_inputs_match_jax(label):
    """Q's plain version against the JAX engine's ranges_and_key on 4096
    lanes of each edge case: ±0 and axis-parallel directions, origins on
    box faces, NaN and inf planes on dead lanes, chunk tables of 64 boxes
    (the last tested box by box), 65 (the first in supergroups, G = 2)
    and 233 (G = 4), the morton key, do_vis off and no light limit. The
    26 planes and the key equal bit for bit (NaN where NaN)."""
    case = EDGE[label]
    ref_p, ref_k = _jax_ranges_and_key(case)
    got_p, got_k = Q.ranges_and_key_plain(*Q.edge_call(case))
    assert np.array_equal(got_p.numpy(), ref_p, equal_nan=True)
    assert np.array_equal(got_k.numpy(), ref_k)
    # the edge lanes are live: some cross a box, some lanes are dead
    assert (got_k.numpy() == Q.SENTINEL).any()
    assert (got_p[21].numpy() < case["n_chunks"]).any()


def test_range_boxes():
    """Q's box table: the chunk boxes up to 64 chunks, the supergroups'
    union boxes past them (G = 2 at 65 chunks, its last group one chunk
    and an empty box)."""
    for count, g in ((64, 1), (65, 2), (233, 4)):
        case = next(c for c in EDGE.values() if c["n_chunks"] == count)
        ds = Q.chunk_scene(case["cmin"], case["cmax"])
        assert Q.range_group(count) == g
        boxes = Q.range_boxes(ds, count).numpy()
        assert boxes.shape == (-(-count // g), 6)
        for s in (0, boxes.shape[0] - 1):
            rows = slice(s * g, min(s * g + g, count))
            assert np.array_equal(boxes[s, :3], case["cmin"][rows].min(0))
            assert np.array_equal(boxes[s, 3:], case["cmax"][rows].max(0))


def test_ranges_and_key_cpu_takes_plain():
    """Q's wrapper gives a CPU tensor to the plain version and counts no
    launch, with or without a box table."""
    case = EDGE["65 boxes, morton key"]
    args = Q.edge_call(case)
    before = Q.ranges_and_key.launches
    ref_p, ref_k = Q.ranges_and_key_plain(*args)
    for kw in ({}, {"boxes": Q.range_boxes(args[0], case["n_chunks"])}):
        p, k = W.ranges_and_key(*args, **kw)
        assert torch.equal(k, ref_k)
        assert np.array_equal(p.numpy(), ref_p.numpy(), equal_nan=True)
    assert Q.ranges_and_key.launches == before


@pytest.mark.parametrize("start,n", [(0, 4097), (1, 4096), (3, 1), (1, 0)])
def test_gather_u32_cpu_slices(start, n):
    """N's wrapper on an odd length, a slice at a misaligned offset, one
    index and none: the plain version, equal to numpy's gather, and no
    launch counted."""
    rng = np.random.default_rng(1)
    table = rng.integers(0, 2 ** 32, 3001, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 3001, 4100).astype(np.int32)
    before = N.gather_u32.launches
    got = N.gather_u32(torch.from_numpy(table),
                       torch.from_numpy(idx)[start:start + n])
    assert got.dtype == torch.uint32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), table[idx[start:start + n]])
    assert N.gather_u32.launches == before


def test_bounce_bench_q_case():
    """bounce_bench's Q case, on diamond's bounce 2 at 128x96 on the CPU:
    the captured call carries the sorted engine's box table, the bench's
    plain call equals the wrapper's on every plane and the key, and the
    bound counts Q's bytes and box tests."""
    args, kw = BB.capture("ranges_and_key", "diamond", (128, 96),
                          device="cpu")
    # E's call of the same bounce, which wrote into allp's first planes
    (planes, _), e_kw = kw.pop("shade")
    assert e_kw["out"].shape == (Q.N_OUT,) + tuple(planes.shape[1:])
    ds, sh = args[0], args[1]
    assert sh.shape[0] == Q.N_ALLP
    assert torch.equal(kw["boxes"], Q.range_boxes(ds, args[3]))
    out = BB.plain_fn("ranges_and_key")(*args, **kw)
    planes = BB.out_planes("ranges_and_key", out)
    assert len(planes) == 27
    want = BB.out_planes("ranges_and_key", W.ranges_and_key(*args, **kw))
    assert not any(BB.plane_diffs(planes, want).values())
    assert BB.n_lanes("ranges_and_key", args) == sh[0].numel()
    ms, by = BB.work("ranges_and_key", args, kw, out, 0)
    tests = Q.box_tests(sh, kw["boxes"].shape[0])
    lanes, live, nee = Q.lane_counts(sh)
    assert lanes == sh[0].numel() and 0 < nee <= live < lanes
    assert tests == (live + nee) * kw["boxes"].shape[0]
    assert ms > 0 and by in ("bytes", "operations")


def test_ranges_traffic_counts_needed_planes():
    """Q's byte bound counts the planes each lane needs (8 on every lane:
    the live flag, the pixel plane in and out, the four ranges and the
    key; 7 more on a live lane; the shadow direction's 3 on a lane with a
    shadow ray): 32 B a dead lane, 72 B a live lane with a shadow ray."""
    case = EDGE["64 boxes, morton key"]
    sh = torch.from_numpy(case["sh"]).clone()
    n = sh[0].numel()
    sh[Q.O_ACT] = 0.0
    assert Q.lane_counts(sh) == (n, 0, 0) and Q.traffic(sh) == 32 * n
    sh[Q.O_ACT] = 1.0
    sh[Q.O_NEE] = 0.0
    assert Q.lane_counts(sh) == (n, n, 0) and Q.traffic(sh) == 60 * n
    sh[Q.O_NEE] = 1.0
    assert Q.traffic(sh) == 72 * n
    # a NaN live flag is a dead lane, as the kernel reads it
    sh[Q.O_ACT, 0, 0] = float("nan")
    assert Q.lane_counts(Q.new_allp(sh)) == (n, n - 1, n - 1)


@pytest.mark.parametrize("label", list(EDGE))
def test_ranges_and_key_in_place_match_jax(label):
    """The sorted bounce's allp filled in place: E's planes in its first
    21 (as E writes them there), Q's wrapper on the CPU fills planes
    21..25 of that buffer and returns it, equal plane for plane and in
    the key, bit for bit, to Q's plain version and to the JAX engine's
    ranges_and_key on every edge case; E's planes are left as they
    were."""
    case = EDGE[label]
    ds, allp, pix, *rest = Q.edge_call(case)
    sh = allp[:Q.N_OUT].clone()
    assert allp[Q.N_OUT:].isnan().all()
    p, k = W.ranges_and_key(ds, allp, pix, *rest)
    assert p is allp
    ref_p, ref_k = Q.ranges_and_key_plain(ds, sh, pix, *rest)
    jp, jk = _jax_ranges_and_key(case)
    for want_p, want_k in ((ref_p.numpy(), ref_k.numpy()), (jp, jk)):
        assert np.array_equal(p.numpy(), want_p, equal_nan=True)
        assert np.array_equal(k.numpy(), want_k)
    assert np.array_equal(p[:Q.N_OUT].numpy(), sh.numpy(), equal_nan=True)


def test_shade_bounce_writes_into_allp():
    """E's wrapper with out= on the CPU: the plain version's planes,
    written into the given view of the bounce's allp and returned."""
    args, kw = BB.capture("ranges_and_key", "diamond", (128, 96),
                          device="cpu")
    (planes, mats), e_kw = kw.pop("shade")
    e_kw = {k: v for k, v in e_kw.items() if k != "out"}
    want = E.shade_bounce_plain(planes, mats, **e_kw)
    allp = torch.zeros((Q.N_ALLP,) + tuple(planes.shape[1:]))
    got = E.shade_bounce(planes, mats, **e_kw, out=allp[:Q.N_OUT])
    assert got.data_ptr() == allp.data_ptr()
    assert np.array_equal(allp[:Q.N_OUT].numpy(), want.numpy(),
                          equal_nan=True)
    assert not allp[Q.N_OUT:].any()


def _slab_test(lo, hi, o, inv, lim):
    """Per lane and box, the kernel's slab (NaN-propagating min and max,
    as torch's): (crossed, plainly missed)."""
    t0 = [(lo[:, k] - o[k][:, None]) * inv[k][:, None] for k in range(3)]
    t1 = [(hi[:, k] - o[k][:, None]) * inv[k][:, None] for k in range(3)]
    tmin = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                       torch.minimum(t0[1], t1[1])),
                         torch.minimum(t0[2], t1[2]))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                       torch.maximum(t0[1], t1[1])),
                         torch.maximum(t0[2], t1[2]))
    lim = lim[:, None]
    crossed = (tmax >= 0) & (tmin <= tmax) & (tmin <= lim)
    missed = (tmax < 0) | (tmin > tmax) | (tmin > lim)
    return crossed, missed


@pytest.mark.parametrize("label", [k for k in EDGE if "morton" in k])
def test_group_pretest_skips_only_missed_boxes(label):
    """Kernel Q's pre-test (csrc/ranges.cu): a ray skips the 8 boxes of
    a group whose union box (range_group_boxes) it plainly misses (no NaN
    and tmax < 0, tmin > tmax or tmin > limit). On every lane of the
    edge cases, next and shadow rays (±0 directions, origins on faces),
    and on the same boxes with their lo and hi swapped on an axis and
    with a NaN coordinate, no box of a skipped group is crossed: the
    skip cannot change a range."""
    case = EDGE[label]
    ds, allp, pix, n_chunks, _, lp, lrad = Q.edge_call(case)
    boxes = Q.range_boxes(ds, n_chunks)
    flipped = boxes.clone()
    flipped[::3, [0, 3]] = boxes[::3, [3, 0]]
    flipped[1::7, 4] = float("nan")
    sh = allp[:Q.N_OUT].reshape(Q.N_OUT, -1)
    o = [sh[Q.O_SPX + k] for k in range(3)]
    e = [torch.tensor(lp[k]) - o[k] for k in range(3)]
    s_lim = sqrt(dot3(e, e)) + lrad
    for table in (boxes, flipped):
        unions = Q.range_group_boxes(table)
        g = Q.BOX_GROUP
        for d0, lim in ((Q.O_DX, torch.full_like(o[0], float("inf"))),
                        (Q.O_SDX, s_lim)):
            inv = [1.0 / sh[d0 + k] for k in range(3)]
            crossed, _ = _slab_test(table[:, :3], table[:, 3:], o, inv, lim)
            _, skip = _slab_test(unions[:, :3], unions[:, 3:], o, inv, lim)
            member_skip = skip.repeat_interleave(g, dim=1)[:, :table.shape[0]]
            assert not (crossed & member_skip).any()
            assert skip.any() and crossed.any()
