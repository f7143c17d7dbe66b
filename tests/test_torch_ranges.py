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
from ptdn_tpu_torch.ops.cuda import texgather as N
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
    ds, sh = args[0], args[1]
    assert torch.equal(kw["boxes"], Q.range_boxes(ds, args[3]))
    out = BB.plain_fn("ranges_and_key")(*args, **kw)
    planes = BB.out_planes("ranges_and_key", out)
    assert len(planes) == 27
    want = BB.out_planes("ranges_and_key", W.ranges_and_key(*args, **kw))
    assert not any(BB.plane_diffs(planes, want).values())
    assert BB.n_lanes("ranges_and_key", args) == sh[0].numel()
    ms, by = BB.work("ranges_and_key", args, kw, out, 0)
    tests = Q.box_tests(sh, kw["boxes"].shape[0])
    assert 0 < tests <= 2 * sh[0].numel() * kw["boxes"].shape[0]
    assert ms > 0 and by in ("bytes", "operations")
