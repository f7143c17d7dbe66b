"""Kernels Q and N against their plain versions on the card. The file
imports no JAX, so that it runs where the card is:

    python3 -m pytest --noconftest tests/test_torch_ranges_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_ranges.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch import bounce_bench as BB
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import ranges as Q
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.ops.cuda import texgather as N


EDGE = Q.edge_inputs(0)


@pytest.mark.cuda
def test_ranges_and_texgather_match_plain_on_card():
    """On the card, Q on every edge case and N on odd lengths,
    misaligned slices and n = 0 against their plain versions: equal bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for label, case in EDGE.items():
        args = Q.edge_call(case, "cuda")
        ref_p, ref_k = Q.ranges_and_key_plain(*args)
        boxes = Q.range_boxes(args[0], case["n_chunks"])
        p, k = W.ranges_and_key(*args, boxes=boxes)
        assert torch.equal(k, ref_k), label
        assert bool(((p == ref_p) | (p.isnan() & ref_p.isnan())).all())
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
                             .astype(np.uint32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 5000, 4200).astype(np.int32)).cuda()
    for start, n in ((0, 4097), (1, 4096), (2, 4101), (3, 5), (1, 0)):
        ix = idx[start:start + n]
        want = N.gather_u32_plain(table, ix).view(torch.int32)
        got = N.gather_u32(table, ix)
        assert torch.equal(got.view(torch.int32), want), (start, n)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["diamond", "bunny", "room",
                                   "terrain30k"])
def test_ranges_in_place_match_plain_on_card(scene):
    """On each sorted scene's bounce 2 at 128x96 on the card: E writing
    into the first 21 planes of the bounce's allp, then Q filling the
    rest in place, equals Q's plain version on E's planes, every plane
    (NaN where NaN) and the key bit for bit; Q reads and writes no plane
    of E's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    args, kw = BB.capture("ranges_and_key", scene, (128, 96))
    (planes, mats), e_kw = kw.pop("shade")
    e_kw = {k: v for k, v in e_kw.items() if k != "out"}
    ds, allp, pix, *rest = args
    sh = E._shade_bounce_kernel(planes, mats, **e_kw)
    ref_p, ref_k = Q.ranges_and_key_plain(ds, sh, pix, *rest)
    buf = torch.full_like(allp, float("nan"))
    out = E.shade_bounce(planes, mats, **e_kw, out=buf[:Q.N_OUT])
    assert out.data_ptr() == buf.data_ptr()
    p, k = W.ranges_and_key(ds, buf, pix, *rest, **kw)
    assert p.data_ptr() == buf.data_ptr()
    assert torch.equal(k, ref_k)
    assert bool(((p == ref_p) | (p.isnan() & ref_p.isnan())).all())
    assert bool(((p[:Q.N_OUT] == sh) | (p[:Q.N_OUT].isnan() & sh.isnan()))
                .all())
