"""Kernels Q and N against their plain versions on the card. The file
imports no JAX, so that it runs where the card is:

    python3 -m pytest --noconftest tests/test_torch_ranges_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_ranges.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import ranges as Q
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
