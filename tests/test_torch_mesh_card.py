"""The mesh scenes' kernels E, F and G against their plain versions on
the card. The file imports no JAX, so that it runs where the card is:

    python3 -m pytest --noconftest tests/test_torch_mesh_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_mesh.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch import bounce_bench as BB
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import bounce as F
from ptdn_tpu_torch.ops.cuda import inrow as G
from ptdn_tpu_torch.ops.cuda import shade as E
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from torch_card import scenes_dir  # noqa: F401 (fixture)


def _bits_equal(a, b):
    return np.array_equal(a, b) or bool(
        ((a == b) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.cuda
def test_mesh_kernels_match_plain_on_card(scenes_dir):
    """E, F and G against their plain versions on the card at 128x96
    (chip_smoke.py does this at the main path's shapes): E and G
    bit-equal, F (reading the bounce's planes through the sort's order)
    on >= 99.9% of hits on diamond; and F on bunny's and room's bounce 2
    and last bounce, each build (the scene's own, the kernel library's),
    with no lane differing on any of its 23 next planes or its radiance
    (the count of the per-lane scan it replaced, PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = Renderer(Scene(str(scenes_dir / "diamond.txt")),
                 RenderConfig(trace_depth=3), (128, 96), "cuda")
    r.render_frame()
    captured = {}
    real = (W.shade_bounce, W.trace_bounce)

    def spy_shade(planes, mats, **kw):
        captured.setdefault("e", (planes.clone(), mats, kw))
        return real[0](planes, mats, **kw)

    def spy_trace(ds, gi, allp, order, **kw):
        captured.setdefault("f", (ds, gi, allp.clone(), order.clone(),
                                  {k: v for k, v in kw.items()
                                   if k != "out"}))
        return real[1](ds, gi, allp, order, **kw)
    W.shade_bounce, W.trace_bounce = spy_shade, spy_trace
    try:
        r.render_frame()
    finally:
        W.shade_bounce, W.trace_bounce = real
    planes, mats, kw = captured["e"]
    ke = E._shade_bounce_kernel(planes, mats, **kw).cpu().numpy()
    assert _bits_equal(ke, E.shade_bounce_plain(planes, mats,
                                                **kw).cpu().numpy())
    ds, gi, tplanes, torder, tkw = captured["f"]
    kf = F._trace_bounce_kernel(ds, gi, tplanes, torder, **tkw)
    pf = F.trace_bounce_plain(ds, gi, tplanes, torder, **tkw)
    assert (kf[E.I_T] == pf[E.I_T]).float().mean() >= 0.999
    order = torch.stack([torch.randperm(128) for _ in range(
        tplanes.shape[1])]).int().cuda()
    # bit patterns: the planes hold NaN (dead lanes' ranges), which
    # torch.equal never finds equal
    assert torch.equal(
        G._inrow_permute_kernel(tplanes, order).view(torch.int32),
        G.inrow_permute_plain(tplanes, order).view(torch.int32))
    _no_plane_differs("trace_bounce", ("bunny", "room"))
    _no_plane_differs("trace_bounce", ("room",), call=8)


def _no_plane_differs(kernel, names, call=2):
    """Kernel F or H (bounce_bench's `kernel`) at bounce `call` (of 8) of
    each scene of `names` at 128x96, through both builds: no lane differs
    from the plain version in any bit of any output plane."""
    for name in names:
        (ds, gi, *rest), kw = BB.capture(kernel, name, (128, 96), call)
        ref = BB.out_planes(kernel, BB.plain_fn(kernel)(ds, gi, *rest,
                                                        **kw))
        assert gi.path_scene is not None
        for g in (gi, gi._replace(path_scene=None)):
            got = BB.out_planes(kernel, BB.kernel_fn(kernel)(ds, g, *rest,
                                                             **kw))
            diffs = BB.plane_diffs(got, ref)
            assert not any(diffs.values()), (name, g.path_scene is None,
                                             diffs)
