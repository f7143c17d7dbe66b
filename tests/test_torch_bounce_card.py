"""The per-bounce engines' kernels H, I, J and K against their plain
versions on the card. The file imports no JAX, so that it runs where the
card is:

    python3 -m pytest --noconftest tests/test_torch_bounce_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_bounce.py."""

import pytest
import torch

from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.engine import wavefront as W
from ptdn_tpu_torch.ops.cuda import bounce as H
from ptdn_tpu_torch.ops.cuda import compact as K
from ptdn_tpu_torch.ops.cuda import scene_intersect as A
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh_card import _bits_equal, _no_plane_differs
from torch_card import scenes_dir  # noqa: F401 (fixture)


# the two per-bounce engines' flags: the JAX engines bounce_fused and
# bounce_pallas (wavefront.py:1392-1476)
ENGINES = {"bounce_fused": dict(fuse_path=False, sort_rays=False),
           "bounce_split": dict(fuse_path=False, fuse_bounce=False)}


def _capture_bounce(scenes_dir, name, depth=2, res=(64, 64), device="cpu"):
    """Planes and arguments of kernel H's bounce `depth` in the port's
    bounce_fused engine (frame 1, a static camera)."""
    rend = Renderer(Scene(str(scenes_dir / f"{name}.txt")),
                    RenderConfig(trace_depth=3, denoise_enable=False,
                                 **ENGINES["bounce_fused"]),
                    res, device=device)
    rend.render_frame()
    seen = []
    real = W.bounce_fused

    def spy(ds_, gi_, planes, **kw):
        seen.append((planes.clone(), kw))
        return real(ds_, gi_, planes, **kw)
    W.bounce_fused = spy
    try:
        rend.render_frame()
    finally:
        W.bounce_fused = real
    return rend.step.tracer, seen[depth - 1]


@pytest.mark.cuda
def test_per_bounce_kernels_match_plain_on_card(scenes_dir):
    """H, I, J and K against their plain versions on the card at 128x96
    (chip_smoke.py does this at the main path's shapes), on cornell's
    bounce 2: H's hits on >= 99.9% of lanes and its shading planes equal,
    I, J and K equal; and H on bunny's and room's bounce 2, each build,
    with no lane differing on any of its 21 planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")),
                 RenderConfig(trace_depth=3, **ENGINES["bounce_split"]),
                 (128, 96), "cuda")
    r.render_frame()
    seen = {}
    real = (W.light_visibility, W.scene_intersect_full_tex)

    def spy(key, fn):
        def call(*args, **kw):
            seen.setdefault(key, []).append(
                [a.clone() if torch.is_tensor(a) else a for a in args])
            return fn(*args, **kw)
        return call
    W.light_visibility = spy("i", real[0])
    W.scene_intersect_full_tex = spy("j", real[1])
    try:
        r.render_frame()
    finally:
        W.light_visibility, W.scene_intersect_full_tex = real
    ds, gi, o, d, lg = seen["i"][1]
    assert torch.equal(A._light_visibility_kernel(ds, gi, o, d, lg),
                       A.light_visibility_plain(ds, gi, o, d, lg))
    ds, gi, o, d = seen["j"][1]
    kj, kt = A._scene_intersect_full_tex_kernel(ds, gi, o, d)
    pj, pt = A.scene_intersect_full_tex_plain(ds, gi, o, d)
    assert torch.equal(kj["geom_id"], pj["geom_id"])
    assert torch.equal(kt, pt)
    table = ds.tex_flat_u32.view(torch.int32)
    assert torch.equal(
        K._sparse_gather_kernel(table, kt, kj["mat_id"], ds.mat_attr),
        K.sparse_gather_plain(table, kt, kj["mat_id"], ds.mat_attr))
    tr, (planes, kw) = _capture_bounce(scenes_dir, "cornell", res=(128, 96),
                                       device="cuda")
    kh = H._bounce_fused_kernel(tr.ds, tr.gi, planes, **kw)
    ph = H.bounce_fused_plain(tr.ds, tr.gi, planes, **kw)
    agree = (kh[H.B_MAT] == ph[H.B_MAT]) & (kh[H.B_ACT] == ph[H.B_ACT])
    assert agree.float().mean() >= 0.999
    for k in (H.B_SPX, H.B_DX, H.B_TR, H.B_DIF):
        assert _bits_equal(kh[k].cpu().numpy(), ph[k].cpu().numpy()), k
    _no_plane_differs("bounce_fused", ("bunny", "room"))
