"""The probes' kernels N, G at K = 29, O and P against their plain
versions on the card. The file imports no JAX, so that it runs where the
card is:

    python3 -m pytest --noconftest tests/test_torch_probes_card.py

It skips without a card. The plain versions' CPU tests against the JAX
package are tests/test_torch_probes.py."""

import numpy as np
import pytest
import torch

from ptdn_tpu_torch.ops.camera import OrbitCamera, generate_camera_rays
from ptdn_tpu_torch.ops.cuda import dyngather as O
from ptdn_tpu_torch.ops.cuda import inrow as G
from ptdn_tpu_torch.ops.cuda import intersect_v1 as P
from ptdn_tpu_torch.ops.cuda import texgather as N
from ptdn_tpu_torch.probes import dyngather as probe_o
from ptdn_tpu_torch.probes import regroup as probe_g
from ptdn_tpu_torch.scene import Scene
from torch_card import scenes_dir  # noqa: F401 (fixture)


def _random_mesh():
    """300 random triangles (three chunks, the last part padding) inside
    [-1, 1]^3 and 1,300 rays from a sphere of radius 3 toward random
    points of that box (three 512-ray blocks, the last padded)."""
    rng = np.random.default_rng(1)
    v0 = rng.uniform(-1, 1, (300, 1, 3))
    tri_v = (v0 + rng.uniform(-0.3, 0.3, (300, 3, 3))).astype(np.float32)
    tri_v[:, 0] = v0[:, 0]
    o = rng.normal(size=(1300, 3))
    o = 3 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-1, 1, (1300, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri_v, o.astype(np.float32), d.astype(np.float32)


def _diamond_mesh(scenes_dir):
    """Diamond's 560 triangles (5 chunks) and its camera's rays at 60 x 40
    (2,400 rays: five blocks, the last padded)."""
    scene = Scene(str(scenes_dir / "diamond.txt"))
    cam = OrbitCamera(scene.camera, resolution=(60, 40)).frame().as_tensors(
        "cpu")
    o, d = generate_camera_rays(cam, (60, 40))
    return scene.tri_v, o.numpy(), d.numpy()


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(scenes_dir):
    """N, G at K = 29, O (its staged kernel, and its global-load kernel on
    lines too long to stage) and P (cull on and off; the plain version
    with the warp cull and with the TPU's 512-ray block cull) against
    their plain versions on the card, at the CPU tests' sizes
    (chip_smoke.py does so at the probes' own): all equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
                             .astype(np.uint32)).cuda()
    idx = torch.from_numpy(rng.integers(0, 5000, 4000).astype(np.int32)).cuda()
    assert torch.equal(N._gather_u32_kernel(table, idx).view(torch.int32),
                       N.gather_u32_plain(table, idx).view(torch.int32))
    planes, key2d, _, _ = probe_g.inputs("cuda", nb=64)
    order = probe_g.argsort_rows(key2d)
    assert torch.equal(G._inrow_permute_kernel(planes, order),
                       G.inrow_permute_plain(planes, order))
    for s, l, axis, reps in [(256, 512, 0, 16), (256, 512, 1, 16)] \
            + probe_o.LONG:    # the staged kernel, then the global-load one
        x, i = (torch.from_numpy(a).cuda() for a in probe_o.inputs(s, l, axis))
        assert torch.equal(O._take_chain_kernel(x, i, axis, reps),
                           O.take_chain_plain(x, i, axis, reps))
    for tri_v, o, d in (_random_mesh(), _diamond_mesh(scenes_dir)):
        pt = P.PlaneTable(*(torch.from_numpy(a).cuda()
                            for a in P.plane_arrays(tri_v)),
                          n_tris=tri_v.shape[0])
        ot, dt = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
        for cull in (True, False):
            kt, ki = P._mesh_intersect_v1_kernel(pt, ot, dt, cull)
            # the warp cull's plain version, and the TPU's block cull's
            for group in (P.WARP, P.RBLK):
                pt_, pi_ = P.mesh_intersect_v1_plain(pt, ot, dt, cull, group)
                assert torch.equal(ki, pi_) and torch.equal(kt, pt_)
