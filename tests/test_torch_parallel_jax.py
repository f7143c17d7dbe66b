"""The row-sharded frame step (ptdn_tpu_torch/parallel/) against the JAX
package on the CPU: halo_rows against the JAX halo_rows under
jax.shard_map on tests/conftest.py's 8 virtual CPU devices, kernel D's
shard mode (plain) against atrous_level_pallas' in interpret mode fed
from the JAX halos, and the stitched sharded frame against a live JAX
render. The port's own bit-for-bit tests are test_torch_parallel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.ops.pallas.atrous import atrous_halo as jatrous_halo
from ptdn_tpu.ops.pallas.atrous import atrous_level_pallas
from ptdn_tpu.ops.pallas.atrous import pack_static_planes as jpack
from ptdn_tpu.parallel.halo import halo_rows as jhalo_rows
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch.parallel.halo import halo_rows
from ptdn_tpu_torch.parallel.mesh import InProcessGroup
from ptdn_tpu_torch.parallel.sharded import ShardedRenderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)
from test_torch_parallel import atrous_inputs, atrous_shards  # noqa: F401
from test_torch_slice import CONFIGS, _within_budget

AX = "rows"


def _mesh(n):
    cpus = jax.devices("cpu")
    if len(cpus) < n:
        pytest.skip(f"needs {n} virtual CPU devices")
    return Mesh(np.asarray(cpus[:n]), (AX,))


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


@pytest.mark.parametrize("halo", [4, 8, 24])
def test_halo_rows_match_jax(halo):
    """The in-process group's halo_rows against the JAX halo_rows under
    jax.shard_map on 8 CPU devices (h = 64, 8-row shards; 24 rows take
    three hops): equal bit for bit."""
    h, w, n = 64, 16, 8
    x = np.random.default_rng(5).normal(size=(h, w)).astype(np.float32)

    def body(xs):
        t, b = jhalo_rows(xs, halo, AX)
        return jnp.concatenate([t, xs, b], axis=0)

    want = np.asarray(_shard_map(body, _mesh(n), P(AX), P(AX))(
        jnp.asarray(x))).reshape(n, h // n + 2 * halo, w)
    slabs = list(torch.from_numpy(x).reshape(n, h // n, w))
    tops, bottoms = halo_rows(InProcessGroup(n), slabs, halo)
    for i in range(n):
        got = torch.cat([tops[i], slabs[i], bottoms[i]]).numpy()
        assert np.array_equal(got.view(np.int32), want[i].view(np.int32))


def _pallas_shards(x, n, level, blur, albedo):
    """atrous_level_pallas in interpret mode on n row shards of the image
    under jax.shard_map, its halos from the JAX halo_rows (the JAX
    package's _make_sharded_pyramid, one level)."""
    h, w = x["variance"].shape
    hl = h // n
    sh = jatrous_halo(5)

    def body(c, v, pos, nrm, alb):
        r0 = (jax.lax.axis_index(AX) * hl).astype(jnp.float32)
        st = jnp.concatenate([pos, nrm, alb], -1)
        t, b = jhalo_rows(st, sh, AX)
        ext = jnp.concatenate([t, st, b])
        gb = {"position": ext[..., 0:3], "normal": ext[..., 3:6],
              "albedo": ext[..., 6:9], "ialbedo": jnp.ones_like(ext[..., :3])}
        sp, shalo = jpack(gb, max_level=5, with_albedo=True,
                          pre_extended=True)
        halo = jatrous_halo(level)
        t4, b4 = jhalo_rows(jnp.concatenate([c, v[..., None]], -1), halo, AX)
        oc, ov = atrous_level_pallas(
            c, v, sp, shalo, (hl, w), level, albedo, 0.45, 0.2, 0.35, blur,
            albedo, interpret=True, row0=r0, full_h=h,
            halo_top=(t4[..., :3], t4[..., 3]),
            halo_bottom=(b4[..., :3], b4[..., 3]))
        return oc, ov

    f = _shard_map(body, _mesh(n), (P(AX),) * 5, (P(AX), P(AX)))
    return f(*(jnp.asarray(x[k].numpy()) for k in (
        "color", "variance", "position", "normal", "albedo")))


@pytest.mark.parametrize("hl,level,blur,albedo", [
    (8, 1, True, False), (8, 3, True, False), (8, 5, True, False),
    (16, 2, False, False), (16, 5, False, True)])
def test_atrous_shard_mode_matches_pallas(atrous_inputs, hl, level, blur,
                                          albedo):
    """D's shard mode (plain) on shards of 8 and 16 rows of a 64x48 image
    against the JAX package's sharded atrous_level_pallas in interpret
    mode, fed from its halo_rows (levels 1-5, the blur on and off, level
    5 with the albedo; 8-row shards take up to eight hops at level 5),
    to the 1e-5 of tests/test_torch_kernels.py's unsharded comparison.
    Every combination of level, blur and albedo is held against the
    unsharded level bit for bit in test_torch_parallel.py; a sharded
    Pallas level costs ~5 s of interpret-mode compile on the CPU, so
    these five stand for them here."""
    x = atrous_inputs
    rc, rv = _pallas_shards(x, 64 // hl, level, blur, albedo)
    got = atrous_shards(x, hl, level, blur, albedo)
    np.testing.assert_allclose(torch.cat([g[0] for g in got]).numpy(),
                               np.asarray(rc), atol=1e-5)
    np.testing.assert_allclose(torch.cat([g[1] for g in got]).numpy(),
                               np.asarray(rv), atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_slice_matches_live_xla(scenes_dir, name):
    """The stitched frame of 4 shards of 16 rows (cornell at 64x64, 3
    frames, plain versions) against a live JAX Renderer(backend="xla")
    render of the same config, within tests/test_torch_slice.py's
    budgets."""
    path = str(scenes_dir / "cornell.txt")
    r = ShardedRenderer(Scene(path), RenderConfig(**CONFIGS[name]),
                        (64, 64), InProcessGroup(4), device="cpu")
    got = [a.numpy() for a in (r.render_frame(), r.render_frame(),
                               r.render_frame())[-1]]
    ref = JRenderer(JScene(path), JConfig(backend="xla", **CONFIGS[name]),
                    resolution=(64, 64)).render(3)
    _within_budget(name, got, ref)
