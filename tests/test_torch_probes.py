"""The ports of the TPU probes of benchmarks/ (kernels N, G at the
regroup probe's K = 29, O and P) and of reproj_bench's three PyTorch
reprojection variants, through their plain versions against the JAX
functions they port: the Pallas kernels in interpret mode, as the JAX
package's own tests run them, and the JAX package's XLA code; and, on a
card only, each kernel against its plain version."""

import ast
import functools
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ptdn_tpu.denoise import reproject as JRP
from ptdn_tpu.ops.pallas.inrow import inrow_permute_pallas
from ptdn_tpu_torch.denoise import reproject as RP
from ptdn_tpu_torch.ops.cuda import dyngather as O
from ptdn_tpu_torch.ops.cuda import inrow as G
from ptdn_tpu_torch.ops.cuda import intersect_v1 as P
from ptdn_tpu_torch.ops.cuda import texgather as N
from ptdn_tpu_torch.probes import dyngather as probe_o
from ptdn_tpu_torch.probes import regroup as probe_g
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:       # the benchmarks/ scripts import by path
    sys.path.insert(0, str(REPO))

from benchmarks.pallas_intersect_v1 import (RBLK, _mesh_kernel,  # noqa: E402
                                            mesh_intersect_pallas)
from benchmarks.pallas_texgather import gather_u32_pallas  # noqa: E402
from test_torch_probes_card import _random_mesh, _diamond_mesh  # noqa: F401


# ---------------------------------------------------------------------------
# kernel N

def test_gather_u32_matches_pallas():
    """N's plain version against gather_u32_pallas in interpret mode on a
    5,000-entry uint32 table and 2,048 indices (two 1024-index tiles,
    numpy seed 0, values over the whole 32 bits): equal."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 5000, 2048).astype(np.int32)
    want = np.asarray(gather_u32_pallas(jnp.asarray(table), jnp.asarray(idx),
                                        interpret=True))
    got = N.gather_u32(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# G at the regroup probe's shape

def test_inrow_permute_k29_matches_pallas():
    """benchmarks/micro_regroup.py:pallas_inrow's body (:77-81) is
    ptdn_tpu/ops/pallas/inrow.py's (:26-29), kernel G's function: G's plain
    version on the probe's K = 29 planes (16 rows of its inputs, numpy
    seed 0) permuted by the probe's per-row argsort of its keys, against
    inrow_permute_pallas in interpret mode, equal; the argsort
    (torch.sort, stable) equal to the probe's lax.sort_key_val."""
    planes, key2d, _, _ = probe_g.inputs("cpu", nb=16)
    order = probe_g.argsort_rows(key2d)
    iota = jnp.broadcast_to(jnp.arange(128, dtype=jnp.int32), (16, 128))
    want_order = jax.lax.sort_key_val(jnp.asarray(key2d.numpy()), iota)[1]
    assert np.array_equal(order.numpy(), np.asarray(want_order))
    want = np.asarray(inrow_permute_pallas(jnp.asarray(planes.numpy()),
                                           want_order, interpret=True))
    got = G.inrow_permute(planes, order)
    assert got.shape == (probe_g.K, 16, 128)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# kernel O

@functools.cache
def _dyngather_kern():
    """benchmarks/micro_dyngather.py:kern, compiled alone from the
    script's syntax tree: importing the script runs its probes on a TPU."""
    path = REPO / "benchmarks" / "micro_dyngather.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "kern")
    space = {"jnp": jnp}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         space)
    return space["kern"]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("reps", [1, 16])
def test_take_chain_matches_pallas(axis, reps):
    """O's plain version against the probe's kern under pallas_call in
    interpret mode, and against the numpy chain, on the probe's inputs at
    (32, 128) and (8, 256): equal."""
    for s, l in ((32, 128), (8, 256)):
        x, idx = probe_o.inputs(s, l, axis)
        want = np.asarray(pl.pallas_call(
            functools.partial(_dyngather_kern(), axis=axis, reps=reps),
            out_shape=jax.ShapeDtypeStruct((s, l), jnp.int32),
            interpret=True)(jnp.asarray(x), jnp.asarray(idx)))
        got = O.take_chain(torch.from_numpy(x), torch.from_numpy(idx), axis,
                           reps).numpy()
        assert np.array_equal(got, want), (s, l)
        assert np.array_equal(got, probe_o.numpy_chain(x, idx, axis, reps))


@pytest.mark.parametrize("case", probe_o.LONG)
def test_take_chain_long_lines_match_numpy(case):
    """Lines longer than a block's shared memory (70,000 int32, above
    58,112): tile_plan sends them to the global-load kernel, and O's plain
    version on them equals the probe's numpy chain."""
    s, l, axis, reps = case
    assert O.tile_plan(s, l, axis) == (0, 0)
    x, idx = probe_o.inputs(s, l, axis)
    got = O.take_chain(torch.from_numpy(x), torch.from_numpy(idx), axis,
                       reps).numpy()
    assert np.array_equal(got, probe_o.numpy_chain(x, idx, axis, reps))


def test_take_chain_tile_plan():
    """The staged kernel's tiles on every case of the probe: whole lines
    that fit a block's shared memory, no more than the array holds,
    STRIPE columns on axis 0 where they fit, the rows of PER elements on
    axis 1; and fewer columns where STRIPE of them do not fit."""
    for s, l, axis, _ in probe_o.CASES + probe_o.TIMED:
        lines, per = O.tile_plan(s, l, axis)
        m, n_lines = (s, l) if axis == 0 else (l, s)
        assert per == O.PER and 1 <= lines <= n_lines
        assert 4 * m * lines <= O.SMEM_MAX
        want = O.STRIPE if axis == 0 else max(1, O.PER // m)
        assert lines == min(want, n_lines)
    # STRIPE columns of 20,000 do not fit: halved to 2 (160 KB)
    assert O.tile_plan(20000, 4, 0) == (2, O.PER)


# ---------------------------------------------------------------------------
# kernel P


def _rough_pallas(ds, o, d, n_tris, cull):
    """mesh_intersect_pallas's kernel call alone: the rough (t, tri) of
    _mesh_kernel in interpret mode, its rays padded as it pads them."""
    from jax.experimental.pallas import tpu as pltpu

    n = o.shape[0]
    pad = (-n) % RBLK
    o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
    d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
    npad = n + pad
    o4 = jnp.concatenate([o, jnp.ones((npad, 1), jnp.float32)], axis=1)
    d4 = jnp.concatenate([d, jnp.zeros((npad, 1), jnp.float32)], axis=1)
    ray = pl.BlockSpec((RBLK, 4), lambda i: (i, 0), memory_space=pltpu.VMEM)
    whole = pl.BlockSpec(memory_space=pltpu.VMEM)
    out = pl.BlockSpec((RBLK, 1), lambda i: (i, 0), memory_space=pltpu.VMEM)
    t, i = pl.pallas_call(
        functools.partial(_mesh_kernel, n_chunks=ds.tri_mm.shape[0],
                          n_tris=n_tris, cull=cull),
        grid=(npad // RBLK,), in_specs=[ray, ray, whole, whole, whole],
        out_specs=[out, out],
        out_shape=[jax.ShapeDtypeStruct((npad, 1), jnp.float32)] * 2,
        interpret=True,
    )(o4, d4, ds.tri_mm, ds.tri_chunk_min, ds.tri_chunk_max)
    return np.asarray(t[:n, 0]), np.asarray(i[:n, 0]).astype(np.int32)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("mesh", ["diamond", "random"])
def test_mesh_intersect_v1_matches_pallas(scenes_dir, mesh, cull):
    """P's plain version against the TPU probe in interpret mode, on a
    duck-typed scene of the plane table and chunk boxes built by
    plane_arrays (the builder of ptdn_tpu/scene/scene.py before commit
    89cdc83): the rough (t, tri) of _mesh_kernel, and
    mesh_intersect_pallas's refined (t, u, v, tri, hit) against
    mesh_intersect's. The rough (t, tri) are equal on every ray, bit for
    bit (XLA on the CPU sums the 4-term plane dots as the kernel does,
    left to right in FMAs); the refined tri and hit are equal on every
    ray, and on the hits t is within rtol 1e-6 and u, v within 1e-5
    (measured: 5.7e-7 and 3.5e-6; the JAX refinement sums its 3-term
    products with jnp.sum, the port's ray_triangle in the fused kernels'
    FMA order)."""
    tri_v, o, d = (_diamond_mesh(scenes_dir) if mesh == "diamond"
                   else _random_mesh())
    tri_mm, cmin, cmax, tv = P.plane_arrays(tri_v)
    n_tris = tri_v.shape[0]
    jds = types.SimpleNamespace(tri_mm=jnp.asarray(tri_mm),
                                tri_chunk_min=jnp.asarray(cmin),
                                tri_chunk_max=jnp.asarray(cmax),
                                tri_v=jnp.asarray(tv))
    pt = P.PlaneTable(*(torch.from_numpy(a) for a in (tri_mm, cmin, cmax,
                                                      tv)), n_tris=n_tris)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    jt, ji = _rough_pallas(jds, jnp.asarray(o), jnp.asarray(d), n_tris, cull)
    t, tri = P.mesh_intersect_v1(pt, ot, dt, cull)
    assert (ji >= 0).sum() > 50
    assert np.array_equal(tri.numpy(), ji)
    assert np.array_equal(t.numpy().view(np.int32), jt.view(np.int32))
    want = [np.asarray(a) for a in mesh_intersect_pallas(
        jds, jnp.asarray(o), jnp.asarray(d), n_tris, cull, interpret=True)]
    got = [a.numpy() for a in P.mesh_intersect(pt, ot, dt, cull)]
    assert np.array_equal(got[3], want[3]) and np.array_equal(got[4],
                                                              want[4])
    hit = got[4]
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6)
    for k in (1, 2):
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-5)


@functools.cache
def _mesh_case(scenes_dir, mesh):
    """(the plane table as numpy arrays, n_tris, rays o, d, the TPU
    kernel's rough (t, tri) in interpret mode with the cull) of a mesh."""
    tri_v, o, d = (_diamond_mesh(scenes_dir) if mesh == "diamond"
                   else _random_mesh())
    arrays = P.plane_arrays(tri_v)
    jds = types.SimpleNamespace(tri_mm=jnp.asarray(arrays[0]),
                                tri_chunk_min=jnp.asarray(arrays[1]),
                                tri_chunk_max=jnp.asarray(arrays[2]))
    want = _rough_pallas(jds, jnp.asarray(o), jnp.asarray(d),
                         tri_v.shape[0], True)
    return arrays, tri_v.shape[0], o, d, want


@pytest.mark.parametrize("group", P.CULL_GROUPS)
@pytest.mark.parametrize("mesh", ["diamond", "random"])
def test_mesh_intersect_v1_cull_groups_match_pallas(scenes_dir, mesh, group):
    """P's plain version with the cull by groups of 1, 32 (the kernel's
    warp), 128 and 512 rays (the TPU kernel's block) against _mesh_kernel
    in interpret mode: the rough (t, tri) equal bit for bit at every
    group size; the tests it makes are counts[group], and they fall as
    the group shrinks."""
    arrays, n_tris, o, d, (jt, ji) = _mesh_case(scenes_dir, mesh)
    pt = P.PlaneTable(*map(torch.from_numpy, arrays), n_tris=n_tris)
    counts = {}
    P.mesh_intersect_v1_plain.tri_tests = 0
    t, tri = P.mesh_intersect_v1_plain(pt, torch.from_numpy(o),
                                       torch.from_numpy(d), True, group,
                                       counts=counts)
    assert (ji >= 0).sum() > 50
    assert np.array_equal(tri.numpy(), ji)
    assert np.array_equal(t.numpy().view(np.int32), jt.view(np.int32))
    assert P.mesh_intersect_v1_plain.tri_tests == counts[group]
    sizes = [counts[g] for g in P.CULL_GROUPS]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]


def test_mesh_intersect_v1_rejects_degenerate_triangles():
    """A mesh with zero-area triangles (a vertex repeated) and collinear
    ones among real ones, and a padded last chunk (300 triangles: 44 real
    lanes of its 128): plane_arrays leaves the planes of the zero-area and
    padding triangles non-finite, and P's plain version with the warp
    cull and with the 512-ray block cull equals _mesh_kernel in
    interpret mode bit for bit; no ray's winner is a degenerate or
    padding triangle (the NaN of their planes, 0 * inf in the w term of
    the direction dots among it, rejects them)."""
    tri_v, o, d = _random_mesh()
    tri_v = tri_v.copy()
    bad = np.arange(0, 300, 7)
    zero, line = bad[::2], bad[1::2]
    tri_v[zero, 1] = tri_v[zero, 0]
    tri_v[line, 2] = 2 * tri_v[line, 1] - tri_v[line, 0]
    arrays = P.plane_arrays(tri_v)
    planes = arrays[0].transpose(0, 3, 1, 2).reshape(-1, 3, 4)
    for rows in (zero, np.arange(300, 384)):
        assert not np.isfinite(planes[rows]).all(axis=(1, 2)).any()
    jds = types.SimpleNamespace(tri_mm=jnp.asarray(arrays[0]),
                                tri_chunk_min=jnp.asarray(arrays[1]),
                                tri_chunk_max=jnp.asarray(arrays[2]))
    jt, ji = _rough_pallas(jds, jnp.asarray(o), jnp.asarray(d), 300, True)
    pt = P.PlaneTable(*map(torch.from_numpy, arrays), n_tris=300)
    for group in (P.WARP, P.RBLK):
        t, tri = P.mesh_intersect_v1_plain(pt, torch.from_numpy(o),
                                           torch.from_numpy(d), True, group)
        assert np.array_equal(tri.numpy(), ji)
        assert np.array_equal(t.numpy().view(np.int32), jt.view(np.int32))
    assert (ji >= 0).sum() > 50 and not np.isin(ji, bad).any()


# ---------------------------------------------------------------------------
# reproj_bench's variants

def _reproj_inputs(h):
    """tests/test_denoise.py:test_backprojection_packed_parity's inputs
    (numpy seed 5) at h x h, as JAX and as torch arguments."""
    rng = np.random.default_rng(5)
    w = h
    gb_c = {"position": rng.normal(size=(h, w, 3)).astype(np.float32) * 3,
            "normal": rng.normal(size=(h, w, 3)).astype(np.float32),
            "geom_id": rng.integers(-1, 3, size=(h, w)).astype(np.int32)}
    gb_p = {"position": rng.normal(size=(h, w, 3)).astype(np.float32) * 3,
            "normal": (gb_c["normal"] + 0.05 * rng.normal(
                size=(h, w, 3)).astype(np.float32)),
            "geom_id": rng.integers(-1, 3, size=(h, w)).astype(np.int32)}
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    color = rng.uniform(size=(h, w, 3)).astype(np.float32)
    ch = rng.uniform(size=(h, w, 3)).astype(np.float32)
    mh = rng.uniform(size=(h, w, 2)).astype(np.float32)
    hl = rng.integers(0, 6, size=(h, w)).astype(np.int32)
    arrays = (color, gb_c, gb_p, vm, ch, mh, hl)

    def conv(f):
        return tuple({k: f(v) for k, v in a.items()} if isinstance(a, dict)
                     else f(a) for a in arrays)
    return (((w, h),) + conv(jnp.asarray) + (jnp.float32(0.2),
                                             jnp.float32(0.2)),
            ((w, h),) + conv(torch.from_numpy) + (0.2, 0.2))


@pytest.mark.parametrize("size", [24, 64])
@pytest.mark.parametrize("name", ["window", "packed", "packed2"])
def test_reproj_variants_match_jax(name, size):
    """back_projection_window, _packed and _packed2 against the JAX
    package's (ptdn_tpu/denoise/reproject.py:120,205,580) on
    tests/test_denoise.py:246's inputs, 24 x 24 and 64 x 64, within that
    test's atol 1e-5 (the moments differ in the last bit on some pixels:
    XLA fuses their products otherwise)."""
    jargs, targs = _reproj_inputs(size)
    want = getattr(JRP, "back_projection_" + name)(*jargs)
    got = getattr(RP, "back_projection_" + name)(*targs)
    for x, y, what in zip(want, got, ["var", "color", "moment", "hist"]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# launches

def test_probe_kernels_launch_nothing_on_cpu(scenes_dir):
    """On CPU tensors N, O and P took their plain versions."""
    test_gather_u32_matches_pallas()
    O.take_chain(*(torch.from_numpy(a) for a in probe_o.inputs(8, 128, 1)),
                 1, 4)
    tri_v, o, d = _random_mesh()
    pt = P.PlaneTable(*(torch.from_numpy(a) for a in P.plane_arrays(tri_v)),
                      n_tris=tri_v.shape[0])
    P.mesh_intersect(pt, torch.from_numpy(o), torch.from_numpy(d))
    assert (N.gather_u32.launches + O.take_chain.launches
            + P.mesh_intersect_v1.launches) == 0
