"""Kernel P (mesh_intersect_v1): the plane-form rough closest triangle
hit over 128-triangle chunks with a chunk cull by the warp
(csrc/intersect_v1.cu), its plain PyTorch version, the host builder of
its plane table, and the refinement of its winner.

Replaces the TPU kernel benchmarks/pallas_intersect_v1.py:
mesh_intersect_pallas (:109, body _mesh_kernel, :44), the superseded
first mesh closest hit, which kernel A replaced on the renderer's path;
its script is ptdn_tpu_torch/probes/intersect_v1.py. The kernel returns
each ray's rough (t, tri); mesh_intersect then refines the winner with
the exact Moller-Trumbore test (ops/intersect.py:ray_triangle), in
PyTorch, as the JAX function does in XLA.

Neither package's DeviceScene carries the plane table or the (C, 3)
chunk boxes any more, so plane_table builds them on the host, as
ptdn_tpu/scene/scene.py built tri_mm before it was dropped. The TPU
kernel's two MXU matmuls per chunk become six 4-term dots per lane in
float32 FMAs, left to right (no tensor cores, no TF32), and its cull by
512-ray blocks a cull by 32-ray warps, in which rays past the last do
not vote (the same answer on every input checked: the cull changes the
work alone, up to rays that graze a chunk's box).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.fp import fma
from ptdn_tpu_torch.ops.intersect import FLT_EPSILON, FLT_MAX, ray_triangle

RBLK = 512       # the TPU kernel's rays per block, which shared its cull
WARP = 32        # the kernel's cull group: a warp of 32 rays
CULL_GROUPS = (1, WARP, 128, RBLK)   # the cull groups that counts= counts
TCHUNK = 128     # triangles per chunk
F = np.float32


class PlaneTable(NamedTuple):
    """A mesh's plane-form tables: tri_mm (C, 3, 4, 128) float32, for
    triangle j of chunk c the columns (n, -n.v0), (g1, c1), (g2, c2);
    the chunk boxes cmin, cmax (C, 3) over real triangles; the vertices
    tri_v (C * 128, 3, 3) for the refinement; the triangle count."""
    tri_mm: torch.Tensor
    cmin: torch.Tensor
    cmax: torch.Tensor
    tri_v: torch.Tensor
    n_tris: int


def plane_arrays(tri_v: np.ndarray):
    """The host builder of the plane table (ptdn_tpu/scene/scene.py
    before commit 89cdc83): from (T, 3, 3) float32 vertices, padded with
    zero rows to whole chunks (at least one), returns numpy arrays
    (tri_mm (C, 3, 4, 128), cmin (C, 3), cmax (C, 3), padded vertices).
    Degenerate and padding triangles give non-finite planes, which the
    kernel culls (-b_n >= FLT_EPSILON fails)."""
    tri_v = np.asarray(tri_v, F).reshape(-1, 3, 3)
    n_tris = tri_v.shape[0]
    tp = max(-(-n_tris // TCHUNK), 1) * TCHUNK
    tv = np.concatenate([tri_v, np.zeros((tp - n_tris, 3, 3), F)])
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    nrm = np.cross(e1, e2)
    with np.errstate(divide="ignore", invalid="ignore"):
        g1 = np.cross(e2, nrm)
        g1 = g1 / np.sum(g1 * e1, axis=-1, keepdims=True)
        g2 = np.cross(e1, nrm)
        g2 = g2 / np.sum(g2 * e2, axis=-1, keepdims=True)
        d0 = np.sum(nrm * v0, axis=-1)
        c1 = -np.sum(g1 * v0, axis=-1)
        c2 = -np.sum(g2 * v0, axis=-1)
    planes = np.stack([
        np.concatenate([nrm, -d0[:, None]], axis=1),
        np.concatenate([g1, c1[:, None]], axis=1),
        np.concatenate([g2, c2[:, None]], axis=1),
    ], axis=1).astype(F)                                  # (Tp, 3, 4)
    n_chunks = tp // TCHUNK
    tri_mm = np.ascontiguousarray(
        planes.reshape(n_chunks, TCHUNK, 3, 4).transpose(0, 2, 3, 1))
    # chunk boxes over real triangles only (padding rows excluded)
    cmin = np.zeros((n_chunks, 3), F)
    cmax = np.zeros((n_chunks, 3), F)
    for c in range(n_chunks):
        lo, hi = c * TCHUNK, min((c + 1) * TCHUNK, n_tris)
        if lo < hi:
            cmin[c] = tri_v[lo:hi].reshape(-1, 3).min(axis=0)
            cmax[c] = tri_v[lo:hi].reshape(-1, 3).max(axis=0)
    return tri_mm, np.nan_to_num(cmin), np.nan_to_num(cmax), tv


def plane_table(scene, device) -> PlaneTable:
    """The plane table of a host Scene's triangles on `device`."""
    tri_mm, cmin, cmax, tv = plane_arrays(scene.tri_v)
    dev = torch.device(device)
    return PlaneTable(*(torch.from_numpy(a).to(dev)
                        for a in (tri_mm, cmin, cmax, tv)),
                      n_tris=int(scene.n_tris))


def _dot4(x, m):
    """(x0, x1, x2, x3) . m, summed left to right in FMAs, as the kernel;
    x3 a Python float (1 or 0)."""
    return fma(x[3], m[3], fma(x[2], m[2], fma(x[1], m[1], x[0] * m[0])))


def mesh_intersect_v1_plain(pt: PlaneTable, o: torch.Tensor, d: torch.Tensor,
                            cull: bool = True, group: int = WARP,
                            block_batch: int = 128, counts=None):
    """Plain PyTorch version of kernel P (see mesh_intersect_v1). With
    the cull, a chunk is tested on the rays of each group of `group`
    consecutive rays (the kernel's warp, WARP; the TPU kernel's block,
    RBLK) of which some real ray crosses its box before its running
    best; padding rays do not vote. That the answer is the same at every
    group size, and without the cull, is checked on the tests' meshes
    and the probe's rays, not guaranteed: a ray that grazes a box face
    (the slab test and the plane test round apart) can be culled at one
    size and hit there at another. block_batch blocks of RBLK rays are
    taken at a time. The lane-triangle tests made add up in
    mesh_intersect_v1_plain.tri_tests: the rays of the groups that test
    a chunk, padding rays included, times its 128 lanes. counts, a dict,
    gathers under each group size g of CULL_GROUPS the tests that a cull
    by groups of g would make on the same rays (with the cull)."""
    n = o.shape[0]
    dev = o.device
    npad = -(-n // RBLK) * RBLK
    o = torch.cat([o, torch.zeros((npad - n, 3), device=dev)])
    d = torch.cat([d, torch.ones((npad - n, 3), device=dev)])
    real_ray = torch.arange(npad, device=dev) < n
    lane = torch.arange(TCHUNK, device=dev)
    t_out, i_out = [], []
    for lo in range(0, npad, RBLK * block_batch):
        hi = lo + RBLK * block_batch
        ob, db, real = o[lo:hi], d[lo:hi], real_ray[lo:hi]
        r = ob.shape[0]
        inv = 1.0 / db
        best_t = torch.full((r,), FLT_MAX, device=dev)
        best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
        for c in range(pt.tri_mm.shape[0]):
            if cull:
                t0 = (pt.cmin[c] - ob) * inv
                t1 = (pt.cmax[c] - ob) * inv
                lo3, hi3 = torch.minimum(t0, t1), torch.maximum(t0, t1)
                tmin = torch.maximum(torch.maximum(lo3[:, 0], lo3[:, 1]),
                                     lo3[:, 2])
                tmax = torch.minimum(torch.minimum(hi3[:, 0], hi3[:, 1]),
                                     hi3[:, 2])
                vote = ((tmax >= 0.0) & (tmin <= tmax) & (tmin < best_t)
                        & real)
                sel = vote.view(-1, group).any(dim=1).repeat_interleave(
                    group).nonzero().squeeze(1)
                if counts is not None:
                    for g in CULL_GROUPS:
                        counts[g] = counts.get(g, 0) + int(
                            vote.view(-1, g).any(dim=1).sum()) * g * TCHUNK
            else:
                sel = torch.arange(r, device=dev)
            if sel.numel() == 0:
                continue
            mesh_intersect_v1_plain.tri_tests += sel.numel() * TCHUNK
            os_ = [ob[sel, k][:, None] for k in range(3)] + [1.0]
            ds_ = [db[sel, k][:, None] for k in range(3)] + [0.0]
            m = pt.tri_mm[c]
            a_n, b_n = _dot4(os_, m[0]), _dot4(ds_, m[0])
            a_u, b_u = _dot4(os_, m[1]), _dot4(ds_, m[1])
            a_v, b_v = _dot4(os_, m[2]), _dot4(ds_, m[2])
            t = -a_n / b_n
            u = fma(t, b_u, a_u)
            v = fma(t, b_v, a_v)
            ok = ((-b_n >= FLT_EPSILON) & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
                  & (lane < pt.n_tris - c * TCHUNK))
            # min: the first lane among equal minima
            ct, ci = torch.where(ok, t, FLT_MAX).min(dim=1)
            upd = ct < best_t[sel]
            best_t[sel] = torch.where(upd, ct, best_t[sel])
            best_i[sel] = torch.where(upd, c * TCHUNK + ci, best_i[sel])
        t_out.append(torch.where(best_i >= 0, best_t, -1.0))
        i_out.append(best_i.to(torch.int32))
    return torch.cat(t_out)[:n], torch.cat(i_out)[:n]


mesh_intersect_v1_plain.tri_tests = 0


def mesh_intersect_v1(pt: PlaneTable, o: torch.Tensor, d: torch.Tensor,
                      cull: bool = True):
    """The rough closest triangle hit of rays o, d (N, 3) float32 over
    the mesh of `pt`, as the TPU kernel returns it: t (N,) float32, -1
    where no triangle is hit, and tri (N,) int32, -1 there. `cull` skips
    a chunk unless some ray of the 32-ray warp crosses its box before its
    running best (less work; the same answer up to rays that graze a
    box, see mesh_intersect_v1_plain). CPU tensors take the plain
    version; CUDA tensors launch kernel P."""
    _lib.require(o.device, "mesh_intersect_v1")
    if o.device.type == "cpu":
        return mesh_intersect_v1_plain(pt, o, d, cull)
    return _mesh_intersect_v1_kernel(pt, o, d, cull)


def _mesh_intersect_v1_kernel(pt, o, d, cull=True):
    n = o.shape[0]
    c = pt.tri_mm.shape[0]
    _lib.check_tensor(o, torch.float32, (n, 3), "o")
    _lib.check_tensor(d, torch.float32, (n, 3), "d")
    _lib.check_tensor(pt.tri_mm, torch.float32, (c, 3, 4, TCHUNK), "tri_mm")
    _lib.check_tensor(pt.cmin, torch.float32, (c, 3), "cmin")
    _lib.check_tensor(pt.cmax, torch.float32, (c, 3), "cmax")
    if pt.tri_mm.data_ptr() % 16:
        raise ValueError("tri_mm: the kernel reads it in 16-byte pieces")
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    p, i32 = _lib.ptr, ctypes.c_int
    _lib.launch("ptdn_mesh_intersect_v1", p(o), p(d), p(pt.tri_mm),
                p(pt.cmin), p(pt.cmax), i32(n), i32(c), i32(pt.n_tris),
                i32(int(cull)), p(t), p(tri))
    mesh_intersect_v1.launches += 1
    return t, tri


mesh_intersect_v1.launches = 0


def mesh_intersect(pt: PlaneTable, o: torch.Tensor, d: torch.Tensor,
                   cull: bool = True):
    """Closest mesh hit of rays o, d (N, 3): (t, u, v, tri, hit), the
    JAX function's contract. Kernel P's rough winner (mesh_intersect_v1)
    refined by the exact Moller-Trumbore test of that one triangle
    (ray_triangle); t and tri are -1 where it misses."""
    _, tri = mesh_intersect_v1(pt, o, d, cull)
    rough_hit = tri >= 0
    tv = pt.tri_v[tri.clamp(min=0).to(torch.int64)]
    col = lambda x: tuple(x[:, k] for k in range(3))  # noqa: E731
    t, u, v, hit = ray_triangle(col(o), col(d), col(tv[:, 0]), col(tv[:, 1]),
                                col(tv[:, 2]))
    hit = hit & rough_hit & (t > 0.0)
    return (torch.where(hit, t, -1.0), u, v, torch.where(hit, tri, -1), hit)
