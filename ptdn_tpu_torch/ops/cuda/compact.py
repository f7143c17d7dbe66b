"""Kernel K (sparse_gather): the per-bounce texel fetch of the unsorted
per-bounce engines (csrc/compact.cu), with its plain PyTorch version.

Replaces the TPU kernels ptdn_tpu/ops/pallas/compact.py:
compact_rows_pallas and uncompact_rows_pallas, with the XLA take between
them (gather_compacted, sparse_gather): the packed texel table[idx[i]]
of each lane with idx[i] >= 0. It also unpacks the texel and selects
against the lane's material color, the rest of the JAX engine's albedo
fetch (engine/wavefront.py:albedo_from with sparse_cap, :141-144, and
albedo_from_comp, :316-320), and returns the three albedo planes.

Dropped from the TPU design: the per-row compaction, the slot routing
back to the lanes, the gather-width tiers with their device-wide
`max(count)` and `lax.cond` dispatch, and the dense fallback. They exist
because TPU gathers are count-bound (compact.py:1-19); a GPU thread reads
its own texel, and every tier gives the same values. In PyTorch the tier
choice would also cost a device-to-host read every bounce.
"""

from __future__ import annotations

import ctypes

import torch

from ptdn_tpu_torch.ops.cuda import _lib
from ptdn_tpu_torch.ops.cuda.scene_intersect import COLORDIVIDOR


class GatherArgs(ctypes.Structure):
    """Mirror of csrc/compact.cu:GatherArgs."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("table", "idx", "mat",
                                                "mat_attr", "alb")]
                + [("n", ctypes.c_int)])


def sparse_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                        mat: torch.Tensor,
                        mat_attr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K (see sparse_gather)."""
    valid = idx >= 0
    packed = table[idx.clamp(min=0).to(torch.int64)]
    color = mat_attr[mat.to(torch.int64)]
    return torch.stack([
        torch.where(valid, ((packed >> (8 * c)) & 0xFF).to(torch.float32)
                    * COLORDIVIDOR, color[..., c]) for c in range(3)])


def sparse_gather(table: torch.Tensor, idx: torch.Tensor, mat: torch.Tensor,
                  mat_attr: torch.Tensor) -> torch.Tensor:
    """The albedo of lanes with flat texel indices idx (int32, any shape,
    -1 where the material is untextured) into the packed texel table
    (T,) int32 and materials mat (int32, idx's shape) of the (M, 16)
    material table: (3,) + idx.shape float32, the texel's r, g, b in
    [0, 1] where idx >= 0, else the material color. CPU tensors take the
    plain version; CUDA tensors launch kernel K."""
    _lib.require(idx.device, "sparse_gather")
    if idx.device.type == "cpu":
        return sparse_gather_plain(table, idx, mat, mat_attr)
    return _sparse_gather_kernel(table, idx, mat, mat_attr)


def _sparse_gather_kernel(table, idx, mat, mat_attr):
    shape = tuple(idx.shape)
    _lib.check_tensor(table, torch.int32, (table.shape[0],), "table")
    _lib.check_tensor(idx, torch.int32, shape, "idx")
    _lib.check_tensor(mat, torch.int32, shape, "mat")
    _lib.check_tensor(mat_attr, torch.float32, (mat_attr.shape[0], 16),
                      "mat_attr")
    alb = torch.empty((3,) + shape, dtype=torch.float32, device=idx.device)
    p = _lib.ptr
    args = GatherArgs(table=p(table), idx=p(idx), mat=p(mat),
                      mat_attr=p(mat_attr), alb=p(alb), n=idx.numel())
    _lib.launch("ptdn_sparse_gather", args)
    sparse_gather.launches += 1
    return alb


sparse_gather.launches = 0
