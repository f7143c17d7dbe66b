"""Kernel N (gather_u32): a flat uint32 table gather, out = table[idx]
(csrc/texgather.cu), with its plain PyTorch version.

Replaces the TPU kernel benchmarks/pallas_texgather.py:gather_u32_pallas
(:83; its body gather_table_groups, :42, and _kernel, :78), a probe of
texel-table gather throughput that no renderer path calls; its script is
ptdn_tpu_torch/probes/texgather.py. One CUDA thread reads 4
consecutive indices with 16-byte loads and stores, a scalar head and
tail around them (csrc/texgather.cu).

Dropped from the TPU design: the table's (G, 8, 128) group padding, the
per-1024-index-tile scan of the group range [gmin, gmax] with its 8-way
sublane select, and the MAX_GROUPS = 256 VMEM gate (room's 2 x 1024^2
atlas stayed on XLA's gather on the TPU). A TPU has only vreg-local
dynamic gathers; a GPU thread reads any word of device memory. N need not
be a multiple of 1024.
"""

from __future__ import annotations

import ctypes

import torch

from ptdn_tpu_torch.ops.cuda import _lib


def gather_u32_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel N (see gather_u32)."""
    return table.view(torch.int32)[idx.to(torch.int64)].view(torch.uint32)


def gather_u32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T,) uint32, idx (N,) int32 with values in [0, T): the (N,)
    uint32 table[idx]. CPU tensors take the plain version; CUDA tensors
    launch kernel N."""
    _lib.require(idx.device, "gather_u32")
    if idx.device.type == "cpu":
        return gather_u32_plain(table, idx)
    return _gather_u32_kernel(table, idx)


def _gather_u32_kernel(table, idx):
    n = idx.shape[0]
    _lib.check_tensor(table, torch.uint32, (table.shape[0],), "table")
    _lib.check_tensor(idx, torch.int32, (n,), "idx")
    # the output at idx's offset modulo 16 bytes, so that the kernel's
    # 16-byte loads and stores start at one boundary
    lead = (idx.data_ptr() // 4) % 4
    out = torch.empty(n + 3, dtype=torch.uint32, device=idx.device)[
        lead:lead + n]
    if n == 0:
        return out
    p = _lib.ptr
    _lib.launch("ptdn_gather_u32", p(table), p(idx), ctypes.c_int(n), p(out))
    gather_u32.launches += 1
    return out


gather_u32.launches = 0
