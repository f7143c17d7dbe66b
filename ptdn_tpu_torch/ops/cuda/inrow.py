"""Kernel G (inrow_permute): a permutation of the 128 lanes within each
row of K float32 planes (csrc/inrow.cu), with its plain PyTorch version.

Replaces the TPU kernel ptdn_tpu/ops/pallas/inrow.py:inrow_permute_pallas:
out[k, r, j] = planes[k, r, order[r, j]]. The sorted wavefront applies it
to its carried planes after an in-row argsort of the coherence key, on
scenes of at most 8 triangle chunks (engine/wavefront.py:permute_planes).
"""

from __future__ import annotations

import ctypes

import torch

from ptdn_tpu_torch.ops.cuda import _lib


def inrow_permute_plain(planes: torch.Tensor,
                        order: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel G (see inrow_permute)."""
    rows = torch.arange(planes.shape[1], device=planes.device)[:, None]
    return planes[:, rows, order.to(torch.int64)]


def inrow_permute(planes: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """planes (K, NB, 128) float32, order (NB, 128) int32 (order[r, j] is
    the source lane of output lane j in row r). Returns the permuted
    planes in a new tensor. CPU tensors take the plain version; CUDA
    tensors launch kernel G."""
    _lib.require(planes.device, "inrow_permute")
    if planes.device.type == "cpu":
        return inrow_permute_plain(planes, order)
    return _inrow_permute_kernel(planes, order)


def _inrow_permute_kernel(planes, order):
    k, nb = planes.shape[0], planes.shape[1]
    _lib.check_tensor(planes, torch.float32, (k, nb, 128), "planes")
    _lib.check_tensor(order, torch.int32, (nb, 128), "order")
    out = torch.empty_like(planes)
    p = _lib.ptr
    _lib.launch("ptdn_inrow_permute", p(planes), p(order), ctypes.c_int(k),
                ctypes.c_int(nb), p(out))
    inrow_permute.launches += 1
    return out


inrow_permute.launches = 0
