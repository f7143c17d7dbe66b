"""Kernel O (take_chain): a chain of `reps` dependent take_along_axis
gathers of an (S, L) int32 array (csrc/dyngather.cu), with its plain
PyTorch version, a chain of torch.gather.

Replaces the TPU kernel benchmarks/micro_dyngather.py:kern (:19, launched
by its probe, :29), which maps the take_along_axis shapes Mosaic lowers
inside a TPU kernel and times them; no renderer path calls it. Its script
is ptdn_tpu_torch/probes/dyngather.py. A TPU gathers only within a vector
register, which is what the probe maps. On the card a block stages the
lines its elements read (whole rows on axis 1, a stripe of whole columns
on axis 0) in shared memory and walks their chains there (tile_plan
picks the tiles by shape); a line longer than a block's shared memory
takes a global-load kernel, one thread an element.
"""

from __future__ import annotations

import ctypes

import torch

from ptdn_tpu_torch.ops.cuda import _lib

PER = 1024           # elements a block of the staged kernel walks
# columns a tile on axis 0: of 8, 16 and 32 the fastest on both timed
# chains on axis 0 (an H100, PERF.md)
STRIPE = 16
SMEM_MAX = 232_448   # shared memory a block can take (227 KB)


def take_chain_plain(x: torch.Tensor, idx: torch.Tensor, axis: int,
                     reps: int) -> torch.Tensor:
    """Plain PyTorch version of kernel O (see take_chain)."""
    acc = torch.gather(x, axis, idx.to(torch.int64))
    for _ in range(reps - 1):
        acc = torch.gather(x, axis, torch.remainder(idx + acc, x.shape[axis])
                           .to(torch.int64))
    return acc


def take_chain(x: torch.Tensor, idx: torch.Tensor, axis: int,
               reps: int = 1) -> torch.Tensor:
    """x, idx: (S, L) int32, idx in [0, x.shape[axis]). acc =
    take_along_axis(x, idx, axis), then reps - 1 times acc =
    take_along_axis(x, (idx + acc) mod x.shape[axis], axis), the modulo
    a floor modulo and the int32 sum wrapping. Returns acc (S, L) int32.
    CPU tensors take the plain version; CUDA tensors launch kernel O."""
    _lib.require(x.device, "take_chain")
    if x.device.type == "cpu":
        return take_chain_plain(x, idx, axis, reps)
    return _take_chain_kernel(x, idx, axis, reps)


def tile_plan(s: int, l: int, axis: int):
    """(lines, per) of the staged kernel for an (S, L) array gathered
    along `axis`: a block stages `lines` whole lines (rows on axis 1,
    consecutive columns on axis 0) and walks the chains of `per`
    consecutive elements of them: as many rows as hold one block's PER
    elements, or STRIPE columns, halved until they fit SMEM_MAX. (0, 0)
    where one line does not fit: the global-load kernel."""
    m, n_lines = (s, l) if axis == 0 else (l, s)
    if 4 * m > SMEM_MAX:
        return 0, 0
    lines = max(1, PER // m) if axis == 1 else STRIPE
    while 4 * m * lines > SMEM_MAX:
        lines //= 2
    return min(lines, n_lines), PER


def _take_chain_kernel(x, idx, axis, reps):
    s, l = x.shape
    _lib.check_tensor(x, torch.int32, (s, l), "x")
    _lib.check_tensor(idx, torch.int32, (s, l), "idx")
    if axis not in (0, 1) or reps < 1 or s * l >= 2 ** 31:
        raise ValueError(f"take_chain: axis {axis}, reps {reps}, shape "
                         f"{(s, l)} not taken")
    lines, per = tile_plan(s, l, axis)
    out = torch.empty_like(x)
    p, i32 = _lib.ptr, ctypes.c_int
    _lib.launch("ptdn_take_chain", p(x), p(idx), i32(s), i32(l), i32(axis),
                i32(reps), i32(lines), i32(per), p(out))
    take_chain.launches += 1
    return out


take_chain.launches = 0
