"""Counter-based RNG: TEA seed hash + LCG stream, bit-exact vs reference.

The reference seeds per (pixel, frame+depth) with a 16-round TEA-style
hash and draws from a Numerical-Recipes LCG (reference
src/interactions.h:10-30). Torch has no full uint32 arithmetic, so the
plain versions carry uint32 values in int64 tensors and mask every sum
and shift with ``& 0xFFFFFFFF``; the CUDA kernels use native uint32_t
(csrc/ptdn.cuh). No generator state exists: a lane's stream is a
function of (pixel, frame+depth) alone.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def init_rand(val0: torch.Tensor, val1: torch.Tensor,
              backoff: int = 16) -> torch.Tensor:
    """TEA-style hash (interactions.h:10-22). val0/val1: integer tensors
    holding uint32 values; returns the seed as int64 in [0, 2^32)."""
    v0 = val0.to(torch.int64) & MASK
    v1 = val1.to(torch.int64) & MASK
    s0 = 0
    for _ in range(backoff):
        s0 = (s0 + 0x9E3779B9) & MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0))
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0))
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK
    return v0


def next_rand(seed: torch.Tensor):
    """One LCG step (interactions.h:25-30): returns (new_seed, u01)."""
    seed = (1664525 * seed + 1013904223) & MASK
    val = (seed & 0x00FFFFFF).to(torch.float32) * (1.0 / float(0x01000000))
    return seed, val


def next_rand_masked(seed: torch.Tensor, mask: torch.Tensor):
    """LCG step only where `mask`; elsewhere the seed (and stream position)
    is unchanged. Returns (new_seed, u01) — u01 is garbage off-mask."""
    new_seed, val = next_rand(seed)
    return torch.where(mask, new_seed, seed), val
