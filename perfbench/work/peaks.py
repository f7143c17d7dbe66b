"""The card's peaks (NVIDIA H100 SXM data sheet, at its 700 W power limit:
a card set lower runs slower) and the bound of a kernel's work on them
(ptdn_tpu_torch/utils/card.py)."""

from __future__ import annotations

# HBM bytes/s, float32 operations/s outside the tensor cores
HBM_RATE = 3.35e12
F32_RATE = 67e12
# float operations per unit of work, counted from the kernels' code: one
# Moller-Trumbore lane-triangle test, one analytic geom test of a lane,
# the winning triangle's refine, one lane's shading
MOLLER_OPS = 52
ANALYTIC_OPS = 90
REFINE_OPS = 70
SHADE_OPS = 250


def bound_s(n_bytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 rate, in seconds."""
    return max(n_bytes / HBM_RATE, ops / F32_RATE)
