"""Float32 arithmetic of the plain PyTorch versions, rounded as the
implementation each is compared with rounds.

On the card the plain versions are held against the CUDA kernels, which
use IEEE division and square root and ``rsqrtf`` (csrc/ptdn.cuh). On the
CPU they are held against the JAX package, whose reference renders (the
committed goldens and the live runs of the tests) come from XLA, and XLA
on the CPU:

* contracts a multiply feeding an add into one fused multiply-add,
  scanning left to right: ``a*b + c -> fma(a, b, c)``,
  ``a*b + c*d -> fma(a, b, c*d)``, ``a*b + c*d + e*f -> fma(e, f,
  fma(a, b, c*d))``, ``c - a*b -> fma(-a, b, c)``;
* evaluates rsqrt, and rewrites ``1/sqrt(x)`` and ``y/sqrt(x)`` into it,
  as LLVM's x86 expansion: a hardware estimate refined by one Newton step
  ``(-0.5 e) * fma(x e, e, -3)``. The estimate's table is not public, so
  the exact reciprocal square root stands in for it; the refined results
  agree with XLA's on about three lanes in four.

The kernels call ``fmaf`` at the same places (csrc), so both devices fuse
alike. Torch's own float32 ``sqrt`` on the CPU is not always correctly
rounded; ``sqrt`` here is, on both devices. The SVGF filter amplifies a
last-bit difference in a luminance or a near-zero variance into a visible
one (its edge weight is exp(-|dl| / (sqrt(var) sigma + 1e-6))), and a
static camera reprojects every pixel onto an integer boundary, so these
last bits decide which reference pixels the port reproduces.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x):
    # a Python scalar is a float32 constant in the reference
    return (x.to(torch.float64) if torch.is_tensor(x)
            else float(np.float32(x)))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c with one rounding, float32 in and out. The float32
    product is exact in float64, and so is the float64 sum unless it is
    rounded; rounding it again to float32 is then exact too, except where
    the float64 sum lands on a float32 tie that the exact sum does not sit
    on. There the sum steps one float64 ulp toward its rounding error
    (TwoSum), which makes the float32 rounding that of the exact sum.
    A Python scalar operand stays a host scalar, so the result lies on
    the card if any operand does."""
    p = torch.as_tensor(_f64(a), dtype=torch.float64) * _f64(b)
    c = torch.as_tensor(_f64(c), dtype=torch.float64)
    s = p + c
    bits = s.view(torch.int64)
    tie = (bits & 0x1FFFFFFF) == 0x10000000    # 29 dropped bits: 100...0
    if s.device.type == "cpu":
        # rare on real data: mend only those lanes
        if not bool(tie.any()):
            return s.to(torch.float32)
        p, c = torch.broadcast_tensors(p, c)
        bits = bits.clone()
        bits[tie] += _tie_step(p[tie], c[tie], s[tie])
        return bits.view(torch.float64).to(torch.float32)
    return (bits + torch.where(tie, _tie_step(p, c, s), 0)).view(
        torch.float64).to(torch.float32)


def _tie_step(p, c, s):
    """The float64 ulp step of s = p + c toward its rounding error: 0
    where the sum is exact, else +1 or -1 on the magnitude's bits."""
    t = s - p
    err = (p - (s - t)) + (c - t)               # s + err == p + c exactly
    return torch.where(err != 0, torch.where((err > 0) == (s > 0), 1, -1),
                       0)


def dot3(a, b) -> torch.Tensor:
    """a0*b0 + a1*b1 + a2*b2 as contracted: fma(a2, b2, fma(a0, b0, a1*b1))."""
    return fma(a[2], b[2], fma(a[0], b[0], a[1] * b[1]))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (exact in float64, and
    rounding it again to float32 is innocuous for a square root)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _rsqrt_xla(x: torch.Tensor) -> torch.Tensor:
    e = (1.0 / torch.sqrt(x.to(torch.float64))).to(torch.float32)
    return (e * -0.5) * fma(x * e, e, -3.0)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """rsqrt where the reference calls it: rsqrtf on the card."""
    return torch.rsqrt(x) if x.is_cuda else _rsqrt_xla(x)


def recip_sqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) as the reference writes it: IEEE on the card."""
    return 1.0 / sqrt(x) if x.is_cuda else _rsqrt_xla(x)


def div_sqrt(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y / sqrt(x) as the reference writes it: IEEE on the card."""
    return y / sqrt(x) if x.is_cuda else y * _rsqrt_xla(x)
