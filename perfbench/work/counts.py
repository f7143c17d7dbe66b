"""The work of kernels B1 (the whole path, csrc/scene/path_trace.cu) and
D (one à-trous level, csrc/atrous.cu), and their bounds (peaks.bound_s).

B1 (bounce_bench.py:b1_work): its inputs read once (the primary hit:
origin and direction, t, normal, albedo, material, hit flag) and its
outputs written once (6 contributions a depth, the texel indices of the
depths after the first), and the operations these inputs need: a lane's
shading at every depth it is live, the analytic geoms' tests of each
shadow ray and bounce ray it casts, the winner's refine per bounce ray,
and the lane-triangle tests of its chunk scans. The counts come from the
plain reference on a frame of the cell (reference/tracer.py:
path_trace_plain's `counts`, reference/intersect.py's tri_tests).

D (chip_smoke.py's bound): per pixel its color (3 floats), variance,
position and normal (3 floats each) read and its color and variance
written, 56 bytes, and 25 taps of ~40 operations; the bytes bound it.
"""

from __future__ import annotations

from perfbench.work.peaks import (ANALYTIC_OPS, MOLLER_OPS, REFINE_OPS,
                                  SHADE_OPS, bound_s)

# bytes a lane of B1 reads: o, d, t, normal, albedo (float32), material
# (int32), hit (bool)
B1_LANE_IN = 12 + 12 + 4 + 12 + 12 + 4 + 1
ATROUS_PIXEL_BYTES = (12 + 4 + 12 + 12) + (12 + 4)
ATROUS_PIXEL_OPS = 25 * 40


def b1_bound_s(pixels: int, depth: int, n_analytic: int, shade: int,
               nee: int, nxt: int, tri_tests: int) -> float:
    """Kernel B1's bound on a frame of `pixels` lanes at `depth`, its
    scene of `n_analytic` analytic geoms: `shade` live lane-depths,
    `nee` shadow rays, `nxt` bounce rays, `tri_tests` lane-triangle
    tests."""
    n_bytes = pixels * (B1_LANE_IN + 6 * depth * 4 + (depth - 1) * 4)
    ops = (shade * SHADE_OPS + (nee + nxt) * n_analytic * ANALYTIC_OPS
           + nxt * REFINE_OPS + tri_tests * MOLLER_OPS)
    return bound_s(n_bytes, ops)


def atrous_level_bound_s(pixels: int) -> float:
    """Kernel D's bound on one level of a `pixels`-pixel frame."""
    return bound_s(pixels * ATROUS_PIXEL_BYTES, pixels * ATROUS_PIXEL_OPS)
