"""Kernel D's share of its roofline: the bound of its levels on a frame
(work/counts.py:atrous_level_bound_s per level) over D's device time per
frame in the traced window. Nothing to read where the window launched no
D (no whole-image level)."""

from perfbench.work.counts import atrous_level_bound_s

KERNEL = "atrous_level_kernel"


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    n = run.trace.count(KERNEL)
    if not n:
        return None
    per_frame = run.trace.kernel_s(name=KERNEL) / run.trace.frames
    levels = n / run.trace.frames
    return 100.0 * levels * atrous_level_bound_s(run.pixels) / per_frame
