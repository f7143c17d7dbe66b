"""Kernel B1's share of its roofline: its bound on a frame of the cell
(work/counts.py:b1_bound_s, the work counted on a compared frame by the
plain reference) over its device time per launch in the traced window.
Nothing to read where the window launched no B1 or the check counted no
B1 work."""

from perfbench.work.counts import b1_bound_s

KERNEL = "path_trace_kernel"


def read(run):
    if run.trace is None or not run.counts:
        return None
    n = run.trace.count(KERNEL)
    if not n:
        return None
    c = run.counts
    bound = b1_bound_s(run.pixels, run.depth, c["n_analytic"], c["shade"],
                       c["nee"], c["next"], c["tri_tests"])
    return 100.0 * bound / (run.trace.kernel_s(name=KERNEL) / n)
