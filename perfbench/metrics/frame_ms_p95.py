"""The 95th percentile of every frame's synced wall time in the window,
in ms (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if not run.frame_s:
        return None
    return float(np.percentile(np.asarray(run.frame_s) * 1e3, 95))
