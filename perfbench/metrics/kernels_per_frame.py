"""Kernels launched on the device per frame of the traced window."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    return run.trace.count() / run.trace.frames
