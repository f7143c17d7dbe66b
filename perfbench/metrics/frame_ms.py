"""The window's wall time over the frames it completed, in ms: every
frame ended by a synchronize, as a viewer that shows every frame pays."""


def read(run):
    if not run.frame_s:
        return None
    return run.window_s * 1e3 / len(run.frame_s)
