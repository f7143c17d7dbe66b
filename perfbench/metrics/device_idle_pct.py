"""100 x (1 - the seconds in which a kernel, copy or memset ran on the
device / the traced window's wall seconds)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
