"""Seconds from the process's start to the window's first frame: torch's
import, the scene's parse and acceleration structures on the host, the
kernels' builds (a first run compiles them), the renderer and the
warm-up frames."""


def read(run):
    return run.setup_s
