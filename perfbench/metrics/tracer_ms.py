"""Device ms per frame of the kernels launched inside the path tracer's
span (engine/wavefront.py:PathTracer)."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    s = run.trace.kernel_s(span="tracer")
    return s * 1e3 / run.trace.frames if s > 0 else None
