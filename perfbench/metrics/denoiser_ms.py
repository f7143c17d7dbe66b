"""Device ms per frame of the kernels launched inside the frame step's
span but outside the tracer's: the SVGF denoiser (denoise/svgf.py) and
the step's glue."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    s = run.trace.kernel_s(span="step")
    return s * 1e3 / run.trace.frames if s > 0 else None
