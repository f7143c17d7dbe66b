"""The end-to-end metrics' arithmetic, the trace's union of device
intervals, and the bounds of kernels B1 and D against hand counts."""

import math

import numpy as np
import pytest

from perfbench import harness
from perfbench.trace import summarize
from perfbench.work import counts, intervals, kernels, peaks


def run_of(frame_s, window_s, trace=None, counts=None, pixels=640_000):
    return harness.Run(frame_s=frame_s, window_s=window_s, setup_s=12.5,
                       pixels=pixels, depth=8, trace=trace, counts=counts)


def test_frame_ms_is_the_window_over_its_frames():
    # the window holds host time between frames too: it counts
    run = run_of([0.001] * 900 + [0.004] * 100, 2.0)
    assert harness.reader("frame_ms")(run) == pytest.approx(2.0)
    assert harness.reader("setup_s")(run) == 12.5
    assert harness.reader("frame_ms")(run_of([], 1.0)) is None


def test_p95_is_over_every_frame():
    frames = [0.001] * 940 + [0.009] * 60
    p95 = harness.reader("frame_ms_p95")(run_of(frames, 2.0))
    assert p95 == pytest.approx(9.0)
    frames = [0.001] * 960 + [0.009] * 40
    assert harness.reader("frame_ms_p95")(run_of(frames, 2.0)) == \
        pytest.approx(1.0)
    frames = list(np.arange(1, 101) * 1e-3)
    assert harness.reader("frame_ms_p95")(run_of(frames, 1.0)) == \
        pytest.approx(95.05)


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    """Two frames in a 1000 us window: three kernels (two overlap), a
    copy; the first kernel launched inside the tracer's span, the second
    in the step outside it, the third outside the step."""
    return [
        ev("perfbench.window", "user_annotation", 0, 1000),
        ev("perfbench.frame", "user_annotation", 10, 430),
        ev("perfbench.step", "user_annotation", 20, 400),
        ev("perfbench.tracer", "user_annotation", 30, 200),
        ev("perfbench.sync", "user_annotation", 440, 550),
        ev("cudaLaunchKernel", "cuda_runtime", 40, 5, correlation=1),
        ev("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=2),
        ev("cudaLaunchKernel", "cuda_runtime", 995, 2, correlation=3),
        ev("(anonymous namespace)::path_trace_kernel(ptdn::PathArgs)",
           "kernel", 100, 100, correlation=1),
        ev("void at::native::vectorized_elementwise_kernel<4>(int)",
           "kernel", 150, 150, correlation=2),
        ev("_ZN12_GLOBAL__N_119atrous_level_kernelEN4ptdn10AtrousArgsE",
           "kernel", 500, 100, correlation=3),
        ev("Memcpy DtoD", "gpu_memcpy", 650, 50),
        # past the window: left out
        ev("Memcpy DtoH", "gpu_memcpy", 1200, 50),
    ]


def test_idle_is_the_window_less_the_union_of_device_intervals():
    tr = summarize(synthetic(), frames=2)
    assert tr.window_s == pytest.approx(1000e-6)
    # [100, 300) + [500, 600) + [650, 700)
    assert tr.busy_s == pytest.approx(350e-6)
    run = run_of([1e-4, 1e-4], 1e-3, trace=tr)
    assert harness.reader("device_idle_pct")(run) == pytest.approx(65.0)
    assert harness.reader("kernels_per_frame")(run) == pytest.approx(1.5)
    # 100 us of the tracer's, 150 of the step's, over two frames
    assert harness.reader("tracer_ms")(run) == pytest.approx(0.05)
    assert harness.reader("denoiser_ms")(run) == pytest.approx(0.075)
    assert [k[0] for k in tr.kernels] == ["path_trace_kernel",
                                          "vectorized_elementwise_kernel",
                                          "atrous_level_kernel"]
    assert [k[2] for k in tr.kernels] == ["tracer", "step", "outside"]
    # each gap labelled by the span open on the host as it began
    assert tr.idle == [("harness", pytest.approx(100e-6)),
                       ("step", pytest.approx(200e-6)),
                       ("sync", pytest.approx(50e-6)),
                       ("sync", pytest.approx(300e-6))]
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "vectorized_elementwise_kernel"
    assert len(b["idle_gaps"]) <= 10


def test_union_and_gaps():
    merged = intervals.union([(5, 7), (1, 3), (2, 4), (9, 20)], 0, 10)
    assert merged == [(1, 4), (5, 7), (9, 10)]
    assert intervals.gaps(merged, 0, 10) == [(0, 1), (4, 5), (7, 9)]


def test_kernel_names():
    assert kernels.short_name(
        "_ZN12_GLOBAL__N_119atrous_level_kernelEN4ptdn10AtrousArgsE") == \
        "atrous_level_kernel"
    assert kernels.short_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
        "int>(int*)") == "CatArrayBatchedCopy"
    assert kernels.short_name("DeviceRadixSortOnesweepKernel") == \
        "DeviceRadixSortOnesweepKernel"


@pytest.mark.parametrize("w,h", [(800, 800), (1920, 1080)])
def test_atrous_bound_by_hand(w, h):
    """A level reads color (12 B), variance (4), position (12), normal
    (12) and writes color and variance (16): 56 B a pixel, over 3.35 TB/s;
    25 taps of 40 operations over 67 TFLOP/s bound it less."""
    n = w * h
    assert counts.atrous_level_bound_s(n) == pytest.approx(n * 56 / 3.35e12)
    assert n * 1000 / 67e12 < n * 56 / 3.35e12
    run = run_of([0.01] * 4, 0.04, pixels=n, trace=type("T", (), dict(
        frames=4, count=lambda self, name=None: 20,
        kernel_s=lambda self, span=None, name=None: 4 * 5 * n * 56 /
        3.35e12 * 4))())
    # D at a quarter of its bound
    assert harness.reader("atrous_roofline_pct")(run) == pytest.approx(25.0)


@pytest.mark.parametrize("w,h", [(800, 800), (1920, 1080)])
def test_path_trace_bound_by_hand(w, h):
    """B1 on a frame with every lane live at every depth, a shadow ray at
    every depth and a bounce ray at the first seven, 9 analytic geoms and
    no triangle test: the operations bound it."""
    n = w * h
    ops = (n * 8 * 250 + (n * 8 + n * 7) * 9 * 90 + n * 7 * 70)
    n_bytes = n * (57 + 6 * 8 * 4 + 7 * 4)
    want = max(ops / 67e12, n_bytes / 3.35e12)
    assert want == ops / 67e12
    got = counts.b1_bound_s(n, 8, 9, n * 8, n * 8, n * 7, 0)
    assert got == pytest.approx(want)
    tri = counts.b1_bound_s(n, 8, 9, n * 8, n * 8, n * 7, 10**6)
    assert tri - got == pytest.approx(52e6 / 67e12)
    c = dict(n_analytic=9, shade=n * 8, nee=n * 8, next=n * 7, tri_tests=0)
    run = run_of([0.01] * 2, 0.02, pixels=n, counts=c, trace=type(
        "T", (), dict(frames=2, count=lambda self, name=None: 2,
                      kernel_s=lambda self, span=None, name=None:
                      2 * want * 10))())
    assert harness.reader("path_trace_roofline_pct")(run) == \
        pytest.approx(10.0)
    assert peaks.bound_s(0, 0) == 0 and not math.isnan(got)
