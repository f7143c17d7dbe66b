"""The card a measurement runs on, and CUDA-event timing, for the
measurement scripts (trace_bench, reproj_bench, probes/*)."""

from __future__ import annotations

import subprocess

import torch


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them; raises
    where there is no card."""
    if not torch.cuda.is_available():
        raise SystemExit("this measurement needs a CUDA device")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2,
            hide_host: bool = False) -> float:
    """Mean CUDA-event time of fn over reps calls, after warmup calls.
    hide_host queues the calls behind a ~0.1 s device spin, so that a call
    whose host side (Python, argument checks, launch) outlasts its kernel
    is timed by its device work alone; without it the time is the call's
    end to end, host included. A call that reads the device from the host
    waits out the spin, and is then timed end to end either way."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hide_host:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
