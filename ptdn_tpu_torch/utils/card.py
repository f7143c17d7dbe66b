"""The card a measurement runs on, CUDA-event timing (of one call, and
of several in turns), the card's peaks
that bound a kernel, and nvcc's register report, for the measurement
scripts (chip_smoke.py, trace_bench, reproj_bench, bounce_bench,
probes/*)."""

from __future__ import annotations

import re
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



def in_turns(fns, reps: int = 20):
    """name -> [ms there, ms back] of each call of `fns` (name -> fn),
    timed by cuda_ms with the host hidden, in turns: every fn in order,
    then in reverse."""
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(cuda_ms(fns[k], reps=reps, hide_host=True))
    return ms

# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, float32
# operations/s outside the tensor cores
HBM_RATE = 3.35e12
F32_RATE = 67e12
# float operations per unit of work, counted from the kernels' code:
# one Moller-Trumbore lane-triangle test, one analytic geom test of a
# lane, the cull test of B1's table build, the winning triangle's
# refine, one lane's shading
MOLLER_OPS = 52
ANALYTIC_OPS = 90
BOX_OPS = 22   # B1's table build: one slab test of a geom's world box
REFINE_OPS = 70
SHADE_OPS = 250


def bound(n_bytes: float, ops: float):
    """(ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the float32 rate."""
    tb, to = n_bytes / HBM_RATE, ops / F32_RATE
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled entry name: the
    length-prefixed identifier that ends in _kernel."""
    for m in re.finditer(r"(?=([0-9]+))", mangled):   # every digit suffix
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
            return name
    return mangled


def ptxas_summary(log: str):
    """'<kernel> N registers, M B smem, S B spilled' per entry function of
    nvcc's -Xptxas -v report."""
    out, name, spill = [], "?", "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name} {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} B smem, "
                       f"{spill} B spilled")
    return out
