"""The benchmark's command: one run of one cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. Builds the cell's renderer on the card,
warms up, renders frames back to back for --seconds (each ended by a
synchronize) and prints, as the last line of its standard output, one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device (and with --trace
1 a breakdown of the device's time), and last the numbers the check
compared, each with its limit (also the last lines of standard error).
Exits 2 without a result where the card is missing or holds fewer
devices than the cell asks for, and 3 where the process holds JAX or the
JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time


def process_start() -> float:
    """The process's start on time.perf_counter's clock (the kernel's
    start time of the process, to its clock tick), where /proc has it."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(uptime - start / os.sysconf("SC_CLK_TCK"), 0.0)


T0 = process_start()

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every cache of the program and of torch at a fixed path in the checkout,
# so that only a checkout's first run builds and compiles
CACHE = ROOT / ".perfbench_cache"


def log(msg: str):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    (CACHE / "tmp").mkdir(parents=True, exist_ok=True)

    from perfbench import harness

    cell = harness.Cell.load(a.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} devices, the machine has "
            f"{torch.cuda.device_count()}")
        return 2
    try:
        out = harness.run(cell, a.seed, a.seconds, bool(a.trace), T0,
                          scratch_dir=str(CACHE / "tmp"), log=log)
    except SystemExit as e:
        log(str(e))
        return 3
    bad = harness.forbidden_modules()
    if bad:
        log(f"the run's process holds {bad}")
        return 3
    for k, v in out["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
