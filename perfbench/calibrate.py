"""The readings that the check's limits are set from (PERF.md), in one
process per cell: the program's readings over many seeds, and the
control's (check.control_store: the reference with its planes stored in
bfloat16, in the program's place) on the same frames of a few of them.

    python3 -m perfbench.calibrate --workload <cell> --seeds N
        [--controls K] [--seconds S] [--first SEED]

Each seed runs as a benchmark run does (the warm-up from the renderer's
reset, then a window of --seconds, every frame the check compares), on
one renderer built once. Prints one JSON line a seed and a last line
with the largest program reading and the smallest control reading of
each number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first", type=int, default=4_100_000_000)
    a = ap.parse_args(argv)

    import torch

    from perfbench import check, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell.load(a.workload)
    prog = harness.Program(cell, "cuda")
    res = prog.renderer.resolution
    played = []
    for i in range(a.seeds):
        seed = a.first + 7919 * i
        p = harness.play(prog, cell, seed, a.seconds, False,
                         time.perf_counter())
        played.append((seed, p.samples, len(p.frame_s)))
    del prog
    torch.cuda.empty_cache()
    ref = harness.reference(cell, res, "cuda")
    ctrl = harness.reference(cell, res, "cuda", check.control_store)
    program, control = [], []
    for i, (seed, samples, frames) in enumerate(played):
        result, _ = harness.compared(cell, samples, ref)
        line = {"seed": seed, "frames": frames,
                "program": result["frames"]}
        program.append(result["worst"])
        if i < a.controls:
            per = []
            for s in samples:
                want = ref.frame(s.pose, s.prev_pose, s.index, s.history)
                got = ctrl.frame(s.pose, s.prev_pose, s.index, s.history)
                per.append(check.readings(got, want))
                del want, got
            line["control"] = per
            control += per
        print(json.dumps(line), flush=True)
    print(json.dumps({
        "workload": a.workload, "seeds": a.seeds,
        "device": torch.cuda.get_device_name(0),
        "program_max": {k: max(r[k] for r in program)
                        for k in check.NUMBERS},
        "control_min": {k: min(r[k] for r in control)
                        for k in check.NUMBERS} if control else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
