"""Kernel O's shape map and times on the card: the port of the dynamic
gather probe benchmarks/micro_dyngather.py.

    python3 -m ptdn_tpu_torch.probes.dyngather [--reps N]

Its 16 cases, take_along_axis of an (S, L) int32 array along each axis
for eight shapes, each checked against the numpy chain (numpy seed 0:
x in [0, 1000), indices in [0, x.shape[axis])), one line each, OK or
WRONG (the TPU probe mapped which shapes Mosaic lowers; a CUDA thread
gathers at any shape). Then its four timed cases, chains of reps = 16
dependent gathers, in ns per element, kernel O beside the same chain of
torch.gather, with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda.dyngather import take_chain, take_chain_plain
from ptdn_tpu_torch.utils.card import card_name, cuda_ms

SHAPES = [(8, 128), (32, 128), (256, 128), (1024, 128), (8, 256), (8, 1024),
          (8, 16384), (256, 512)]
CASES = [(s, l, axis, 1) for axis in (0, 1) for s, l in SHAPES]
TIMED = [(1024, 128, 0, 16), (1024, 128, 1, 16), (8, 16384, 1, 16),
         (256, 512, 0, 16)]
# arrays whose lines are too long for a block's shared memory: kernel O's
# global-load path (ops/cuda/dyngather.py:tile_plan), checked beside them
LONG = [(2, 70000, 1, 16), (70000, 2, 0, 16)]


def inputs(s: int, l: int, axis: int):
    """The probe's x and indices, numpy int32 (S, L)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1000, size=(s, l)).astype(np.int32)
    idx = rng.integers(0, (s, l)[axis], size=(s, l)).astype(np.int32)
    return x, idx


def numpy_chain(x, idx, axis: int, reps: int):
    """The probe's chain in numpy (% is a floor modulo there too)."""
    acc = np.take_along_axis(x, idx, axis=axis)
    for _ in range(reps - 1):
        acc = np.take_along_axis(x, (idx + acc) % x.shape[axis], axis=axis)
    return acc


def check(s, l, axis, reps, device="cuda"):
    """Kernel O on one case against the numpy chain: (ok, x, idx) with x
    and idx on `device`."""
    x, idx = inputs(s, l, axis)
    xt, it = torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)
    got = take_chain(xt, it, axis, reps).cpu().numpy()
    return np.array_equal(got, numpy_chain(x, idx, axis, reps)), xt, it


def run(reps: int = 20, device="cuda"):
    """(the 16 cases' results, the timed cases' ns per element of kernel
    O and of the torch.gather chain)."""
    ok = {c: check(*c, device=device)[0] for c in CASES}
    timed = {}
    for s, l, axis, chain in TIMED:
        good, x, idx = check(s, l, axis, chain, device)
        per = 1e6 / (s * l * chain)
        timed[s, l, axis, chain] = {
            "ok": good,
            "ns": cuda_ms(lambda: take_chain(x, idx, axis, chain),
                          reps, hide_host=True) * per,
            "gather_ns": cuda_ms(
                lambda: take_chain_plain(x, idx, axis, chain), reps,
                hide_host=True) * per}
    return ok, timed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    card = card_name()
    ok, timed = run(args.reps)
    for (s, l, axis, _), good in ok.items():
        print(f"axis={axis} [{s:5d},{l:5d}] {'OK' if good else 'WRONG'}")
    print("--- timing (reps to amortize) ---")
    for (s, l, axis, chain), r in timed.items():
        print(f"axis={axis} [{s:5d},{l:5d}] reps={chain:3d} "
              f"{'OK' if r['ok'] else 'WRONG'} take_chain {r['ns']:7.3f} "
              f"ns/elem, torch.gather chain {r['gather_ns']:7.3f} ns/elem "
              f"[{card}]")


if __name__ == "__main__":
    main()
