"""The fresh-group permute's pieces timed on the card: the port of
benchmarks/micro_regroup.py, whose Pallas kernel pallas_inrow (:85, body
:77-81) computes what kernel G does (csrc/inrow.cu): it is G at K = 29
planes of 5,120 rows of 128 lanes (655,360 lanes).

    python3 -m ptdn_tpu_torch.probes.regroup [--reps N]

The script's inputs (numpy seed 0: K float32 planes, an int32 key per
lane in [0, 2^20), a permutation of the 4-lane groups, a permutation of
the lanes) and steps, each by its PyTorch counterpart:

* (a) the per-row argsort of the keys: torch.sort(stable=True), as
  lax.sort_key_val is stable;
* (b) the in-row permute of the K planes by take_along_axis: torch.gather;
* (b2) the variadic sort of the key with the K planes: a sort and a
  gather;
* (c) the in-row permute by kernel G;
* (d) the whole fresh-group permute at G = 4: (a), then G, then a gather
  of 4-lane groups;
* (e) the G = 1 row-gather permute of every lane.

(c) is checked equal to (b), bit for bit. One line a step with its ms
and the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda.inrow import inrow_permute
from ptdn_tpu_torch.utils.card import card_name, cuda_ms

N = 640 * 1024
NB = N // 128
K = 29


def inputs(device="cuda", nb: int = NB):
    """planes (K, nb, 128) float32, key2d (nb, 128) int32, pg (a
    permutation of the nb * 32 four-lane groups) and perm (of the nb * 128
    lanes), int64, from numpy seed 0 in the script's order."""
    rng = np.random.default_rng(0)
    n = nb * 128
    planes = rng.standard_normal((K, nb, 128), np.float32)
    key2d = rng.integers(0, 1 << 20, (nb, 128)).astype(np.int32)
    pg = rng.permutation(n // 4)
    perm = rng.permutation(n)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (planes, key2d, pg, perm))


def argsort_rows(key2d):
    """(a): each row's stable argsort, int32 (nb, 128)."""
    return torch.sort(key2d, dim=1, stable=True).indices.to(torch.int32)


def gather_rows(planes, order):
    """(b): the in-row permute by torch.gather."""
    return torch.gather(planes, 2, order.to(torch.int64)[None].expand(
        planes.shape[0], -1, -1))


def variadic_sort(key2d, planes):
    """(b2): the key and the K planes sorted together along the lanes."""
    keys, order = torch.sort(key2d, dim=1, stable=True)
    return keys, gather_rows(planes, order)


def fresh_group(planes, key2d, pg):
    """(d): the in-row argsort, G, then the 4-lane groups gathered."""
    k, nb, _ = planes.shape
    n = nb * 128
    pl2 = inrow_permute(planes, argsort_rows(key2d))
    return (pl2.reshape(k, n).T.reshape(n // 4, 4 * k)[pg]
            .reshape(n, k).T.reshape(k, nb, 128))


def row_gather(planes, perm):
    """(e): every lane gathered on its own (G = 1)."""
    k, nb, _ = planes.shape
    return planes.reshape(k, -1).T[perm].T.reshape(k, nb, 128)


def run(reps: int = 25, device="cuda"):
    """step label -> ms per call, after checking (c) against (b)."""
    planes, key2d, pg, perm = inputs(device)
    order = argsort_rows(key2d)
    if not torch.equal(inrow_permute(planes, order),
                       gather_rows(planes, order)):
        raise RuntimeError("regroup: G differs from torch.gather")
    steps = {
        "a: per-row argsort (torch.sort, stable)":
            lambda: argsort_rows(key2d),
        "b: in-row apply, torch.gather x K planes":
            lambda: gather_rows(planes, order),
        "b2: variadic sort (sort + gather of K planes)":
            lambda: variadic_sort(key2d, planes),
        "c: in-row apply, kernel G (inrow_permute)":
            lambda: inrow_permute(planes, order),
        "d: FULL fresh-group permute (argsort + G + G4 gather)":
            lambda: fresh_group(planes, key2d, pg),
        "e: G=1 full row-gather permute": lambda: row_gather(planes, perm),
    }
    return {label: cuda_ms(fn, reps, hide_host=True)
            for label, fn in steps.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    card = card_name()
    for label, ms in run(args.reps).items():
        print(f"{label:56s} {ms:8.4f} ms [{card}]")


if __name__ == "__main__":
    main()
