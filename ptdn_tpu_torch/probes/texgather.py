"""Kernel N's times on the card: the port of the texel-table gather probe
benchmarks/pallas_texgather.py.

    python3 -m ptdn_tpu_torch.probes.texgather [--reps N]

640,000 indices (625 x 1024) into the texel tables of two scenes
(DeviceScene.tex_flat_u32): cornell's (one 500 x 250 texture, T =
125,000) and room's (two 1024^2 textures, T = 2,097,152, which the TPU
kernel's VMEM gate kept on XLA's gather), random (numpy seed 0) and the
same indices sorted (coherent, as primary rays are). Each case checks
kernel N against torch.take, bit for bit, and times both with CUDA
events; one line per case with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ptdn_tpu_torch.ops.cuda.texgather import gather_u32
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils.assets import scene_path
from ptdn_tpu_torch.utils.card import card_name, cuda_ms

N = 640_000
SCENES = ("cornell", "room")


def cases(device="cuda"):
    """'<scene> <order>' -> (table (T,) uint32, idx (N,) int32)."""
    out = {}
    for name in SCENES:
        table = Scene(scene_path(name)).device(device).tex_flat_u32
        idx = np.random.default_rng(0).integers(
            0, table.shape[0], N).astype(np.int32)
        for order, ix in (("random", idx), ("sorted", np.sort(idx))):
            out[f"{name} {order}"] = (table, torch.from_numpy(ix).to(device))
    return out


def run(reps: int = 20, device="cuda"):
    """'<scene> <order>' -> {T, ms, take_ms}: kernel N's and torch.take's
    ms per call, after checking that the two agree."""
    res = {}
    for label, (table, idx) in cases(device).items():
        t32, i64 = table.view(torch.int32), idx.to(torch.int64)
        if not torch.equal(gather_u32(table, idx).view(torch.int32),
                           torch.take(t32, i64)):
            raise RuntimeError(f"texgather {label}: N differs from "
                               f"torch.take")
        res[label] = {"T": int(table.shape[0]),
                      "ms": cuda_ms(lambda: gather_u32(table, idx), reps,
                                    hide_host=True),
                      "take_ms": cuda_ms(lambda: torch.take(t32, i64),
                                         reps, hide_host=True)}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    card = card_name()
    for label, r in run(args.reps).items():
        print(f"{label}: T={r['T']} N={N}: gather_u32 {r['ms']:.4f} ms, "
              f"torch.take {r['take_ms']:.4f} ms, equal [{card}]")


if __name__ == "__main__":
    main()
