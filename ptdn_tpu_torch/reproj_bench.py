"""The back-projection variants' times on the card: the port of
benchmarks/reproj_bench.py.

    python3 -m ptdn_tpu_torch.reproj_bench [WxH] [--reps N]

The JAX script's inputs at W x H (800 x 800 by default): numpy seed 0
for the G-buffers, colors, moments and history lengths, and the view
matrix diag(1, 1, -1, 1). Timed with CUDA events, each call's color
output consumed as the JAX script's is:

* the variants on these (random) positions: the packed 9-gather one
  (denoise/reproject.py:back_projection, the JAX package's
  back_projection_packed), packed2 (four 40-float block rows), window
  (one 90-float window row), kernel C's stencil mode (timed only: these
  positions are outside its gate) and auto (motion_bounds' host read,
  then C's stencil or band mode);
* on local motion (numpy seed 3: positions that reproject +-14 px
  vertically and +-60 px horizontally), window beside kernel C's band
  mode (back_projection_banded, its band starts included).

Then the script's two parity printouts: window against the band mode on
the local motion, and window against kernel C's stencil mode on
positions that reproject onto the pixel centres, max |diff| per output.
Every timed line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ptdn_tpu_torch.denoise import reproject as RP
from ptdn_tpu_torch.ops.cuda.reproject import back_projection_stencil
from ptdn_tpu_torch.utils.card import card_name, cuda_ms

ALPHA = 0.2


def inputs(w: int, h: int, device="cuda"):
    """The script's arguments after `res`: color, gb_c, gb_p, view,
    color history, moment history, history length, the two alphas; and
    the positions of the local motion and of the zero-motion parity."""
    rng = np.random.default_rng(0)

    def img(c=3):
        return rng.normal(size=(h, w, c)).astype(np.float32)
    gb_c = {"position": img() * 3, "normal": img(),
            "geom_id": rng.integers(0, 3, (h, w)).astype(np.int32)}
    gb_p = {"position": img() * 3, "normal": gb_c["normal"],
            "geom_id": gb_c["geom_id"]}
    vm = np.eye(4, dtype=np.float32)
    vm[2, 2] = -1.0
    color, ch = img(), img()
    mh = img(2)
    hl = rng.integers(0, 6, (h, w)).astype(np.int32)

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rng2 = np.random.default_rng(3)
    dy = rng2.uniform(-14, 14, size=(h, w)).astype(np.float32)
    dxl = rng2.uniform(-60, 60, size=(h, w)).astype(np.float32)

    def through_view(px, py):
        # positions whose reprojection through vm (vs_z = 1) is (px, py)
        vx = -((px + 0.5) / w - 0.5) * 2.0
        vy = -((py + 0.5) / h - 0.5) * 2.0
        return np.stack([vx, vy, -np.ones_like(px)], -1).astype(np.float32)
    local = through_view((xs + 0.5 + dxl).astype(np.float32),
                         (ys + 0.5 + dy).astype(np.float32))
    still = through_view((xs + 0.5).astype(np.float32),
                         (ys + 0.5).astype(np.float32))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    gb_c, gb_p = ({k: dev(v) for k, v in g.items()} for g in (gb_c, gb_p))
    args = (dev(color), gb_c, gb_p, dev(vm), dev(ch), dev(mh), dev(hl),
            ALPHA, ALPHA)
    return args, dev(local), dev(still)


def with_position(args, pos):
    """args with the current G-buffer's position replaced."""
    return (args[0], dict(args[1], position=pos)) + args[2:]


def max_diffs(a, b):
    return [float((x.double() - y.double()).abs().max()) for x, y in
            zip(a, b)]


def run(w: int = 800, h: int = 800, reps: int = 12, device="cuda"):
    """(label -> ms per call, [(label, max |diff| per output)])."""
    args, local, still = inputs(w, h, device)
    res = (w, h)

    def timed(fn, a):
        return cuda_ms(lambda: fn(res, *a)[1], reps, hide_host=True)
    ms = {
        "packed (9 gathers)": timed(RP.back_projection_packed, args),
        "packed2 (4 gathers)": timed(RP.back_projection_packed2, args),
        "window (1 gather, strided build)": timed(RP.back_projection_window,
                                                  args),
        "stencil (kernel C; static cam)": timed(back_projection_stencil,
                                                args),
        "auto (host-read dispatch)": timed(RP.back_projection_auto, args)}
    la = with_position(args, local)
    ms["window  (local +-14px motion)"] = timed(RP.back_projection_window,
                                                la)
    ms["banded  (local +-14px motion)"] = timed(RP.back_projection_banded,
                                                la)
    parity = [("banded parity", max_diffs(
        RP.back_projection_window(res, *la),
        RP.back_projection_banded(res, *la)))]
    sa = with_position(args, still)
    parity.append(("parity", max_diffs(RP.back_projection_window(res, *sa),
                                       back_projection_stencil(res, *sa))))
    return ms, parity


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("res", nargs="?", default="800x800")
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.res.split("x"))
    card = card_name()
    ms, parity = run(w, h, args.reps)
    for label, t in ms.items():
        print(f"{label:36s} {t:8.4f} ms ({w}x{h}) [{card}]")
    for label, diffs in parity:
        for i, dmax in enumerate(diffs):
            print(f"{label} out[{i}]: max|diff| = {dmax}")


if __name__ == "__main__":
    main()
