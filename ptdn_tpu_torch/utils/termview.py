"""Terminal image display — ANSI truecolor half-blocks, a copy of the JAX
package's ptdn_tpu/utils/termview.py (plain numpy).

The reference blits every frame into a GLFW window
(reference src/preview.cpp:377-413); over a remote terminal no GL surface
exists, so the viewer's live sink renders the frame IN the terminal:
each character cell shows two vertical pixels via the upper-half-block
glyph (U+2580) with the top pixel as foreground and the bottom as
background, using 24-bit SGR color.
"""

from __future__ import annotations

import numpy as np

ESC = "\x1b["


def _downsample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Box-average to (out_h, out_w, 3). Plain numpy, no deps."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h + 1) * h // out_h).clip(0, h)
    xs = (np.arange(out_w + 1) * w // out_w).clip(0, w)
    # integral image makes each box mean O(1)
    ii = np.zeros((h + 1, w + 1, 3), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    y0, y1 = ys[:-1], ys[1:]
    x0, x1 = xs[:-1], xs[1:]
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float64)
    area = np.maximum(area, 1.0)[..., None]
    s = (ii[y1][:, x1] - ii[y1][:, x0] - ii[y0][:, x1] + ii[y0][:, x0])
    return (s / area).astype(np.float32)


def ansi_halfblocks(img, max_width: int = 120, home: bool = False) -> str:
    """Render (H, W, 3) float [0, 1] (or uint8) to an ANSI string.

    Two image rows per text line via '▀' (fg = top, bg = bottom).
    `home` prefixes a cursor-home so successive frames overdraw in
    place (the watch loop's live mode)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = a.shape[:2]
    out_w = min(max_width, w)
    # each cell is ~2x taller than wide; halve vertical resolution twice
    out_h = max(2, int(round(h * out_w / w)) // 2 * 2)
    small = _downsample(a.astype(np.float32), out_w, out_h).astype(np.uint8)
    lines = []
    for y in range(0, out_h, 2):
        top = small[y]
        bot = small[y + 1]
        cells = []
        prev = None
        for x in range(out_w):
            tr, tg, tb = int(top[x, 0]), int(top[x, 1]), int(top[x, 2])
            br, bg_, bb = int(bot[x, 0]), int(bot[x, 1]), int(bot[x, 2])
            cur = (tr, tg, tb, br, bg_, bb)
            if cur != prev:   # only emit SGR on change (1/3 the bytes)
                cells.append(f"{ESC}38;2;{tr};{tg};{tb}m"
                             f"{ESC}48;2;{br};{bg_};{bb}m")
                prev = cur
            cells.append("▀")
        cells.append(f"{ESC}0m")
        lines.append("".join(cells))
    body = "\n".join(lines) + "\n"
    return (f"{ESC}H" + body) if home else body
