"""Texture loading (stb_image equivalent, sceneStructs.h:198-206)."""

from __future__ import annotations

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image file as (H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
