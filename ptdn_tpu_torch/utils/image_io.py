"""Image IO: texture loading (stb_image equivalent, sceneStructs.h:198-206),
PNG and Radiance HDR writers, and the reference's save naming.

The writers mirror the reference image writer (src/image.cpp:22-45) and
the app save path (src/main.cpp:131-152): PNG is clamp(x*255), the saved
file is horizontally flipped, and the filename is
"<FILE>.<timestamp>.<N>samp.png". Each takes a numpy array or a tensor on
any device, and writes the same bytes as the JAX package's writer on the
same float32 array.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def load_image_rgb(path: str) -> np.ndarray:
    """Load an image file as (H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def host(img) -> np.ndarray:
    """img on the host: a tensor copied off its device once."""
    if isinstance(img, torch.Tensor):
        return img.cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    """clamp(int(x*255), 0, 255) per channel (image.cpp:26-31)."""
    return np.clip((np.asarray(host(img), dtype=np.float64) * 255.0)
                   .astype(np.int64), 0, 255).astype(np.uint8)


def save_png(path: str, img) -> str:
    """Save an (H, W, 3) float image in [0,1] as RGB8 PNG."""
    from PIL import Image

    if not path.endswith(".png"):
        path = path + ".png"
    Image.fromarray(to_uint8(img), mode="RGB").save(path)
    return path


def save_hdr(path: str, img) -> str:
    """Save an (H, W, 3) float image as a Radiance RGBE .hdr file
    (stbi_write_hdr equivalent, image.cpp:41-45)."""
    if not path.endswith(".hdr"):
        path = path + ".hdr"
    img = np.asarray(host(img), dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), dtype=np.int32)
    mant = np.zeros((h, w), dtype=np.float32)
    nz = maxc >= 1e-32
    mant[nz], exp[nz] = np.frexp(maxc[nz])
    scale = np.where(nz, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def current_time_string() -> str:
    """Timestamp used in saved filenames (preview.cpp:19-27 semantics)."""
    return time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())


def save_image_like_reference(img, image_name: str, frame: int,
                              out_dir: str = ".", flip: bool = True) -> str:
    """saveImage() semantics (main.cpp:131-152): horizontal flip +
    '<FILE>.<timestamp>.<frame>samp.png' naming."""
    img = host(img)
    out = img[:, ::-1, :] if flip else img
    fname = f"{image_name}.{current_time_string()}.{float(frame)}samp"
    return save_png(os.path.join(out_dir, fname), out)
