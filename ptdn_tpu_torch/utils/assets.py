"""Scene-asset resolution: the vendored ``<repo>/scenes`` directory, or
the one ``PTDN_SCENES_DIR`` names."""

from __future__ import annotations

import os
import pathlib

REPO_SCENES = pathlib.Path(__file__).resolve().parents[2] / "scenes"


def scenes_dir() -> pathlib.Path:
    """The active scene directory (env override > vendored copy)."""
    return pathlib.Path(os.environ.get("PTDN_SCENES_DIR", REPO_SCENES))


def scene_path(name: str) -> str:
    """Resolve a scene by short name ('cornell') or filename
    ('cornell.txt') against the active scene directory."""
    if not name.endswith(".txt"):
        name += ".txt"
    return str(scenes_dir() / name)


def write_cornell_plus(out_dir, cubes: int = 0, materials: int = 0,
                       refrior: str = "0") -> str:
    """Write a generated variant of cornell.txt into `out_dir` and return
    its path: cornell's 10 geoms plus `cubes` small cubes on its floor (a
    grid of 11 a row, diffuse and mirror materials in turn), and
    `materials` more diffuse materials, which no geom uses, each with
    REFRIOR `refrior`. The directory gets links to the scene directory's
    Textures and Models, which cornell's wall reads. Cornell plus 55 cubes
    is a scene of 65 geoms, past kernel B1's per-scene build
    (ops/cuda/scene_intersect.py:B1_MAX_GEOMS)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for sub in ("Textures", "Models"):
        if not (out / sub).exists():
            (out / sub).symlink_to(scenes_dir() / sub)
    text = (scenes_dir() / "cornell.txt").read_text()
    head, camera = text.split("// Camera", 1)
    n_mats = head.count("MATERIAL ")
    extra = "".join(
        f"MATERIAL {n_mats + k}\nRGB         .5 .5 .5\nSPECEX      0\n"
        f"SPECRGB     0 0 0\nREFL        0\nREFR        0\n"
        f"REFRIOR     {refrior}\nEMITTANCE   0\n\n" for k in range(materials))
    n_geoms = camera.count("OBJECT ")
    objs = "".join(
        f"\nOBJECT {n_geoms + k}\ncube\nmaterial {(1, 2, 3, 4, 6, 7)[k % 6]}\n"
        f"TRANS       {-4 + 0.8 * (k % 11):.2f} 0.25 {-3 + 1.5 * (k // 11):.2f}\n"
        f"ROTAT       0 {15 * k % 90} 0\nSCALE       .45 .45 .45\n"
        for k in range(cubes))
    name = f"cornell_plus_{cubes}c_{materials}m_{refrior}.txt"
    path = out / name
    path.write_text(head + extra + "// Camera" + camera + objs)
    return str(path)
