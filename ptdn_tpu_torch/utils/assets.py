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
