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
    _link_assets(out)
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


def _link_assets(out: pathlib.Path):
    """Links in `out` to the scene directory's Textures and Models."""
    out.mkdir(parents=True, exist_ok=True)
    for sub in ("Textures", "Models"):
        if not (out / sub).exists():
            (out / sub).symlink_to(scenes_dir() / sub)


def write_mesh_light(out_dir) -> str:
    """Write cornell.txt with its OBJECT 0, the ceiling light, made an
    emissive mesh panel into `out_dir` and return its path: the back
    wall's model (Models/wall_x.obj, a flat grid of 38 triangles) with
    material 0, turned to face down and scaled to about the light's size,
    just below the ceiling. NEE toward a mesh light takes the split
    engine with the full closest hit as its shadow test
    (engine/wavefront.py)."""
    out = pathlib.Path(out_dir)
    _link_assets(out)
    text = (scenes_dir() / "cornell.txt").read_text()
    light = ("OBJECT 0\ncube\nmaterial 0\nTRANS       0 10 0\n"
             "ROTAT       0 0 0\nSCALE       3 .3 3\n")
    if light not in text:
        raise ValueError("cornell.txt's OBJECT 0 is not the expected "
                         "ceiling light")
    panel = ("OBJECT 0\nmesh\nmaterial 0\nTRANS       0 9.8 0\n"
             "ROTAT       180 0 0\nSCALE       3 1 3\nwall_x.obj\n")
    path = out / "cornell_mesh_light.txt"
    path.write_text(text.replace(light, panel, 1))
    return str(path)


# two emissive cubes over a floor and a back wall, the second light's
# color a parameter: the JAX package's native-mode light-selection scene
# (tests/test_engine.py's _TWO_LIGHT_HEAD), kept here as the port's own
TWO_LIGHT = """\
MATERIAL 0
RGB         1 1 1
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

MATERIAL 1
RGB         .9 .9 .9
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   0

MATERIAL 2
RGB         {rgb2}
SPECEX      0
SPECRGB     0 0 0
REFL        0
REFR        0
REFRIOR     0
EMITTANCE   5

CAMERA
RES         48 48
FOVY        45
FILE        twolight
EYE         0 5 10
LOOKAT      0 5 0
UP          0 1 0

OBJECT 0
cube
material 0
TRANS       -3 10 0
ROTAT       0 0 0
SCALE       2 .3 2

OBJECT 1
cube
material 1
TRANS       0 0 0
ROTAT       0 0 0
SCALE       12 .01 12

OBJECT 2
cube
material 2
TRANS       3 10 0
ROTAT       0 0 0
SCALE       2 .3 2

OBJECT 3
cube
material 1
TRANS       0 5 -4
ROTAT       0 0 0
SCALE       12 10 .01
"""


def write_two_light(out_dir, rgb2: str = "1 1 1") -> str:
    """Write the two-light scene (TWO_LIGHT, its second light's color
    `rgb2`, "r g b") into `out_dir` and return its path: two emissive
    cubes, so native mode (compat=False) draws one of them per NEE lane
    from kernel E's light table."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tag = "" if rgb2 == "1 1 1" else "_" + "_".join(rgb2.split())
    path = out / f"twolight{tag}.txt"
    path.write_text(TWO_LIGHT.format(rgb2=rgb2))
    return str(path)
