"""Scene description parser for the reference's scenes/*.txt format.

Grammar (reference src/scene.cpp:9-232, examples scenes/cornell.txt):

  MATERIAL <id>
  RGB r g b / SPECEX e / SPECRGB r g b / REFL x / REFR x / REFRIOR x /
  EMITTANCE x                       (7 property lines)
  [TEXTURE file.jpg]                (optional extra lines until blank)

  CAMERA
  RES w h / FOVY deg / FILE name / EYE x y z / LOOKAT x y z / UP x y z
  (plus ITERATIONS / DEPTH, present in room.txt; the reference consumes
   them positionally and as a result silently drops room.txt's FILE — we
   parse all keys robustly instead)

  OBJECT <id>
  sphere|cube|mesh
  material <k>
  TRANS x y z / ROTAT x y z / SCALE x y z
  [file.obj]                        (mesh only)

Texture files resolve to <scene_dir>/Textures/<name> and models to
<scene_dir>/Models/<name> (the reference hardcodes ../scenes/{Textures,
Models}/ at scene.cpp:220 and scene.cpp:236; ours is location-independent).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

# GeomType enum, order matches reference sceneStructs.h:18-22
SPHERE, CUBE, MESH = 0, 1, 2
GEOM_TYPE_NAMES = {"sphere": SPHERE, "cube": CUBE, "mesh": MESH}


@dataclasses.dataclass
class MaterialSpec:
    color: np.ndarray
    specular_exponent: float = 0.0
    specular_color: np.ndarray = None
    has_reflective: float = 0.0
    has_refractive: float = 0.0
    index_of_refraction: float = 1.0
    emittance: float = 1.0      # Material() default (sceneStructs.h:69)
    texture_file: Optional[str] = None
    texid: int = -1


@dataclasses.dataclass
class GeomSpec:
    type: int
    material_id: int
    translation: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    obj_file: Optional[str] = None


@dataclasses.dataclass
class CameraSpec:
    resolution: tuple          # (w, h)
    fovy: float
    image_name: str
    eye: np.ndarray
    look_at: np.ndarray
    up: np.ndarray
    iterations: int = 0        # room.txt extras, unused by the engine
    depth: int = 0


@dataclasses.dataclass
class ParsedScene:
    materials: List[MaterialSpec]
    geoms: List[GeomSpec]
    camera: CameraSpec
    scene_dir: str


class SceneParseError(ValueError):
    """Real errors instead of the reference's bare throw (scene.cpp:18-21)."""


def _vec3(tok):
    return np.array([float(tok[1]), float(tok[2]), float(tok[3])], np.float32)


def parse_scene(path: str) -> ParsedScene:
    if not os.path.isfile(path):
        raise SceneParseError(f"scene file not found: {path}")
    with open(path, "r") as f:
        raw_lines = f.read().splitlines()

    # strip //-comment-only lines the way the tokenizer effectively does
    lines = [ln.strip() for ln in raw_lines]
    materials: List[MaterialSpec] = []
    geoms: List[GeomSpec] = []
    camera: Optional[CameraSpec] = None

    i = 0
    n = len(lines)

    def block(start):
        """Lines of a block: from start until (exclusive) the next empty line."""
        j = start
        out = []
        while j < n and lines[j]:
            out.append(lines[j])
            j += 1
        return out, j

    while i < n:
        line = lines[i]
        if not line or line.startswith("//"):
            i += 1
            continue
        tok = line.split()
        head = tok[0]
        if head == "MATERIAL":
            mat_id = int(tok[1])
            if mat_id != len(materials):
                raise SceneParseError(
                    f"MATERIAL id {mat_id} out of order (expected {len(materials)})")
            body, i = block(i + 1)
            m = MaterialSpec(color=np.zeros(3, np.float32),
                             specular_color=np.zeros(3, np.float32))
            for ln in body:
                t = ln.split()
                k = t[0]
                if k == "RGB":
                    m.color = _vec3(t)
                elif k == "SPECEX":
                    m.specular_exponent = float(t[1])
                elif k == "SPECRGB":
                    m.specular_color = _vec3(t)
                elif k == "REFL":
                    m.has_reflective = float(t[1])
                elif k == "REFR":
                    m.has_refractive = float(t[1])
                elif k == "REFRIOR":
                    m.index_of_refraction = float(t[1])
                elif k == "EMITTANCE":
                    m.emittance = float(t[1])
                elif k == "TEXTURE":
                    m.texture_file = t[1]
            materials.append(m)
        elif head == "OBJECT":
            obj_id = int(tok[1])
            if obj_id != len(geoms):
                raise SceneParseError(
                    f"OBJECT id {obj_id} out of order (expected {len(geoms)})")
            body, i = block(i + 1)
            if not body:
                raise SceneParseError(f"OBJECT {obj_id}: empty body")
            gtype = GEOM_TYPE_NAMES.get(body[0])
            if gtype is None:
                raise SceneParseError(f"OBJECT {obj_id}: unknown type {body[0]!r}")
            g = GeomSpec(type=gtype, material_id=0,
                         translation=np.zeros(3, np.float32),
                         rotation=np.zeros(3, np.float32),
                         scale=np.ones(3, np.float32))
            for ln in body[1:]:
                t = ln.split()
                k = t[0]
                if k == "material":
                    g.material_id = int(t[1])
                elif k == "TRANS":
                    g.translation = _vec3(t)
                elif k == "ROTAT":
                    g.rotation = _vec3(t)
                elif k == "SCALE":
                    g.scale = _vec3(t)
                elif gtype == MESH and k.lower().endswith(".obj"):
                    g.obj_file = t[0]
            if gtype == MESH and g.obj_file is None:
                raise SceneParseError(f"OBJECT {obj_id}: mesh without .obj file")
            if g.material_id >= len(materials):
                raise SceneParseError(
                    f"OBJECT {obj_id}: material {g.material_id} undefined")
            geoms.append(g)
        elif head == "CAMERA":
            body, i = block(i + 1)
            res = (0, 0)
            fovy = 45.0
            name = ""
            eye = np.zeros(3, np.float32)
            look = np.zeros(3, np.float32)
            up = np.array([0, 1, 0], np.float32)
            iters = 0
            depth = 0
            for ln in body:
                t = ln.split()
                k = t[0]
                if k == "RES":
                    res = (int(t[1]), int(t[2]))
                elif k == "FOVY":
                    fovy = float(t[1])
                elif k == "FILE":
                    name = t[1]
                elif k == "EYE":
                    eye = _vec3(t)
                elif k == "LOOKAT":
                    look = _vec3(t)
                elif k == "UP":
                    up = _vec3(t)
                elif k == "ITERATIONS":
                    iters = int(t[1])
                elif k == "DEPTH":
                    depth = int(t[1])
            if res[0] <= 0 or res[1] <= 0:
                raise SceneParseError("CAMERA: missing or invalid RES")
            camera = CameraSpec(resolution=res, fovy=fovy, image_name=name,
                                eye=eye, look_at=look, up=up,
                                iterations=iters, depth=depth)
        else:
            i += 1
            continue

    if camera is None:
        raise SceneParseError("scene has no CAMERA block")
    return ParsedScene(materials=materials, geoms=geoms, camera=camera,
                       scene_dir=os.path.dirname(os.path.abspath(path)))
