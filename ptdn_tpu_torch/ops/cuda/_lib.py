"""Build and load the hand-written CUDA kernels (ptdn_tpu_torch/csrc).

nvcc compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all at once, and links the objects into one shared library with a
plain C interface, which ctypes loads. The build runs at first use, into
``ptdn_tpu_torch/build/`` (ignored by git), and again only when a source
is newer than the library. Kernel B1's per-scene build
(``csrc/scene/path_trace.cu``) is built once per scene instead, with the
scene's constants in a generated header (build_scene), into a library of
its own per scene; its table build (``csrc/path_trace_table.cu``) is in
the kernel library. No fast-math
flag is passed and ``--fmad=false`` keeps every product rounded on its
own, so the kernels round like their plain PyTorch versions, which run
one operation at a time.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
LIB = BUILD / "libptdn_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
                     "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or stale. Returns
    nvcc's output (register and spill report), '' if nothing was built."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    if not force and LIB.exists() and LIB.stat().st_mtime >= newest:
        return ""
    BUILD.mkdir(exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]   # waits for them all
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{log}")
    tmp = BUILD / f"libptdn_kernels.{tag}.so"
    res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB)
    return "".join(logs)


def build_scene(header: str, force: bool = False):
    """Compile kernel B1 (csrc/scene/path_trace.cu) for one scene, with
    `header` (ops/cuda/scene_intersect.py:path_scene_header) as its
    scene.h, into build/scene-<hash>/, the hash taken over the header and
    every kernel source; again only when forced or missing. Returns (the
    library's path, nvcc's output)."""
    key = hashlib.sha256(header.encode())
    for src in sorted(CSRC.rglob("*.cu*")):
        key.update(src.read_bytes())
    out = BUILD / f"scene-{key.hexdigest()[:16]}"
    lib, log = out / "libptdn_path.so", out / "nvcc.log"
    if not force and lib.exists():
        return lib, log.read_text()
    out.mkdir(parents=True, exist_ok=True)
    (out / "scene.h").write_text(header)
    tmp = out / f"libptdn_path.{os.getpid()}.so"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(out),
                          "-o", str(tmp), str(CSRC / "scene" /
                                              "path_trace.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on scene/path_trace.cu "
                           f"({res.returncode}):\n{res.stdout}")
    log.write_text(res.stdout)
    os.replace(tmp, lib)
    return lib, res.stdout


@functools.cache
def scene_kernels(header: str) -> ctypes.CDLL:
    """Kernel B1 built for the scene of `header`, on first use, loaded
    once."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(str(build_scene(header)[0]))
    vp = ctypes.c_void_p
    lib.ptdn_path_trace.argtypes = [vp, vp, vp]
    lib.ptdn_path_trace.restype = ctypes.c_int
    return lib


class SceneDev(ctypes.Structure):
    """Mirror of csrc/ptdn.cuh:SceneDev."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tf", "inv", "invt", "geom", "tri_moller",
        "chunk_min", "chunk_max", "tri_attr", "mat_attr", "tex_wh",
        "tex_flat", "row_code", "row_coef")] + [(name, ctypes.c_int) for name in (
            "n_geoms", "n_tris", "n_chunks", "tex_h", "tex_w")]


@functools.cache
def kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    build()
    return load(LIB)


def load(path) -> ctypes.CDLL:
    """Open a built kernel library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in {
        "ptdn_scene_intersect_full": [vp, vp, vp, vp],
        "ptdn_scene_intersect_full_tex": [vp, vp, vp, vp],
        "ptdn_light_visibility": [vp, vp, i32, vp, vp],
        "ptdn_sparse_gather": [vp, vp],
        "ptdn_bounce_fused": [vp, vp, vp],
        "ptdn_deferred_radiance": [vp, vp, vp, i32, i32, vp, vp],
        "ptdn_scene_intersect": [vp, vp, vp, i32, vp],
        "ptdn_back_projection_stencil": [vp, vp],
        "ptdn_back_projection_banded": [vp, vp],
        "ptdn_back_projection_atrous1": [vp, vp],
        "ptdn_atrous_level": [vp, i32, vp],
        "ptdn_shade_bounce": [vp, vp],
        "ptdn_trace_bounce": [vp, vp, vp],
        "ptdn_inrow_permute": [vp, vp, i32, i32, vp, vp],
        "ptdn_path_trace_table": [vp, vp, vp],
        "ptdn_gather_u32": [vp, vp, i32, vp, vp],
        "ptdn_take_chain": [vp, vp, i32, i32, i32, i32, vp, vp],
        "ptdn_mesh_intersect_v1": [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                   vp, vp, vp],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args, lib=None):
    """Call C entry point `name` of `lib` (the kernel library by default)
    with `args` (ctypes structs go by address) on the current stream;
    raise if the launch failed."""
    conv = [ctypes.addressof(a) if isinstance(a, ctypes.Structure) else a
            for a in args]
    err = getattr(lib or kernels(), name)(*conv, stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int:
    return t.data_ptr() if t is not None else None


def require(device: torch.device, name: str):
    """The wrappers take CPU tensors (plain version) or CUDA tensors
    (kernel); anything else is refused."""
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {device}")


def check_tensor(t: torch.Tensor, dtype, shape, name: str):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on cuda, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
