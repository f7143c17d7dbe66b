"""Build and load the hand-written CUDA kernels (ptdn_tpu_torch/csrc).

nvcc compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all at once, and links the objects into one shared library with a
plain C interface, which ctypes loads. The build runs at first use, into
``ptdn_tpu_torch/build/`` (ignored by git), and again only when a source
is newer than the library. The per-scene builds (``csrc/scene/*.cu``:
kernel B1, kernels F and H, and kernels A, J, I and M) are built once per
scene instead, with the scene's constants in a generated header
(build_scene), into libraries of their own per scene; the builds that
serve the scenes past their limits (B1's table build,
``csrc/path_trace_table.cu``; F and H, ``csrc/bounce.cu``; A, J, I and
M, ``csrc/scene_intersect.cu``) are in the kernel library. No fast-math
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


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
# the C entry points of the kernel library with their argument types,
# the stream's last
ENTRIES = {
    "ptdn_scene_intersect_full": [_VP, _VP, _VP, _VP],
    "ptdn_scene_intersect_full_tex": [_VP, _VP, _VP, _VP],
    "ptdn_light_visibility": [_VP, _VP, _I32, _VP, _VP],
    "ptdn_sparse_gather": [_VP, _VP],
    "ptdn_bounce_fused": [_VP, _VP, _VP],
    "ptdn_deferred_radiance": [_VP, _VP, _VP, _I32, _I32, _VP, _VP],
    "ptdn_scene_intersect": [_VP, _VP, _VP, _I32, _VP],
    "ptdn_back_projection_stencil": [_VP, _VP, _VP],
    "ptdn_back_projection_banded": [_VP, _VP, _VP],
    "ptdn_back_projection_atrous1": [_VP, _VP],
    "ptdn_atrous_level": [_VP, _I32, _VP],
    "ptdn_shade_bounce": [_VP, _VP],
    "ptdn_trace_bounce": [_VP, _VP, _VP],
    "ptdn_inrow_permute": [_VP, _VP, _I32, _I32, _VP, _VP],
    "ptdn_path_trace_table": [_VP, _VP, _VP],
    "ptdn_gather_u32": [_VP, _VP, _I32, _VP, _VP],
    "ptdn_ranges_and_key": [_VP, _VP],
    "ptdn_spatial_variance": [_VP, _VP],
    "ptdn_take_chain": [_VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _VP,
                        _VP],
    "ptdn_mesh_intersect_v1": [_VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32,
                               _I32, _VP, _VP, _VP],
    "ptdn_shade_bounce_lights": [_VP, _VP, _VP],
}
# the kernels that resolve mesh normals have a native-mode build
# (compat=False) in the kernel library too, `<name>_native` with the same
# arguments; the per-scene builds take the mode from their header
# instead (ops/cuda/scene_intersect.py:path_scene_header)
NATIVE = ("ptdn_scene_intersect_full", "ptdn_scene_intersect_full_tex",
          "ptdn_trace_bounce", "ptdn_bounce_fused", "ptdn_path_trace_table")
ENTRIES.update({k + "_native": ENTRIES[k] for k in NATIVE})
# the C entry points of each per-scene source, csrc/scene/<stem>.cu,
# with their argument types (each one of the library's but B1's)
SCENE_ENTRIES = {
    "path_trace": {"ptdn_path_trace": [_VP, _VP, _VP]},
    "bounce": {k: ENTRIES[k] for k in ("ptdn_trace_bounce",
                                       "ptdn_bounce_fused")},
    "scene_intersect": {k: ENTRIES[k] for k in (
        "ptdn_scene_intersect_full", "ptdn_scene_intersect_full_tex",
        "ptdn_light_visibility", "ptdn_scene_intersect")}}


def build_scene(header: str, force: bool = False):
    """Compile every per-scene source (csrc/scene/<stem>.cu: kernel B1,
    kernels F and H, kernels A, J, I and M) for one scene, with `header`
    (ops/cuda/scene_intersect.py:path_scene_header) as its scene.h, each
    into build/scene-<hash>/lib<stem>.so, the hash taken over the header
    and every kernel source; one nvcc per source, all at once; again only
    when forced or missing. Returns ({stem: the library's path}, nvcc's
    output)."""
    key = hashlib.sha256(header.encode())
    for src in sorted(CSRC.rglob("*.cu*")):
        key.update(src.read_bytes())
    out = BUILD / f"scene-{key.hexdigest()[:16]}"
    libs = {stem: out / f"lib{stem}.so" for stem in SCENE_ENTRIES}
    log = out / "nvcc.log"
    if not force and all(p.exists() for p in libs.values()):
        return libs, log.read_text()
    out.mkdir(parents=True, exist_ok=True)
    (out / "scene.h").write_text(header)
    tmp = {stem: out / f"lib{stem}.{os.getpid()}.so" for stem in libs}
    procs = {stem: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(out), "-o",
         str(tmp[stem]), str(CSRC / "scene" / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for stem in libs}
    logs = {stem: proc.communicate()[0] for stem, proc in procs.items()}
    for stem, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on scene/{stem}.cu "
                               f"({proc.returncode}):\n{logs[stem]}")
    log.write_text("".join(logs.values()))
    for stem in libs:
        os.replace(tmp[stem], libs[stem])
    return libs, log.read_text()


@functools.cache
def scene_kernels(header: str, stem: str = "path_trace") -> ctypes.CDLL:
    """The per-scene source csrc/scene/<stem>.cu built for the scene of
    `header`, on first use, loaded once."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    return declare(ctypes.CDLL(str(build_scene(header)[0][stem])),
                   SCENE_ENTRIES[stem])


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
    return declare(ctypes.CDLL(str(path)), ENTRIES)


def declare(lib: ctypes.CDLL, entries) -> ctypes.CDLL:
    """Declare the C entry points `entries` (name -> argument types) of
    lib, each returning an int; returns lib."""
    for name, args in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def build_variant(name: str, sources, entries) -> tuple:
    """Compile `sources` (paths of .cu files: another tree's copy of a
    kernel's source, or a changed one) with the kernel library's flags
    into build/variant-<name>.so. Returns (the library with `entries`
    (name -> argument types) declared, nvcc's output)."""
    BUILD.mkdir(exist_ok=True)
    so = BUILD / f"variant-{name}.so"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                          *map(str, sources)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}")
    return declare(ctypes.CDLL(str(so)), entries), res.stdout


def with_lib(lib, fn):
    """fn() with the wrappers launching from `lib` (None: the kernel
    library)."""
    global kernels
    if lib is None:
        return fn()
    real = kernels
    kernels = lambda: lib  # noqa: E731
    try:
        return fn()
    finally:
        kernels = real


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
