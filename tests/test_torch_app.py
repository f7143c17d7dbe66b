"""The port's entry points and their utilities against the JAX package's:
the CLI (flag mapping, a CPU run against the raw golden, no fallback),
the image writers (byte for byte), checkpoints across the two packages,
stats and the profiler trace, the evaluator, the bench's helpers, and an
import scan of the whole port. Cornell at 64x64, depth 3, torch on one
thread; one JAX renderer for the file."""

import ast
import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

import bench as jbench
from ptdn_tpu.app import cli as jcli
from ptdn_tpu.app import eval as jeval
from ptdn_tpu.engine import Renderer as JRenderer
from ptdn_tpu.scene import Scene as JScene
from ptdn_tpu.utils import checkpoint as jckpt
from ptdn_tpu.utils import image_io as jio
from ptdn_tpu.utils import termview as jterm
from ptdn_tpu.utils.config import RenderConfig as JConfig
from ptdn_tpu_torch import bench
from ptdn_tpu_torch.app import cli, eval as peval
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils import checkpoint, image_io, stats, termview
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).parent / "golden"
PORT = pathlib.Path(__file__).resolve().parents[1] / "ptdn_tpu_torch"
RES = (64, 64)
RAW = dict(denoise_enable=False, trace_depth=3)
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            trace_depth=3, atrous_nlevel=3)
SCENES = ("cornell", "diamond", "bunny", "room", "terrain30k")


def within_raw_budget(img, ref):
    """tests/test_golden.py's raw budget: fewer than 1% of pixels off by
    more than 1e-3, RMSE below 0.012."""
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01
    assert np.sqrt(((img - ref) ** 2).mean()) < 0.012


@pytest.fixture(scope="module")
def cornell(scenes_dir):
    return Scene(str(scenes_dir / "cornell.txt"))


@pytest.fixture(scope="module")
def jax_run(scenes_dir, tmp_path_factory):
    """The file's one JAX renderer (xla backend, RAW): 3 frames, its
    checkpoint by the JAX save_state, then 2 more frames."""
    r = JRenderer(JScene(str(scenes_dir / "cornell.txt")),
                  JConfig(backend="xla", **RAW), resolution=RES)
    r.render(3)
    path = jckpt.save_state(str(tmp_path_factory.mktemp("jax") / "st"),
                            r.state, r.frame, r.camera)
    state = {k: np.asarray(v) for k, v in r.state.items()}
    cont = [np.asarray(r.render_frame()[0]) for _ in range(2)]
    return {"renderer": r, "path": path, "state": state, "cont": cont}


# ---- the CLI ----

@pytest.mark.parametrize("argv", [
    [],
    ["--depth", "7", "--no-shadowray", "--no-reducevar", "--sintensity",
     "3.5", "--lightradius", "2.0", "--no-bvh", "--mesh-mode", "brute",
     "--native"],
    ["--denoise", "--temporal", "--spatial", "--color-alpha", "0.3",
     "--moment-alpha", "0.4", "--no-blur-variance", "--sigma-l", "0.5",
     "--sigma-x", "0.6", "--sigma-n", "0.7", "--atrous-levels", "4",
     "--history-level", "2", "--sepcolor", "--addcolor", "--view",
     "variance"],
    ["--automate", "--cam-speed", "0.1", "0.2", "0.3", "0.02", "0.03",
     "--view", "history"],
], ids=["defaults", "tracer", "denoiser", "automate"])
def test_cli_config_mapping(argv):
    """Every field of the port's config equals the JAX CLI's (the JAX
    backend field excluded)."""
    argv = ["scene.txt"] + argv
    jcfg = jcli.config_from_args(jcli.build_arg_parser().parse_args(argv))
    cfg = cli.config_from_args(cli.build_arg_parser().parse_args(argv))
    fields = [f.name for f in cfg.__dataclass_fields__.values()]
    assert set(fields) == set(jcfg.__dataclass_fields__) - {"backend"}
    for name in fields:
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_cli_cpu_run_matches_raw_golden(scenes_dir, tmp_path, capsys):
    out = {k: str(tmp_path / f"{k}.{ext}") for k, ext in (
        ("out", "png"), ("raw", "png"), ("side", "png"), ("hdr", "hdr"))}
    assert cli.main([str(scenes_dir / "cornell.txt"), "--width", "64",
                     "--height", "64", "--depth", "3", "--frames", "3",
                     "--device", "cpu", "--out", out["out"], "--out-raw",
                     out["raw"], "--side-by-side", out["side"], "--hdr",
                     out["hdr"], "--stats"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln)["frame"] for ln in lines] == [0, 1, 2]
    assert all(json.loads(ln)["ms"] > 0 for ln in lines)
    assert all(os.path.getsize(p) > 0 for p in out.values())
    raw = image_io.load_image_rgb(out["raw"]).astype(np.int32)
    gold = jio.to_uint8(np.load(GOLDEN / "cornell_raw_d3.pallas.npz")
                        ["left"]).astype(np.int32)
    assert (np.abs(raw - gold).max(axis=-1) > 1).mean() < 0.01
    side = image_io.load_image_rgb(out["side"])
    assert side.shape == (64, 128, 3)
    np.testing.assert_array_equal(side[:, :64], raw)


def test_cli_default_device_needs_a_card(scenes_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.main([str(scenes_dir / "cornell.txt"), "--frames", "1"])


def test_cli_native_is_not_ported(scenes_dir, monkeypatch):
    """--native runs native mode (compat=False) on the CPU: one 8x8
    frame, exit 0, through a renderer whose config has compat off."""
    import ptdn_tpu_torch.engine as engine
    made = []

    def spy(*args, **kw):
        made.append(Renderer(*args, **kw))
        return made[-1]
    monkeypatch.setattr(engine, "Renderer", spy)
    assert cli.main([str(scenes_dir / "cornell.txt"), "--frames", "1",
                     "--width", "8", "--height", "8", "--device", "cpu",
                     "--native"]) == 0
    assert not made[0].cfg.compat and not made[0].step.tracer.gi.compat


def test_cli_native_writes_every_output(scenes_dir, tmp_path, capsys):
    """app.cli --native with SVGF: 2 frames of cornell 32x32 on the CPU
    (the spatial variance fallback on both), every output file written,
    a stats line per frame."""
    out = {k: str(tmp_path / f"{k}.{ext}") for k, ext in (
        ("out", "png"), ("raw", "png"), ("side", "png"), ("hdr", "hdr"))}
    assert cli.main([str(scenes_dir / "cornell.txt"), "--width", "32",
                     "--height", "32", "--depth", "2", "--frames", "2",
                     "--device", "cpu", "--native", "--denoise",
                     "--temporal", "--spatial", "--out", out["out"],
                     "--out-raw", out["raw"], "--side-by-side", out["side"],
                     "--hdr", out["hdr"], "--stats"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln)["frame"] for ln in lines] == [0, 1]
    assert all(os.path.getsize(p) > 0 for p in out.values())
    assert image_io.load_image_rgb(out["side"]).shape == (32, 64, 3)


# ---- the writers ----

def seeded_image(h=16, w=24):
    """Values below 0 and above 1 included."""
    return np.random.default_rng(7).uniform(-0.5, 3.0, (h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_to_uint8_and_png_bytes(tmp_path, as_tensor):
    img = seeded_image()
    arg = torch.from_numpy(img) if as_tensor else img
    np.testing.assert_array_equal(image_io.to_uint8(arg), jio.to_uint8(img))
    a = image_io.save_png(str(tmp_path / "port"), arg)
    b = jio.save_png(str(tmp_path / "jax"), img)
    assert a.endswith(".png")
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_hdr_bytes(tmp_path, as_tensor):
    img = seeded_image()
    img[0, 0] = 0.0                      # a black pixel: exponent 0
    img[1, 1] = [1e-35, 0.0, 0.0]        # below stb's 1e-32 floor
    arg = torch.from_numpy(img) if as_tensor else img
    a = image_io.save_hdr(str(tmp_path / "port"), arg)
    b = jio.save_hdr(str(tmp_path / "jax"), img)
    assert a.endswith(".hdr")
    assert open(a, "rb").read() == open(b, "rb").read()


def test_save_image_like_reference_bytes(tmp_path, monkeypatch):
    img = seeded_image()
    img[:, 0] = [1, 0, 0]  # leftmost column red
    stamp = "2026-01-02_03-04-05z"
    monkeypatch.setattr(image_io, "current_time_string", lambda: stamp)
    monkeypatch.setattr(jio, "current_time_string", lambda: stamp)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    a = image_io.save_image_like_reference(torch.from_numpy(img), "cornell",
                                           7, out_dir=str(tmp_path / "p"))
    b = jio.save_image_like_reference(img, "cornell", 7,
                                      out_dir=str(tmp_path / "j"))
    assert os.path.basename(a) == os.path.basename(b) == \
        f"cornell.{stamp}.7.0samp.png"
    assert open(a, "rb").read() == open(b, "rb").read()
    # horizontal flip (main.cpp:140): red ends up rightmost
    assert (image_io.load_image_rgb(a)[:, -1] == [255, 0, 0]).all()


def test_termview_matches_jax():
    img = seeded_image(40, 50).clip(0, 1)
    for width in (50, 17):
        assert termview.ansi_halfblocks(img, width) == \
            jterm.ansi_halfblocks(img, width)
    assert termview.ansi_halfblocks(img, 20, home=True) == \
        jterm.ansi_halfblocks(img, 20, home=True)
    np.testing.assert_array_equal(termview._downsample(img, 9, 7),
                                  jterm._downsample(img, 9, 7))


def test_scene_image_name():
    for name in SCENES:
        path = os.path.join(jbench.REPO, "scenes", f"{name}.txt")
        assert Scene(path).image_name == JScene(path).image_name


# ---- checkpoints ----

@pytest.mark.parametrize("kw", [RAW, SVGF], ids=["raw", "svgf"])
def test_checkpoint_resume_bitexact(cornell, tmp_path, kw):
    """Resuming from a checkpoint continues the exact frames (the camera
    rays remade from the restored orbit, the denoiser's kept branch and
    packed G-buffer dropped)."""
    cfg = RenderConfig(**kw)
    r1 = Renderer(cornell, cfg, RES, device="cpu")
    r1.render(3)
    ckpt = checkpoint.save_state(str(tmp_path / "state"),
                                 r1.step.frame_state(), r1.frame, r1.camera)
    a = [[t.clone() for t in r1.render_frame()] for _ in range(2)]

    r2 = Renderer(cornell, cfg, RES, device="cpu")
    r2.orbit(dphi=0.3)           # a used renderer, its camera elsewhere
    r2.render(1)
    checkpoint.restore_renderer(r2, ckpt)
    assert r2.frame == 3
    b = [r2.render_frame() for _ in range(2)]
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)


def test_jax_checkpoint_resumes_in_port(cornell, jax_run):
    r = Renderer(cornell, RenderConfig(**RAW), RES, device="cpu")
    checkpoint.restore_renderer(r, jax_run["path"])
    assert r.frame == 3
    for ref in jax_run["cont"]:
        within_raw_budget(r.render_frame()[0].numpy(), ref)


def test_port_checkpoint_loads_in_jax(cornell, jax_run, tmp_path):
    """Same keys, shapes and dtypes as the JAX state, and the JAX
    renderer resumed from it renders the port's next 2 frames within the
    raw budget."""
    r = Renderer(cornell, RenderConfig(**RAW), RES, device="cpu")
    r.render(3)
    path = checkpoint.save_state(str(tmp_path / "st"), r.step.frame_state(),
                                 r.frame, r.camera)
    state, frame, cam = jckpt.load_state(path)
    assert frame == 3 and cam is not None
    assert set(state) == set(jax_run["state"])
    for k, v in state.items():
        ref = jax_run["state"][k]
        assert (v.shape, v.dtype) == (ref.shape, ref.dtype), k
    port_state, _, _ = checkpoint.load_state(path, "cpu")
    for k, v in port_state.items():
        assert v.dtype == r.step.frame_state()[k].dtype, k
    jr = jax_run["renderer"]
    jckpt.restore_renderer(jr, path)
    for _ in range(2):
        within_raw_budget(r.render_frame()[0].numpy(),
                          np.asarray(jr.render_frame()[0]))


def test_load_state_to_cuda_needs_a_card(tmp_path, monkeypatch):
    path = checkpoint.save_state(str(tmp_path / "st"),
                                 {"accum_image": np.zeros((2, 2, 3))}, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        checkpoint.load_state(path)


# ---- stats and the profiler ----

def test_stats_collector(cornell):
    sc = stats.StatsCollector(Renderer(cornell, RenderConfig(**SVGF), RES,
                                       device="cpu"),
                              collect_denoiser_stats=True)
    sc.render_frame()
    sc.render_frame()
    st = sc.frames[-1]
    assert st.frame == 1 and st.accum_frame == 1
    assert st.ms > 0 and st.rays_per_s > 0
    assert 0.0 <= st.history_rejection_rate <= 1.0
    assert st.mean_variance >= 0
    assert "rays_per_s" in st.json()


def test_profiler_trace_writes_a_trace(cornell, tmp_path):
    r = Renderer(cornell, RenderConfig(**RAW), (16, 16), device="cpu")
    with stats.profiler_trace(str(tmp_path / "trace")):
        r.render_frame()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


# ---- the evaluator ----

def test_eval_rmse_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    assert peval.rmse(a, b) == jeval.rmse(a, b)


def test_eval_main_cpu(scenes_dir, capsys):
    assert peval.main([str(scenes_dir / "cornell.txt"), "--width", "64",
                       "--height", "64", "--depth", "3", "--gt-frames", "3",
                       "--frames", "3", "--device", "cpu",
                       "--compare-devices"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"scene", "resolution", "gt_frames", "svgf_frames",
                        "rmse_raw_1spp_vs_gt", "rmse_denoised_vs_gt",
                        "rmse_cuda_vs_cpu_denoised", "rmse_cuda_vs_cpu_raw"}
    assert out["resolution"] == [64, 64]
    assert 0 < out["rmse_raw_1spp_vs_gt"] < 1
    assert out["rmse_cuda_vs_cpu_raw"] == out["rmse_cuda_vs_cpu_denoised"] \
        == 0.0


# ---- the bench's helpers ----

@pytest.mark.parametrize("name", SCENES)
def test_bench_scene_sha_matches_jax(name):
    path = os.path.join(jbench.REPO, "scenes", f"{name}.txt")
    assert bench._scene_sha(path) == jbench._scene_sha(path)


@pytest.mark.parametrize("name,res", [("cornell", (800, 800)),
                                      ("room", (600, 600))])
def test_bench_scene_sha_matches_stored(name, res):
    with np.load(bench._gt_path(name, res, 8)) as z:
        stored = str(z["scene_sha"])
    assert bench._scene_sha(os.path.join(jbench.REPO, "scenes",
                                         f"{name}.txt")) == stored


def test_bench_configs_match_jax():
    sd = "/some/scenes"
    assert bench.bench_configs(sd) == jbench.bench_configs(sd)
    assert [c[:3] for c in bench.configs(sd, True)] == (
        [(f"{sd}/cornell.txt", "cornell", (800, 800))]
        + jbench.bench_configs(sd)
        + [(f"{sd}/room.txt", "room_1080p_animated", (1920, 1080))])
    assert [c[3] for c in bench.configs(sd, True)] == [False] * 5 + [True]
    assert bench.configs(sd, False) == bench.configs(sd, True)[:1]
    assert bench.MOVING == dict(automate_camera=True, camera_speed_x=0.02,
                                camera_speed_theta=0.01,
                                camera_speed_phi=0.015)


def test_bench_ground_truth_is_read_only(scenes_dir, tmp_path):
    """A legacy file (no hash) is read and left byte for byte; a stale
    hash and a missing file raise."""
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    legacy = gt_dir / "diamond_800x800_d8.npz"
    shutil.copy(bench._gt_path("diamond", (800, 800), 8), legacy)
    before = legacy.read_bytes()
    gt, frames = bench.ground_truth(str(scenes_dir / "diamond.txt"),
                                    "diamond", (800, 800), 8, gt_dir)
    assert gt.shape == (800, 800, 3) and frames == 5000
    assert legacy.read_bytes() == before
    stale = gt_dir / "cornell_800x800_d8.npz"
    np.savez_compressed(stale, gt=np.zeros((2, 2, 3), np.float32),
                        gt_frames=1, scene_sha="0123456789abcdef")
    with pytest.raises(RuntimeError, match="cornell_800x800_d8.npz is stale"):
        bench.ground_truth(str(scenes_dir / "cornell.txt"), "cornell",
                           (800, 800), 8, gt_dir)
    with pytest.raises(FileNotFoundError, match="room_600x600_d8"):
        bench.ground_truth(str(scenes_dir / "room.txt"), "room", (600, 600),
                           8, gt_dir)


def test_bench_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench.main([])


# ---- the port imports no JAX ----

def test_port_imports_no_jax():
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "ptdn_tpu")]
    assert bad == []
    assert len(list(PORT.rglob("*.py"))) > 40
