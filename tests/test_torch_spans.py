"""The program's spans (utils/stats.py: span): off without a profiler, on
and nested as documented under one, and what perfbench/work/stages.py
reads of them in a chrome trace, with the benchmark's existing per-layer
metrics reading the same values whether the trace holds them or not."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness
from perfbench.tests.test_perfbench_metrics import ev, run_of, synthetic
from perfbench.trace import summarize
from perfbench.work import stages
from ptdn_tpu_torch import profile_frame
from ptdn_tpu_torch.engine import Renderer
from ptdn_tpu_torch.parallel.mesh import InProcessGroup
from ptdn_tpu_torch.parallel.sharded import ShardedRenderer
from ptdn_tpu_torch.scene import Scene
from ptdn_tpu_torch.utils import stats
from ptdn_tpu_torch.utils.config import RenderConfig
from test_torch_mesh import torch_on_one_thread  # noqa: F401 (autouse)

# each span's parent, as utils/stats.py documents them
PARENT = {
    "ptdn.frame": None,
    "ptdn.step": "ptdn.frame",
    "ptdn.tracer": "ptdn.step",
    "ptdn.tracer.camera": "ptdn.tracer",
    "ptdn.tracer.shade": "ptdn.tracer",
    "ptdn.tracer.ranges": "ptdn.tracer",
    "ptdn.tracer.permute": "ptdn.tracer",
    "ptdn.tracer.bounce": "ptdn.tracer",
    "ptdn.tracer.visibility": "ptdn.tracer",
    "ptdn.tracer.next_hit": "ptdn.tracer",
    "ptdn.denoiser": "ptdn.step",
    "ptdn.denoiser.pack": "ptdn.denoiser",
    "ptdn.denoiser.motion": "ptdn.denoiser",
    "ptdn.sync.motion": "ptdn.denoiser.motion",
    "ptdn.denoiser.reproject": "ptdn.denoiser",
    "ptdn.denoiser.atrous": "ptdn.denoiser",
}
SVGF = dict(denoise_enable=True, temporal_enable=True, spatial_enable=True,
            atrous_nlevel=5)
# every frame's, and the first (moved) frame's besides
FRAME = {"ptdn.frame", "ptdn.step", "ptdn.tracer", "ptdn.denoiser",
         "ptdn.denoiser.reproject", "ptdn.denoiser.atrous"}
MOVED = {"ptdn.tracer.camera", "ptdn.denoiser.pack", "ptdn.denoiser.motion",
         "ptdn.sync.motion"}
# scene, resolution, flags, engine, the engine's own spans a bounce
CASES = {
    "whole_path": ("cornell", (64, 64), {}, "whole_path", set()),
    "sorted": ("room", (32, 32), dict(trace_depth=3), "sorted",
               {"ptdn.tracer.shade", "ptdn.tracer.ranges",
                "ptdn.tracer.permute", "ptdn.tracer.bounce"}),
    "bounce_split": ("cornell", (32, 32),
                     dict(fuse_path=False, fuse_bounce=False, trace_depth=3),
                     "bounce_split",
                     {"ptdn.tracer.shade", "ptdn.tracer.visibility",
                      "ptdn.tracer.next_hit"}),
    "bounce_fused": ("cornell", (32, 32),
                     dict(fuse_path=False, sort_rays=False, trace_depth=3),
                     "bounce_fused",
                     {"ptdn.tracer.shade", "ptdn.tracer.next_hit"}),
    "fuse_reproject_l1": ("cornell", (32, 32),
                          dict(fuse_reproject_l1=True, trace_depth=3),
                          "whole_path", set()),
}


def _spans(prof):
    """[(start, end, name)] of the program's spans in the profile's
    chrome trace (its events read whole would take the profile's
    minutes)."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in profile_frame.chrome_events(prof)
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("ptdn."))


def _parent(spans, i):
    """The name of the innermost other span that holds spans[i]."""
    s, e, _ = spans[i]
    holders = [(s2, -e2, n2) for j, (s2, e2, n2) in enumerate(spans)
               if j != i and s2 <= s and e <= e2]
    return max(holders)[2] if holders else None


def test_span_off_is_one_shared_null_context(monkeypatch, scenes_dir):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: made.append(a))
    assert not torch.autograd._profiler_enabled()
    off = stats.span("ptdn.frame", 3)
    assert off is stats.span("ptdn.tracer")
    assert isinstance(off, contextlib.nullcontext)
    # a frame of every stage, moved and still, makes none either
    r = Renderer(Scene(str(scenes_dir / "room.txt")),
                 RenderConfig(trace_depth=2, **SVGF), (16, 16), device="cpu")
    r.render_frame()
    r.render_frame()
    assert made == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_as_documented(case, monkeypatch, scenes_dir):
    """Two frames (the first moved, the second still) under a CPU
    profile: every span named in utils/stats.py where its stage runs,
    each inside its parent, and ptdn.frame's args the frame index."""
    scene, res, kw, engine, per_bounce = CASES[case]
    args = []

    class Recording(torch.autograd.profiler.record_function):
        def __init__(self, name, a=None):
            if name == "ptdn.frame":
                args.append(a)
            super().__init__(name, a)
    monkeypatch.setattr(torch.profiler, "record_function", Recording)
    r = Renderer(Scene(str(scenes_dir / f"{scene}.txt")),
                 RenderConfig(**SVGF, **kw), res, device="cpu")
    assert r.step.tracer.engine == engine
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame()
        r.render_frame()
    spans = _spans(prof)
    names = [n for _, _, n in spans]
    assert set(names) == FRAME | MOVED | per_bounce
    for n in FRAME:
        assert names.count(n) == 2, n
    for n in per_bounce:
        assert names.count(n) >= 2 * (r.cfg.trace_depth - 1), n
    assert names.count("ptdn.tracer.camera") == 1
    for i, (_, _, n) in enumerate(spans):
        assert _parent(spans, i) == PARENT[n], n
    assert args == ["0", "1"]


def test_shards_record_the_same_spans(scenes_dir):
    """A frame of two row shards in one process: one frame span, the
    step's spans once a shard."""
    r = ShardedRenderer(Scene(str(scenes_dir / "cornell.txt")),
                        RenderConfig(trace_depth=2, **SVGF), (16, 16),
                        InProcessGroup(2), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame()
    names = [n for _, _, n in _spans(prof)]
    assert names.count("ptdn.frame") == 1
    for n in ("ptdn.step", "ptdn.tracer", "ptdn.denoiser",
              "ptdn.denoiser.atrous", "ptdn.sync.motion"):
        assert names.count(n) == 2, n


def test_shards_interleave_so_no_stage_is_read(capsys, scenes_dir):
    """A moved frame of two row shards in one process: shard 0's step
    and denoiser stay open while shard 1 runs its tracer, so stages.read
    refuses the trace rather than put shard 1's launches in shard 0's
    stages; read without the program's spans, and profile_frame's report
    of it, name no stage."""
    r = ShardedRenderer(Scene(str(scenes_dir / "cornell.txt")),
                        RenderConfig(trace_depth=2, **SVGF), (16, 16),
                        InProcessGroup(2), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(profile_frame.WINDOW):
            r.render_frame()
    events = profile_frame.chrome_events(prof)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation"]
    held = [(s, e) for s, e, n in spans if n == "ptdn.denoiser"]
    assert any(s < s2 and e2 < e for s, e in held
               for s2, e2, n in spans if n == "ptdn.tracer"), \
        "a shard's tracer ran inside the other's denoiser"
    w = next(e for e in events if e.get("name") == profile_frame.WINDOW)
    lo, hi = w["ts"], w["ts"] + w["dur"]
    with pytest.raises(stages.Interleaved):
        stages.read(events, lo, hi, 1)
    st = stages.read(events, lo, hi, 1, program=False)
    assert st.opened == frozenset() and st.syncs == []
    assert st.kernel_ms("ptdn.denoiser.motion") is None
    profile_frame.report(st, 1.0, "[cpu]")
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "stages: no span read [cpu]" and len(out) == 2


@pytest.mark.parametrize("case", ["overlap", "same_name"])
def test_stages_refuse_spans_that_do_not_nest(case):
    """Two shards' frames in lock step, by hand: shard 1's tracer launch
    falls inside shard 0's still open motion read. And a span inside
    one of its own name."""
    spans = [ev("ptdn.frame", "user_annotation", 12, 425),
             ev("ptdn.step", "user_annotation", 20, 400)]
    if case == "overlap":
        spans += [ev("ptdn.denoiser.motion", "user_annotation", 25, 300),
                  ev("ptdn.tracer", "user_annotation", 30, 325)]
    else:
        spans += [ev("ptdn.step", "user_annotation", 30, 200)]
    with pytest.raises(stages.Interleaved):
        stages.read(synthetic() + spans, 0, 1000, 2)
    # read whole, the program's spans left out
    assert stages.read(synthetic() + spans, 0, 1000, 2,
                       program=False).opened == frozenset()


def test_spans_ending_with_their_parent_nest():
    """A span ending where its parent does, or starting where its
    sibling ended, nests (the trace rounds to the ns)."""
    spans = [ev("ptdn.frame", "user_annotation", 12, 425),
             ev("ptdn.step", "user_annotation", 20, 417),
             ev("ptdn.tracer", "user_annotation", 20, 100.0004),
             ev("ptdn.denoiser", "user_annotation", 120, 317)]
    st = stages.read(synthetic() + spans, 0, 1000, 2)
    assert st.opened == {"ptdn.frame", "ptdn.step", "ptdn.tracer",
                         "ptdn.denoiser"}


def program_events():
    """synthetic()'s window with the program's spans: a frame whose step
    holds the tracer (its camera and one permute) and the denoiser (its
    motion read); the second launch inside the permute, a blocking call
    in the motion read and one in the harness's sync."""
    return [
        ev("ptdn.frame", "user_annotation", 12, 425),
        ev("ptdn.step", "user_annotation", 20, 400),
        ev("ptdn.tracer", "user_annotation", 30, 325),
        ev("ptdn.tracer.camera", "user_annotation", 35, 20),
        ev("ptdn.tracer.permute", "user_annotation", 250, 100),
        ev("ptdn.denoiser", "user_annotation", 360, 60),
        ev("ptdn.denoiser.motion", "user_annotation", 370, 40),
        ev("ptdn.sync.motion", "user_annotation", 380, 20),
        # the device's shadow of a span: not the host's
        ev("ptdn.tracer", "gpu_user_annotation", 100, 200),
        ev("cudaStreamSynchronize", "cuda_runtime", 385, 10),
        ev("cudaDeviceSynchronize", "cuda_runtime", 450, 500),
    ]


def test_stages_of_a_window():
    st = stages.read(synthetic() + program_events(), 0, 1000, frames=2)
    assert st.window_s == pytest.approx(1e-3)
    assert st.busy_s == pytest.approx(350e-6)
    # the first kernel (100 us) in the camera, the second (150) in the
    # permute, the third (100) outside every frame
    assert st.kernels[0][2] == ("ptdn.frame", "ptdn.step", "ptdn.tracer",
                                "ptdn.tracer.camera")
    assert st.kernel_ms("ptdn.tracer.camera") == pytest.approx(0.05)
    assert st.kernel_ms("ptdn.tracer.permute") == pytest.approx(0.075)
    assert st.kernel_ms("ptdn.tracer") == pytest.approx(0.125)
    assert st.launches("ptdn.step") == pytest.approx(1.0)
    assert st.kernel_ms("ptdn.denoiser.motion") == 0.0
    assert st.kernel_ms("ptdn.denoiser.pack") is None
    assert st.launches("ptdn.denoiser.pack") is None
    # gaps [0, 100) harness, [300, 500) from the permute, [600, 650)
    # and [700, 1000) in the harness's sync
    assert st.idle_ms("ptdn.step") == pytest.approx(0.1)
    assert st.idle_ms("ptdn.tracer.camera") == 0.0
    assert st.idle_ms("ptdn.denoiser.pack") is None
    by = st.idle_by_stage()
    assert by == {"harness": pytest.approx(0.225),
                  "ptdn.tracer.permute": pytest.approx(0.1)}
    assert sum(by.values()) == pytest.approx(
        (st.window_s - st.busy_s) * 1e3 / st.frames)
    # the harness's sync is outside ptdn.frame
    assert st.syncs == [("cudaStreamSynchronize", "ptdn.sync.motion")]
    assert st.syncs_per_frame() == pytest.approx(0.5)
    assert st.syncs_by_stage() == {
        "cudaStreamSynchronize in ptdn.sync.motion": pytest.approx(0.5)}


def test_no_sync_is_a_value_and_no_frame_none():
    events = synthetic() + program_events()[:-2]
    assert stages.read(events, 0, 1000, 2).syncs_per_frame() == 0.0
    none = stages.read(synthetic(), 0, 1000, 2)
    assert none.syncs_per_frame() is None and none.opened == frozenset()
    assert none.idle_by_stage() == {"harness": pytest.approx(0.325)}
    assert none.kernel_ms("ptdn.tracer.permute") is None


def test_existing_metrics_read_the_same_with_the_program_spans():
    """perfbench/trace.py reads its own spans alone: the program's added
    to the same events move no metric, label or breakdown."""
    names = ("device_idle_pct", "kernels_per_frame", "tracer_ms",
             "denoiser_ms", "atrous_roofline_pct")
    plain = summarize(synthetic(), frames=2)
    spanned = summarize(synthetic() + program_events(), frames=2)
    assert spanned == plain
    for name in names:
        assert harness.reader(name)(run_of([1e-4] * 2, 1e-3, trace=spanned)) \
            == harness.reader(name)(run_of([1e-4] * 2, 1e-3, trace=plain))
    assert spanned.breakdown() == plain.breakdown()


def test_profile_frame_reports_every_span(capsys, scenes_dir):
    """profile_frame's reading of a profile: the chrome trace's events,
    a line a span that opened, idle by stage and the host's syncs."""
    r = Renderer(Scene(str(scenes_dir / "cornell.txt")),
                 RenderConfig(trace_depth=2, **SVGF), (16, 16), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(profile_frame.WINDOW):
            r.render_frame()
    events = profile_frame.chrome_events(prof)
    w = next(e for e in events if e.get("name") == profile_frame.WINDOW)
    st = stages.read(events, w["ts"], w["ts"] + w["dur"], 1)
    # no device: the window is one gap, begun outside the frame
    assert st.opened == FRAME | MOVED and st.kernels == []
    profile_frame.report(st, 1.0, "[cpu]")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("profile: wall 1.000 ms/frame, device busy "
                             "0.000 ms/frame, idle share 1.000")
    assert [ln.split(":")[0] for ln in out[1:1 + len(st.opened)]] == \
        [f"stage {n}" for n in sorted(st.opened)]
    assert json.loads(out[-2].split(": ", 1)[1].rsplit(" ", 1)[0]) == \
        st.idle_by_stage()
    assert out[-1] == "host syncs: 0.0/frame {} [cpu]"
