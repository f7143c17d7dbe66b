"""The check fails what it must: the bfloat16 control in the program's
place, and a run of the harness (its look for a card skipped, on the CPU
at a small size) with the timed path broken underneath. The faults a
cell of one chip can have: a step that returns its state unchanged, half
of the frame's pixels left out, the frame's answer altered where it is
produced. (No cell spans chips: no exchange to leave out.)"""

import time

import pytest
import torch

from perfbench import camera_path, check, harness

RES = (32, 24)


def small(name, monkeypatch):
    cell = harness.Cell.load(name)
    cell.traffic["warmup_frames"] = 3
    # the compared window frames at the window's start, so that a short
    # CPU window holds them
    real = camera_path.Draw.__init__

    def draw(self, seed, traffic, samples):
        real(self, seed, traffic, samples)
        self.sample_at = [0.0] * samples
    monkeypatch.setattr(camera_path.Draw, "__init__", draw)
    return cell


def run(cell):
    return harness.run(cell, 2**33 + 17, 1.0, False, time.perf_counter(),
                       device="cpu", resolution=RES)


@pytest.mark.parametrize("name", ["cornell_800.still", "room_1080.orbit"])
def test_control_fails_the_limits(name):
    cell = harness.Cell.load(name)
    ref = harness.reference(cell, RES, "cpu")
    ctrl = harness.reference(cell, RES, "cpu", check.control_store)
    path = camera_path.CameraPath(cell.traffic, 3)
    first = ref.frame(path.pose(0), None, 0)
    got = ctrl.frame(path.pose(0), None, 0)
    history = {k: first[k] for k in ("color_history", "moment_history",
                                     "history_length")}
    later = [(ref.frame(path.pose(1), path.pose(0), 77, history),
              ctrl.frame(path.pose(1), path.pose(0), 77, history))]
    for want, out in [(first, got)] + later:
        r = check.readings(out, want)
        assert all(r[k] > 100 * cell.limits[k] for k in check.NUMBERS), r


def test_a_sound_run_is_correct(monkeypatch):
    out = run(small("cornell_800.still", monkeypatch))
    assert out["correct"], out["check"]
    assert out["check"]["frames_compared"]["value"] == 3
    assert out["check"]["tracer_off"]["value"] == 0.0


def fault_state_unchanged(monkeypatch):
    from ptdn_tpu_torch.engine.step import FrameStep

    real = FrameStep.forward

    def forward(self, *a, **kw):
        keep = {k: getattr(self.denoiser, k).clone() for k in (
            "color_history", "moment_history", "history_length")}
        out = real(self, *a, **kw)
        for k, v in keep.items():
            setattr(self.denoiser, k, v)
        return out
    monkeypatch.setattr(FrameStep, "forward", forward)
    return "denoiser_off"


def fault_half_left_out(monkeypatch):
    from ptdn_tpu_torch.engine.wavefront import PathTracer

    real = PathTracer.forward

    def forward(self, *a, **kw):
        radiance, gb = real(self, *a, **kw)
        radiance = radiance.clone()
        radiance[radiance.shape[0] // 2:] = 0.0
        return radiance, gb
    monkeypatch.setattr(PathTracer, "forward", forward)
    return "tracer_off"


def fault_answer_altered(monkeypatch):
    from ptdn_tpu_torch.engine.wavefront import PathTracer

    real = PathTracer.forward

    def forward(self, *a, **kw):
        radiance, gb = real(self, *a, **kw)
        return radiance * 1.001, gb
    monkeypatch.setattr(PathTracer, "forward", forward)
    return "tracer_off"


@pytest.mark.parametrize("fault", [fault_state_unchanged,
                                   fault_half_left_out,
                                   fault_answer_altered])
@pytest.mark.parametrize("name", ["cornell_800.still", "room_1080.orbit"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = small(name, monkeypatch)
    number = fault(monkeypatch)
    out = run(cell)
    assert not out["correct"]
    assert out["check"][number]["value"] > out["check"][number]["limit"]
    assert out["check"]["frames_compared"]["value"] == \
        out["check"]["frames_compared"]["limit"]
