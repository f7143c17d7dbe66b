"""The general camera generator and what a seed sets."""

import math

from perfbench import camera_path, harness


def orbit():
    return harness.Cell.load("room_1080.orbit").traffic


def test_orbit_closes_after_its_loop():
    t = orbit()
    assert t["loop_frames"] == 120
    path = camera_path.CameraPath(t, phase=7)
    for i in range(0, 240, 13):
        a, b = path.pose(i), path.pose(i + 120)
        assert all(math.isclose(x, y, abs_tol=1e-9) for x, y in
                   zip(a["look_at"] + [a["theta"], a["phi"]],
                       b["look_at"] + [b["theta"], b["phi"]]))
    # it moves every frame: x twice a loop, theta and phi once
    assert path.pose(1) != path.pose(2)
    p0 = camera_path.CameraPath(t, phase=0).pose(0)
    assert p0["look_at"] == [0.0, 5.0, 0.0] and p0["phi"] == 0.0
    assert math.isclose(p0["theta"], math.pi / 2)


def test_the_seed_sets_the_phase_and_the_noise_alone():
    t = orbit()
    draws = [camera_path.Draw(s, t, 2) for s in (1, 2, 2**31 + 5, 2**33)]
    assert len({d.phase for d in draws}) > 1
    assert len({d.first_frame for d in draws}) == len(draws)
    again = camera_path.Draw(2**33, t, 2)
    assert (again.phase, again.first_frame, again.sample_at) == (
        draws[-1].phase, draws[-1].first_frame, draws[-1].sample_at)
    for d in draws:
        assert 0 <= d.phase < 120
        assert t["warmup_frames"] <= d.first_frame < 2**21
        assert all(0.1 <= f <= 0.9 for f in d.sample_at)
    # the path is the loop whatever the seed: a phase shifts it
    a = camera_path.CameraPath(t, draws[0].phase)
    b = camera_path.CameraPath(t, 0)
    assert a.pose(0) == b.pose(draws[0].phase)


def test_still_keeps_the_scenes_camera():
    t = harness.Cell.load("cornell_800.still").traffic
    path = camera_path.CameraPath(t, camera_path.Draw(9, t, 2).phase)
    assert [path.pose(i) for i in range(5)] == [None] * 5
