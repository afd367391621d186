"""The card's ray caster (PyTorch) against the NumPy lidar_sim it copies."""

import numpy as np
import torch

from portbench import course as C
from portbench.course import cast, lidar_sim as L


def test_raycast_matches_numpy_on_the_same_beams():
    town = L.make_town(seed=5, blocks=3)
    model = L.LidarModel(rings=16, azimuth_steps=180, elev_min_deg=-24.8, elev_max_deg=2.0, max_range=120.0)
    st = cast.SceneTensors(town, "cpu")
    for pose in C.sensor_poses({"route_blocks": 2, "laps": 1, "step_m": 1.2, "turn_frames": 30, "frames": 60},
                               1.73)[::20]:
        dirs = model.directions() @ pose[:3, :3].T
        want = L._raycast(town, pose[:3, 3], dirs)
        got = cast.raycast(st, torch.as_tensor(pose[:3, 3]), torch.as_tensor(dirs)).numpy()
        assert np.array_equal(np.isinf(want), np.isinf(got))
        hit = np.isfinite(want)
        np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=1e-9)


def test_scans_without_noise_match_numpy_scan():
    town = L.make_town(seed=2, blocks=3)
    model = L.LidarModel(rings=8, azimuth_steps=90, range_noise=0.0, dropout=0.0)
    poses = C.sensor_poses({"route_blocks": 2, "laps": 1, "step_m": 1.2, "turn_frames": 30, "frames": 40}, 2.0)[::13]
    got = cast.cast_scans(town, poses, model, seed=1, device="cpu", noise=False)
    for pose, g in zip(poses, got):
        want = L.scan(town, pose, model, seed=0)
        assert g.dtype == np.float32 and g.shape == want.shape
        np.testing.assert_allclose(g, want, atol=1e-5)


def test_the_seed_draws_the_noise_not_the_town_or_the_route():
    sensor = {"rings": 8, "azimuth_steps": 90, "elev_min_deg": -24.8, "elev_max_deg": 2.0, "max_range_m": 120.0,
              "min_range_m": 0.5, "range_noise_m": 0.02, "dropout": 0.05, "height_m": 1.73}
    course = {"town_seed": 1, "town_blocks": 3, "route_blocks": 2, "laps": 1, "step_m": 1.2, "turn_frames": 30, "frames": 3,
              "period_s": 0.1}
    a, b, c = (C.build(sensor, course, s, "cpu") for s in (7, 7, 2**31 + 5))
    assert all(np.array_equal(x, y) for x, y in zip(a.scans, b.scans))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a.scans, c.scans))
    assert all(np.array_equal(x, y) for x, y in zip(a.sensor_poses, c.sensor_poses))
    quiet = {**sensor, "range_noise_m": 0.0, "dropout": 0.0}
    d, e = (C.build(quiet, course, s, "cpu") for s in (7, 2**31 + 5))
    assert all(np.array_equal(x, y) for x, y in zip(d.scans, e.scans))
