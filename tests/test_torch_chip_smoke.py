"""The checks chip_smoke.py gates the port's kernels with, on the CPU.

chip_smoke.py runs on a GPU; its exact row check (rows_valid) is plain
PyTorch, so it is exercised here on the plain selections and on selections
broken on purpose. The script itself must refuse to run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from hdl_graph_slam_tpu_torch.ops import knn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clouds(seed, n=300, m=900, n_pad=60):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(-60, 60, (n, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-60, 60, (m, 3)).astype(np.float32))
    t[m - n_pad:] = 1.0e6
    return q, t, torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("kind", ["nn1", "knn_select"])
def test_rows_valid_accepts_the_plain_selection(kind):
    q, t, rows = clouds(60)
    idx = knn.nn1_plain(q, t)[0] if kind == "nn1" else knn.knn_select_plain(q, t, 20)[0]
    valid, excess = chip_smoke.rows_valid(q, t, idx, rows)
    assert valid == 1.0 and excess <= chip_smoke.ROW_ULPS


@pytest.mark.parametrize("kind", ["nn1", "knn_select"])
def test_rows_valid_rejects_a_farther_neighbour(kind):
    """Replacing the farthest chosen neighbour by the next one out must fail
    on (nearly) every row: the gap is far above the rounding bound."""
    q, t, rows = clouds(61)
    i21 = knn.knn_select_plain(q, t, 21)[0]
    bad = i21[:, 1].contiguous() if kind == "nn1" else torch.cat([i21[:, :19], i21[:, 20:]], 1)
    valid, excess = chip_smoke.rows_valid(q, t, bad, rows)
    assert valid < 0.01 and excess > 1e3 * chip_smoke.ROW_ULPS


def test_rows_valid_rejects_a_duplicated_neighbour():
    """A row that names its (k-1)-th neighbour twice and drops the k-th
    passes the distance test (the largest chosen distance is not above the
    dropped one) and must fail as a repeat."""
    q, t, rows = clouds(65)
    idx = knn.knn_select_plain(q, t, 20)[0]
    dup = torch.cat([idx[:, :19], idx[:, 18:19]], 1)
    valid, excess = chip_smoke.rows_valid(q, t, dup, rows)
    assert valid == 0.0 and excess <= 0.0


def test_rows_valid_with_all_targets_chosen():
    q, t, rows = clouds(62, m=20, n_pad=0)
    idx = knn.knn_select_plain(q, t, 20)[0]
    assert chip_smoke.rows_valid(q, t, idx, rows)[0] == 1.0


def test_refuses_to_run_without_a_gpu_or_alone(tmp_path):
    """Without a card, or copied alone into an empty directory, the script
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


# -- the golden_town phases' helpers ---------------------------------------------


def test_check_batched_gates_plain_selections(monkeypatch):
    """check_batched passes the plain twins on a ragged batch (on the CPU
    the batched wrappers run their plain twins), and fails a broken one."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    q, t, _ = clouds(63)
    qb, tb = torch.stack([q, q + 0.5]), torch.stack([t, t])
    tb[1, 400:] = 1.0e6
    rows_q = torch.ones(qb.shape[:2], dtype=torch.bool)
    rows_t = (tb.abs() < 1e5).all(-1)
    for kind, qq, rows in (("nn1", qb, rows_q), ("knn_select", tb, rows_t)):
        row = chip_smoke.check_batched(knn, kind, qq, tb, rows, "cpu")
        assert row["rows_valid"] == 1.0 and row["idx_identical"]
    broken = lambda q_, t_: (knn.knn_select_batched_plain(q_, t_, 21)[0][..., 1], knn.nn1_batched_plain(q_, t_)[1])
    monkeypatch.setattr(knn, "nn1_batched", broken)
    with pytest.raises(RuntimeError):
        chip_smoke.check_batched(knn, "nn1", qb, tb, rows_q, "broken")


def test_synthetic_graph_solves_on_cpu():
    from hdl_graph_slam_tpu_torch.graph import optimize

    g = chip_smoke.synthetic_graph(0)
    assert len(g.poses) == 95 and len(g.edge_rows["se3_se3"]) == 93 + 1 + 12
    _, st = optimize(g.freeze(dtype=torch.float64, device="cpu"), max_iterations=8)
    assert float(st.chi2_robust_after) < 0.5 * float(st.chi2_robust_before)


class _Ev:
    def __init__(self, name, a, b, cuda):
        from torch.autograd import DeviceType

        self.name = name
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def test_device_busy_unions_intervals():
    """Overlapping device intervals count once; a named window counts only
    the device time inside it; the device-side mirror of an annotation is
    no device work (times in microseconds)."""
    events = [_Ev("k", 10, 30, True), _Ev("k", 20, 40, True), _Ev("k", 70, 80, True),
              _Ev("slam/x", 0, 50, False), _Ev("slam/x", 5, 45, True), _Ev("other", 0, 100, False)]
    prof = type("P", (), {"events": lambda self: events})()
    busy, wall = chip_smoke.device_busy(prof)
    assert (busy, wall) == pytest.approx((40e-6, 100e-6))
    busy, wall = chip_smoke.device_busy(prof, {"slam/x"})
    assert (busy, wall) == pytest.approx((30e-6, 50e-6))


def test_stage_clock_wraps_and_restores():
    class Owner:
        def work(self, x):
            return 2 * x

    clock = chip_smoke.StageClock()
    clock.wrap(Owner, "work", "w", keep_result=True)
    assert Owner().work(3) == 6 and Owner().work(4) == 8
    assert clock.timer.counts["w"] == 2 and clock.timer.totals["w"] >= 0.0
    assert clock.results["w"] == [6, 8]
    clock.restore()
    assert Owner.work.__name__ == "work"


def test_golden_town_course_is_the_benchmark_course():
    """utils/course.py's golden_town poses are benchmarks/golden_town.py's:
    town_course(blocks=2, loops=2, step=1.2) with the sensor 1.8 m up."""
    from hdl_graph_slam_tpu.utils import lidar_sim as jL
    from hdl_graph_slam_tpu_torch.utils import course

    poses = course.golden_town_sensor_poses()
    ref = jL.town_course(blocks=2, loops=2, step=1.2)
    assert len(poses) == len(ref) == 601
    for p, r in zip(poses, ref):
        r = r.copy()
        r[2, 3] += 1.8
        np.testing.assert_array_equal(p, r)
    cfg = course.golden_town_config()
    assert (cfg.loop.distance_thresh, cfg.loop.accum_distance_thresh, cfg.loop.min_edge_interval,
            cfg.loop.fitness_score_thresh, cfg.backend.g2o_solver_num_iterations) == (15.0, 25.0, 15.0, 2.5, 60)


# -- the filter, floor and per-frame phases' helpers ---------------------------------


@pytest.mark.parametrize("case", ["uniform", "lattice"])
def test_check_radius_gates_plain_counts(monkeypatch, case):
    """check_radius passes the plain twin (radius_count on the CPU) against
    float64 counts, on every row of an integer lattice at r = 1, and fails
    counts off by one."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    if case == "uniform":
        q, t, rows = clouds(64, n=300, m=900)
        r, exact = 12.0, False
    else:
        g = torch.arange(6, dtype=torch.float32)
        q = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        q = t = torch.cat([q, q[::7]])  # duplicates: pairs at d^2 = 0 < 1, none at 1
        rows, r, exact = torch.ones(q.shape[0], dtype=torch.bool), 1.0, True
    row = chip_smoke.check_radius(knn, q, t, r, rows, case, exact_ties=exact)
    assert row["rows_off_float64"] == 0 and row["idx_identical"] and row["mean_count"] > 1.0
    monkeypatch.setattr(knn, "radius_count", lambda q_, t_, r_: knn.radius_count_plain(q_, t_, r_) + 1)
    with pytest.raises(RuntimeError):
        chip_smoke.check_radius(knn, q, t, r, rows, "broken", exact_ties=exact)


def test_exact_radius_counts_flags_pairs_at_the_radius():
    """A pair at exactly r is within rounding of r^2; one clear of it is not."""
    q = torch.tensor([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]])
    t = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [10.3, 0.0, 0.0]])
    counts, near = chip_smoke.exact_radius_counts(q, t, 0.5)
    assert counts.tolist() == [1, 1] and near.tolist() == [True, False]


def test_launch_counts_read_per_kernel_entry():
    """read_launches reports knn_select per k, its GICP k = 20 under the
    plain name; reset_launches zeroes every counter."""
    knn.radius_count.launches = 5
    knn.knn_select.launches_k = {10: 2, 20: 3, 21: 4}
    got = chip_smoke.read_launches(knn)
    assert (got["knn_select"], got["knn_select_k10"], got["knn_select_k21"], got["radius_count"]) == (3, 2, 4, 5)
    chip_smoke.reset_launches(knn)
    assert set(chip_smoke.read_launches(knn).values()) == {0}


def test_floor_band_is_the_detectors_clip():
    """floor_band keeps z strictly inside (-h - range, -h + range), as the
    floor detector's two plane clips do."""
    from hdl_graph_slam_tpu_torch.core import cloud

    z = np.array([-3.0, -2.79, -2.0, -1.8, -0.81, -0.5, 1.0], np.float32)
    xyz = np.stack([np.zeros_like(z), np.zeros_like(z), z], 1)
    band = chip_smoke.floor_band(cloud.from_numpy(xyz, capacity=8, device="cpu"))
    assert band.mask.tolist() == [False, True, True, True, True, False, False, False]


def test_golden_town_floor_configs():
    """golden_town.py make_cfg("floor") and the outdoor preset's RADIUS
    filter on top of it (utils/course.py)."""
    from hdl_graph_slam_tpu_torch.utils import course

    cfg = course.golden_town_config("floor")
    assert cfg.floor.enabled and (cfg.floor.sensor_height, cfg.floor.height_clip_range,
                                  cfg.floor.floor_pts_thresh) == (1.8, 1.0, 256)
    assert cfg.prefilter.outlier_removal_method == "NONE" and not course.golden_town_config().floor.enabled
    out = course.golden_town_outdoor_config()
    assert out.floor.enabled and (out.prefilter.outlier_removal_method, out.prefilter.radius_radius,
                                  out.prefilter.radius_min_neighbors) == ("RADIUS", 0.8, 2)
    with pytest.raises(ValueError):
        course.golden_town_config("gps")


def test_check_knn_near_tie_gate(monkeypatch):
    """With near_ties, check_knn passes sets that differ from the plain
    twin's only by equally near neighbours (a lattice's ties, broken by
    another index order) and fails a set holding a farther neighbour."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    g = torch.arange(5, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rows = torch.ones(t.shape[0], dtype=torch.bool)
    plain = knn.knn_select_plain
    # the same distances, highest index first among ties
    flipped = lambda q_, t_, k_: tuple(x.flip(0) for x in plain(q_.flip(0), t_.flip(0), k_))  # noqa: E731

    def tie_swapped(q_, t_, k_):
        i, d = flipped(q_, t_, k_)
        return (t_.shape[0] - 1 - i).int(), d

    monkeypatch.setattr(knn, "knn_select", tie_swapped)
    row = chip_smoke.check_knn(knn, t, t, rows, "ties", k=10, near_ties=True)
    assert row["rows_identical_sets"] < 1.0 and row["plain_rows_valid_where_sets_differ"] == 1.0
    monkeypatch.setattr(knn, "knn_select", lambda q_, t_, k_: (plain(q_, t_, k_ + 3)[0][:, 3:].contiguous(),
                                                               plain(q_, t_, k_ + 3)[1][:, 3:].contiguous()))
    with pytest.raises(RuntimeError):
        chip_smoke.check_knn(knn, t, t, rows, "farther", k=10, near_ties=True)
