"""The checks chip_smoke.py gates the port's kernels with, on the CPU.

chip_smoke.py runs on a GPU; its exact row check (rows_valid) is plain
PyTorch, so it is exercised here on the plain selections and on selections
broken on purpose. The script itself must refuse to run without a GPU.
"""

import os
import shutil
import subprocess
import sys
import time

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


def test_device_ops_per_call_counts_device_events(monkeypatch):
    """device_ops_per_call profiles ``calls`` calls after a warm-up one and
    counts the device operations (kernels, copies, sets) in the trace, not
    the host's events; device_events keeps the device's only."""
    active = []

    class FakeProfile:  # records the events of the calls made inside it
        def __init__(self, activities):
            self.evs = []

        def __enter__(self):
            active.append(self)
            return self

        def __exit__(self, *exc):
            active.remove(self)
            return False

        def events(self):
            return self.evs

    calls = []

    def fn():
        calls.append(1)
        for prof in active:
            prof.evs += [_Ev("ndt_score_kernel", 0, 1, True), _Ev("aten::empty", 0, 1, False)]

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    assert chip_smoke.device_ops_per_call(fn, calls=4, pad_s=0.0) == (1.0, ["ndt_score_kernel"])
    assert len(calls) == 5
    # a trace that comes back without device events is taken again
    lost = iter([True])
    real_exit = FakeProfile.__exit__

    def exit_losing_first(self, *exc):
        if next(lost, False):
            self.evs = [e for e in self.evs if not e.device_type.name == "CUDA"]
        return real_exit(self, *exc)

    monkeypatch.setattr(FakeProfile, "__exit__", exit_losing_first)
    calls.clear()
    assert chip_smoke.device_ops_per_call(fn, calls=4, pad_s=0.0) == (1.0, ["ndt_score_kernel"])
    assert len(calls) == 9
    prof = FakeProfile(None)
    prof.evs = [_Ev("k", 0, 1, True), _Ev("h", 0, 1, False), _Ev("memset", 1, 2, True)]
    assert [e.name for e in chip_smoke.device_events(prof)] == ["k", "memset"]


def test_device_ops_per_call_retakes_partial_traces(monkeypatch):
    """A trace that lost some of its calls' device events is taken again
    (dropped events only lower the count); a call of two operations reads
    2.0 at once; when every trace is short, the calls are counted by graph
    capture, whose count is taken only where it is a whole number of kernel
    nodes a call; else (no capture, other nodes) the short count stays."""
    traces = []

    class FakeProfile:
        def __init__(self, activities):
            self.evs = []

        def __enter__(self):
            traces.append(self)
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.evs

    def call(kernels):
        def fn():
            if traces:
                traces[-1].evs += [_Ev(k, 0, 1, True) for k in kernels]
        return fn

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    real_exit = FakeProfile.__exit__
    kept = iter([4, 7])  # the first two traces keep 4 and 7 of 10 events

    def exit_losing(self, *exc):
        n = next(kept, None)
        if n is not None:
            self.evs = self.evs[:n]
        return real_exit(self, *exc)

    monkeypatch.setattr(FakeProfile, "__exit__", exit_losing)
    graphs = []
    monkeypatch.setattr(chip_smoke, "graph_ops_per_call", lambda fn, calls: graphs.pop(0))
    assert chip_smoke.device_ops_per_call(call(["radius_count_kernel"]), pad_s=0.0) == (1.0, ["radius_count_kernel"])
    assert len(traces) == 3
    traces.clear()
    assert chip_smoke.device_ops_per_call(call(["k", "memset"]), pad_s=0.0) == (2.0, ["k", "memset"])
    assert len(traces) == 1
    traces.clear()
    kept = iter([3] * 5)
    graphs.append(None)  # no capture: the short count stays
    assert chip_smoke.device_ops_per_call(call(["k"]), pad_s=0.0, tries=5)[0] == 0.3 and len(traces) == 5
    traces.clear()
    kept = iter([9] * 5)  # one event of each trace lost, the graph whole
    graphs.append((1.0, {0: 10}))
    assert chip_smoke.device_ops_per_call(call(["k"]), pad_s=0.0, tries=5) == (1.0, ["k"]) and len(traces) == 5
    traces.clear()
    kept = iter([9] * 5)  # a memset node beside each kernel is not a whole count of kernels
    graphs.append((2.0, {0: 10, 2: 10}))
    assert chip_smoke.device_ops_per_call(call(["k"]), pad_s=0.0, tries=5)[0] == 0.9
    traces.clear()
    kept = iter([9] * 5)
    graphs.append((0.5, {0: 5}))
    assert chip_smoke.device_ops_per_call(call(["k"]), pad_s=0.0, tries=5)[0] == 0.9
    assert not graphs


def test_graph_ops_per_call_is_none_without_a_capture():
    """Where no CUDA graph can be made (no card here), graph capture counts
    nothing and the caller keeps the profiler's count."""
    calls = []
    assert chip_smoke.graph_ops_per_call(lambda: calls.append(1)) is None
    assert not calls


def test_ndt_trial_poses_halve_along_the_newton_direction():
    """ndt_trial_poses: trial l is the step 0.1 / 2^l along the Newton
    direction of (g, H), left-multiplied onto the pose, for each problem."""
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.registration import ndt

    rng = np.random.default_rng(4)
    T = se3.se3_exp(torch.from_numpy(rng.normal(0, 0.1, (2, 6)).astype(np.float32)))
    A = torch.from_numpy(rng.normal(size=(2, 6, 6)).astype(np.float32))
    H, g = A @ A.transpose(1, 2) + torch.eye(6), torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
    Ts = chip_smoke.ndt_trial_poses(T, g, H, trials=4)
    d = ndt._newton_direction(H, g, kdtree=False)
    ddir = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    assert Ts.shape == (2, 4, 4, 4) and Ts.is_contiguous()
    for b in range(2):
        for l in range(4):
            want = se3.se3_exp(0.1 * 0.5**l * ddir[b]) @ T[b]
            np.testing.assert_allclose(Ts[b, l].numpy(), want.numpy(), atol=1e-6)


def test_ndt_imu_case_builds_the_imu_presets_target():
    """ndt_imu_case: both scans through the imu preset's prefilter at
    IMU_CLOUD_CAPACITY rows, the first as the preset's NDT target (10 m
    cells, DIRECT7, the dense grid)."""
    from hdl_graph_slam_tpu_torch.core.config import PRESETS
    from hdl_graph_slam_tpu_torch.registration import ndt

    rng = np.random.default_rng(6)
    scans = [rng.uniform(-30, 30, (5000, 3)).astype(np.float32) * np.float32([1, 1, 0.1]) for _ in range(2)]
    tgt, src, res, method = chip_smoke.ndt_imu_case(scans, device="cpu")
    reg = PRESETS["imu"]().odometry.registration
    assert (res, method) == (reg.reg_resolution, reg.reg_nn_search_method) == (10.0, "DIRECT7")
    assert isinstance(tgt, ndt.NdtTarget) and tgt.grid is not None and tgt.voxels.resolution == 10.0
    assert src.capacity == chip_smoke.IMU_CLOUD_CAPACITY and 0 < int(src.mask.sum()) <= 5000


def test_stage_clock_wraps_and_restores():
    class Owner:
        def work(self, x):
            return 2 * x

    clock = chip_smoke.StageClock()
    clock.wrap(Owner, "work", "w", keep_result=True)
    assert Owner().work(3) == 6 and Owner().work(4) == 8
    assert clock.counts["w"] == 2 and clock.totals["w"] >= 0.0
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


def test_check_radius_gates_the_tested_tiles(monkeypatch):
    """check_radius records the tile pairs radius_count tested and fails
    when they are not the ones radius_tile_plan names."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    q, t, rows = clouds(7, n=300, m=900)
    row = chip_smoke.check_radius(knn, q, t, 12.0, rows, "uniform")
    plan = knn.radius_tile_plan(q, t, 12.0)
    assert (row["tile_pairs"], row["tiles_full"], row["tiles_point"]) == (plan.numel(), int((plan == 2).sum()),
                                                                          int((plan == 1).sum()))
    assert row["repeat_identical"] and row["stats_call_identical"] and 0.0 < row["tested_share"] < 1.0
    assert row["own_boxes_identical"]
    tiles = knn.radius_count_tiles
    monkeypatch.setattr(knn, "radius_count_tiles", lambda *a, **k: dict(tiles(*a, **k), full=0))
    with pytest.raises(RuntimeError, match="tested tile pairs"):
        chip_smoke.check_radius(knn, q, t, 12.0, rows, "broken")


@pytest.mark.parametrize("broken", ["counts", "tiles"])
def test_check_radius_gates_the_lanes_own_boxes(monkeypatch, broken):
    """check_radius fails when the launch whose lanes compute their tiles'
    boxes themselves (the kernel's fallback path) counts otherwise or tests
    other tile pairs than the launch that reads the table."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    q, t, rows = clouds(9, n=300, m=900)
    tiles = knn.radius_count_tiles

    def own_broken(*a, own_boxes=False):
        got = tiles(*a)
        if own_boxes:
            got = dict(got, counts=got["counts"] + 1) if broken == "counts" else dict(got, point=got["point"] + 1)
        return got

    monkeypatch.setattr(knn, "radius_count_tiles", own_broken)
    with pytest.raises(RuntimeError, match="own boxes"):
        chip_smoke.check_radius(knn, q, t, 12.0, rows, "broken")


def test_radius_bounds_count_valid_and_tested_pairs():
    """The pairs tested (32 x 32 a full tile pair, 32 a point test) or the
    bytes bound the kernel; the valid pairs' operations give the figure
    beside it, which tile skipping takes the kernel under."""
    row = dict(n=4096, m=4096, valid=3572, tiles_full=442, tiles_point=2400)
    b = chip_smoke.radius_bounds(row, 66.9e12)
    assert b["valid_pairs"] == 3572**2 and b["tested_pairs"] == 442 * 1024 + 2400 * 32
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(b["tested_pairs"] * 10 / 66.9e12 * 1e3)
    assert b["valid_pairs_bound_by"] == "operations" and b["valid_pairs_bound_ms"] == pytest.approx(
        3572**2 * 10 / 66.9e12 * 1e3)
    assert b["bound_ms"] < b["valid_pairs_bound_ms"]
    tiny = chip_smoke.radius_bounds(dict(row, tiles_full=0, tiles_point=0), 66.9e12)
    assert tiny["bound_by"] == "bytes" and tiny["bound_ms"] == pytest.approx(
        4096 * 28 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_radius_frame_is_the_presets_downsampled_cloud():
    """radius_frame hands radius_count what the preset's RADIUS filter
    does: its prefilter's cloud before the outlier removal, padded at
    PAD_COORD, and the preset's radius; the full prefilter keeps a subset."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.core.config import PRESETS
    from hdl_graph_slam_tpu_torch.frontend import Prefilter

    scan = chip_smoke._golden_scan(chip_smoke.RADIUS_FRAME)
    for preset, radius in zip(chip_smoke.RADIUS_PRESETS, (0.8, 0.5)):
        x, rows, r = chip_smoke.radius_frame(scan, preset, device="cpu")
        assert x.shape == (16384, 3) and r == radius and (x[~rows] == cloudlib.PAD_COORD).all()
        kept = Prefilter(PRESETS[preset]().prefilter, out_capacity=16384, device="cpu")(
            cloudlib.from_numpy(scan, device="cpu")).mask
        assert torch.equal(kept & rows, kept) and 0.9 * int(rows.sum()) < int(kept.sum()) < int(rows.sum())


def test_check_ndt_search_passes_the_plain_association(monkeypatch):
    """check_ndt_search on the CPU (both sides the plain twin): no row
    differs, found pairs counted, and a broken association fails it."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.registration import ndt

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    tgt = ndt.preprocess_target(cloudlib.from_numpy(pts, capacity=4096, device="cpu"), 2.0, max_voxels=1024,
                                grid_size=32)
    src = cloudlib.from_numpy(pts[:1000] + 0.05, capacity=1024, device="cpu")
    row = chip_smoke.check_ndt_search(tgt, src, 2.0, "DIRECT7", "t")
    assert row["rows_differ"] == 0 and row["found_pairs"] > 0 and row["repeat_identical"]
    plain = ndt.associate_plain
    monkeypatch.setattr(ndt, "associate", lambda *a: (plain(*a)[0] + 1, plain(*a)[1]))
    with pytest.raises(RuntimeError, match="key-search"):
        chip_smoke.check_ndt_search(tgt, src, 2.0, "DIRECT7", "t")


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


def test_launch_counts_read_the_ndt_wrappers():
    """The NDT wrappers' counters appear as ndt_<name>, knn_select's k = 8
    as knn_select_k8; reset_launches zeroes them too."""
    from hdl_graph_slam_tpu_torch.registration import ndt

    ndt.associate_cells.launches, ndt.derivatives.launches, ndt.trial_scores.launches = 2, 3, 4
    knn.knn_select.launches_k = dict.fromkeys(knn.KNN_SELECT_KS, 0) | {8: 5}
    got = chip_smoke.read_launches(knn)
    assert (got["ndt_associate"], got["ndt_derivatives"], got["ndt_trial_scores"], got["knn_select_k8"]) == (2, 3, 4, 5)
    chip_smoke.reset_launches(knn)
    assert set(chip_smoke.read_launches(knn).values()) == {0}


def test_ndt_bounds_take_the_larger_of_bytes_and_operations():
    """The association moves bytes only: the mask of every row, the points
    of the valid rows, its grid reads and its (n, K) outputs. The
    derivatives read the found flags of valid rows, the indices of found
    pairs and each named cell's row once, and are bounded by bytes at the
    H100's rates (by operations at half its fp32 peak); the trial scores read their inputs once
    for all trials, only their operations scale with them."""
    peak, hbm = 66.9e12, chip_smoke.HBM_BYTES_PER_S
    w = dict(n=8192, valid=6744, K=7, grid_reads=47000, found_pairs=24503, cells_read=600)
    ms, by = chip_smoke.ndt_bounds("ndt_associate", w, peak)
    assert by == "bytes" and ms == pytest.approx(1e3 * (8192 + 12 * 6744 + 64 + 4 * 47000 + 5 * 8192 * 7) / hbm)
    ms, by = chip_smoke.ndt_bounds("ndt_derivatives", w, peak)
    reads = 8192 + 12 * 6744 + 6744 * 7 + 4 * 24503 + 48 * 600
    assert by == "bytes" and ms == pytest.approx(1e3 * (reads + 64 + 43 * 4) / hbm)
    # a found pair's 4-byte index outweighs its operations at these rates
    many = dict(w, found_pairs=500000)
    ops = 500000 * chip_smoke.NDT_DERIV_OPS_PER_PAIR + 6744 * chip_smoke.NDT_DERIV_OPS_PER_POINT
    assert chip_smoke.ndt_bounds("ndt_derivatives", many, peak)[1] == "bytes"
    assert chip_smoke.ndt_bounds("ndt_derivatives", many, peak / 2)[0] == pytest.approx(1e3 * ops / (peak / 2))
    assert chip_smoke.ndt_bounds("ndt_derivatives", many, peak / 2)[1] == "operations"
    one = chip_smoke.ndt_bounds("ndt_trial_scores", w, peak, trials=1)
    assert one[1] == "bytes" and one[0] == pytest.approx(1e3 * (reads + 64 + 4) / hbm)
    ten = chip_smoke.ndt_bounds("ndt_trial_scores", w, peak, trials=10)
    ops = 10 * (24503 * chip_smoke.NDT_SCORE_OPS_PER_PAIR + 6744 * chip_smoke.NDT_SCORE_OPS_PER_POINT)
    assert ten[1] == "operations" and ten[0] == pytest.approx(1e3 * ops / peak)


def test_fit_plane_bounds_count_the_product_and_the_function():
    """The (n, 3) x (3, k) product writes its n x k field and is bound by
    bytes at the H100's rates; the whole RANSAC scoring needs no field, so
    its operations bound it."""
    peak, hbm = 66.9e12, chip_smoke.HBM_BYTES_PER_S
    b = chip_smoke.fit_plane_bounds(4096, 1024, peak)
    assert b["product"][1] == "bytes"
    assert b["product"][0] == pytest.approx(1e3 * 4 * (3 * 4096 + 3 * 1024 + 4096 * 1024) / hbm)
    assert b["function"][1] == "operations"
    assert b["function"][0] == pytest.approx(1e3 * chip_smoke.FIT_PLANE_OPS_PER_PAIR * 4096 * 1024 / peak)
    assert b["function"][0] < b["product"][0]


def test_ndt_work_counts_what_the_data_needs():
    """ndt_work on the plain association: valid rows, found pairs of valid
    rows and the distinct cells they name as counted directly; the grid
    reads those of valid rows' DIRECT7 neighbour cells inside the dense
    grid (counted here in numpy). A padded row and a point moved past the
    grid add no grid read."""
    from hdl_graph_slam_tpu_torch.core import cloud as cloudlib
    from hdl_graph_slam_tpu_torch.registration import ndt

    rng = np.random.default_rng(3)
    tgt_pts = rng.uniform(0.0, 12.0, (600, 3)).astype(np.float32)
    tgt = ndt.preprocess_target(cloudlib.from_numpy(tgt_pts, capacity=1024, device="cpu"), 2.0, max_voxels=256,
                                grid_size=8)
    xyz = np.concatenate([tgt_pts[:200] + rng.normal(0.0, 0.05, (200, 3)).astype(np.float32),
                          [[200.0, 5.0, 5.0]], [[1.0e6, 1.0e6, 1.0e6]]]).astype(np.float32)
    mask = np.arange(len(xyz)) < len(xyz) - 1
    xyz_t, mask_t, T = torch.from_numpy(xyz)[None], torch.from_numpy(mask)[None], torch.eye(4)[None]
    idx, found = ndt.associate(tgt, xyz_t, mask_t, T, "DIRECT7")
    w = chip_smoke.ndt_work(tgt, xyz_t, mask_t, T, idx, found, "DIRECT7")
    pairs = (found & mask_t[..., None])[0]
    offsets = ndt.voxelops.neighbor_offsets("DIRECT7").numpy()
    cells = np.floor(xyz[mask] / np.float32(2.0)).astype(np.int64) - tgt.voxels.origin.numpy()
    nb = cells[:, None, :] + offsets[None]
    assert w == dict(n=len(xyz), valid=int(mask.sum()), K=7, grid_reads=int(((nb >= 0) & (nb < 8)).all(-1).sum()),
                     found_pairs=int(pairs.sum()), cells_read=len(np.unique(idx[0][pairs].numpy())))
    assert 0 < w["found_pairs"] <= w["grid_reads"] < 7 * w["valid"]


def test_near_faces_flags_points_on_cell_faces():
    """A point whose transformed coordinate sits on a multiple of the
    resolution is near a face on that axis; one half a cell off is not."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.25, 0.0, 0.0]
    xyz = np.array([[3.75, 1.0, 1.0], [4.75, 1.0, 1.0], [1.0, 1.0, 1.0]], np.float32)
    u, near = chip_smoke.near_faces(xyz, pose, 2.0)
    np.testing.assert_allclose(u[:, 0], [2.0, 2.5, 0.625])
    assert near[:, 0].tolist() == [True, False, False] and not near[:, 1:].any()


def test_golden_town_imu_messages_follow_the_truth():
    """golden_town_imu: stamps i - 0.05, w >= 0 quaternions of each truth
    rotation, the gravity specific force R^T (0, 0, g), and body rates
    whose 1 s exponential carries each rotation to the next."""
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.frontend.imu_prediction import so3_exp
    from hdl_graph_slam_tpu_torch.utils import course

    truth = course.golden_town_sensor_poses()[:60]
    msgs = course.golden_town_imu(truth)
    assert [m[0] for m in msgs] == [i - 0.05 for i in range(60)]
    for i, (_, q, acc, w) in enumerate(msgs):
        R = truth[i][:3, :3]
        np.testing.assert_allclose(se3.mat_from_quat(torch.from_numpy(q)).numpy(), R, atol=1e-12)
        assert q[0] >= 0.0
        np.testing.assert_allclose(acc, R.T @ [0.0, 0.0, course.GRAVITY], atol=1e-12)
        if i:
            np.testing.assert_allclose(truth[i - 1][:3, :3] @ so3_exp(w), R, atol=1e-9)
    assert max(np.linalg.norm(m[3]) for m in msgs) > 0.01  # the course turns


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


# -- the cli and persistence phases' helpers ------------------------------------------


def test_kitti_writer_reads_back_through_the_cli_reader(tmp_path):
    """write_kitti_sequence: float32 (N, 4) bins, the stamps float(i) in
    times.txt and the truth as a KITTI poses file read back exactly."""
    from hdl_graph_slam_tpu_torch.io import kitti
    from hdl_graph_slam_tpu_torch.pipeline import frames_from_kitti

    rng = np.random.default_rng(70)
    scans = [rng.uniform(-50, 50, (n, 3)).astype(np.float32) for n in (100, 37, 250)]
    truth = [np.eye(4) for _ in scans]
    for i, T in enumerate(truth):
        T[:3, 3] = rng.normal(size=3)
    seq, poses = chip_smoke.write_kitti_sequence(scans, truth, str(tmp_path))
    frames = list(frames_from_kitti(seq))
    assert [s for s, _, _ in frames] == [0.0, 1.0, 2.0]
    for (_, xyz, refl), scan in zip(frames, scans):
        np.testing.assert_array_equal(xyz, scan)
        assert not refl.any()
    np.testing.assert_array_equal(kitti.read_poses(poses), np.stack(truth))


def test_voxel_cells_of_map_centres():
    """Centres from the map's voxel pass map back to their cells, within
    half an ulp of the coordinate; a point off its centre is flagged."""
    from hdl_graph_slam_tpu_torch.core import cloud
    from hdl_graph_slam_tpu_torch.ops import voxel

    rng = np.random.default_rng(71)
    xyz = rng.uniform(-80, 80, (2000, 3)).astype(np.float32)
    out = voxel.occupied_voxel_centers(cloud.from_numpy(xyz, capacity=2048, device="cpu"), 0.05, max_voxels=2048)
    centres = out.to_numpy()
    cells, ulps = chip_smoke.voxel_cells(centres, 0.05)
    assert ulps <= 0.5
    np.testing.assert_array_equal(chip_smoke.cell_keys(cells),
                                  voxel.voxel_keys(out.xyz, out.mask, 0.05)[out.mask].numpy())
    assert chip_smoke.voxel_cells(centres + np.float32(0.01), 0.05)[1] > 2.0


def test_face_rule_explains_rounding_and_nothing_else():
    """Points moved across a voxel face by float32 rounding change only
    voxels face_voxels lists; a point moved by a voxel does not."""
    from hdl_graph_slam_tpu_torch.backend import KeyFrameSnapshot
    from hdl_graph_slam_tpu_torch.backend.map_cloud import MapCloudGenerator
    from hdl_graph_slam_tpu_torch.core import cloud

    rng = np.random.default_rng(72)
    res = float(np.float32(0.05))
    cells = rng.integers(-400, 400, (3000, 3))
    xyz = ((cells + rng.uniform(0.1, 0.9, (3000, 3))) * res).astype(np.float32)
    xyz[:20, 0] = (cells[:20, 0] * res).astype(np.float32)  # 20 points on a face
    snap = [KeyFrameSnapshot(pose=np.eye(4), cloud=cloud.from_numpy(xyz, capacity=4096, device="cpu"))]
    ambiguous, near, total = chip_smoke.face_voxels(snap, 0.05)
    assert total == 3000 and near >= 20
    base = MapCloudGenerator().generate(snap, 0.05)
    nudged = xyz.copy()
    nudged[:20, 0] = np.nextafter(nudged[:20, 0], np.float32(-np.inf))  # an ulp across the face
    moved = MapCloudGenerator().generate([KeyFrameSnapshot(pose=np.eye(4), cloud=cloud.from_numpy(
        nudged, capacity=4096, device="cpu"))], 0.05)
    cmp = chip_smoke.compare_maps(base, moved, ambiguous, 0.05)
    assert cmp["differ"] > 0 and cmp["unexplained"] == 0 and not cmp["capped"]
    far = xyz.copy()
    far[25, 0] += np.float32(3 * res)
    jumped = MapCloudGenerator().generate([KeyFrameSnapshot(pose=np.eye(4), cloud=cloud.from_numpy(
        far, capacity=4096, device="cpu"))], 0.05)
    assert chip_smoke.compare_maps(base, jumped, ambiguous, 0.05)["unexplained"] > 0


def test_compare_maps_leaves_out_the_cut_of_capped_maps(monkeypatch):
    """Two maps at the voxel cap keep the lowest keys of their occupied
    sets: a voxel one set lacks (here on a face) moves the other's cut up
    by one, and that cut is not a difference; below the lower of the two
    largest keys every difference counts."""
    monkeypatch.setattr(chip_smoke, "MAP_MAX_POINTS", 4)
    res = float(np.float32(0.05))

    def voxels(*cells):
        return np.array([[(i + 0.5) * res, 0.5 * res, 0.5 * res] for i in cells], np.float32)

    face = chip_smoke.cell_keys(np.array([[2, 0, 0]]))
    a, b = voxels(0, 1, 2, 3), voxels(0, 1, 3, 4)  # b's occupied set lacks voxel 2
    assert chip_smoke.compare_maps(a, b, face, 0.05) == dict(voxels=[4, 4], capped=True, differ=1, unexplained=0)
    assert chip_smoke.compare_maps(a, b, np.zeros(0, np.int64), 0.05)["unexplained"] == 1
    assert chip_smoke.compare_maps(a, voxels(0, 1, 2, 4), face, 0.05)["unexplained"] == 1


def test_cli_child_runs_the_module_and_hands_back_launches(tmp_path):
    """The cli phase's child process runs hdl_graph_slam_tpu_torch.run as
    ``python -m`` does and writes the launch counts even when the CLI exits
    (here on --help)."""
    path = str(tmp_path / "launches.json")
    proc = subprocess.run([sys.executable, "-c", chip_smoke.CLI_CHILD, path, "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and "--kitti" in proc.stdout and "--device" in proc.stdout
    import json

    with open(path) as f:
        launches = chip_smoke.format_launches(**json.load(f))
    assert set(launches) >= set(chip_smoke.CLI_REQUIRED) and set(launches.values()) == {0}


def test_compare_g2o_allows_only_quaternion_last_digits(tmp_path):
    """A load and re-save of 400 random poses (seed 73) moves some
    quaternion components by one in their last digit, in the JAX package
    exactly as in the port (the same re-saved text); compare_g2o counts
    those and nothing else, and flags any other token."""
    from scipy.spatial.transform import Rotation

    from hdl_graph_slam_tpu.graph import io as jgio
    from hdl_graph_slam_tpu_torch.graph import io as gio
    from hdl_graph_slam_tpu_torch.graph import types

    rng = np.random.default_rng(73)
    g = types.GraphBuilder()
    for i in range(400):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 1, 3)).as_matrix()
        T[:3, 3] = rng.normal(0, 50, 3)
        g.add_se3_node(T)
        if i:
            g.add_se3_edge(i - 1, i, np.linalg.inv(g.poses[i - 1]) @ T, np.eye(6))
    first, port, jax_ = (str(tmp_path / f) for f in ("first.g2o", "port.g2o", "jax.g2o"))
    gio.save_g2o(g, first)
    gio.save_g2o(gio.load_g2o(first), port)
    jgio.save_g2o(jgio.load_g2o(first), jax_)
    assert open(port).read() == open(jax_).read()
    cmp = chip_smoke.compare_g2o(first, port)
    assert cmp["lines"] == 799 and cmp["other_tokens_differ"] == 0
    assert 0 < cmp["quaternion_values_differ"] and cmp["quaternion_max_abs_err"] <= chip_smoke.QUAT_REDUMP_ATOL
    lines = open(port).read().splitlines()
    lines[3] = lines[3].replace(lines[3].split()[2], "1.5", 1)  # a translation
    with open(port, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert chip_smoke.compare_g2o(first, port)["other_tokens_differ"] == 1


def test_graph_solver_cases_solve_on_cpu():
    """The graph phase's solver cases on the CPU: chain_graph (20 poses,
    the first fixed, a free floor plane) where PCG and Schur reach the dense
    optimum within 1e-5; synthetic_graph(floor=True) adds the floor plane
    as a landmark with an se3_plane edge from every pose."""
    from hdl_graph_slam_tpu_torch.graph import optimize

    g = chip_smoke.chain_graph()
    assert len(g.planes) == 1 and len(g.poses) == 20
    dense, _ = optimize(g.freeze(dtype=torch.float64, device="cpu"), max_iterations=60)
    for solver in ("pcg", "schur"):
        out, st = optimize(g.freeze(dtype=torch.float64, device="cpu"), max_iterations=60, linear_solver=solver)
        np.testing.assert_allclose(out.poses.numpy(), dense.poses.numpy(), atol=chip_smoke.GRAPH_SOLVER_VS_DENSE_M)
        assert float(st.chi2_robust_after) < float(st.chi2_robust_before)
    ring, floor = chip_smoke.synthetic_graph(0), chip_smoke.synthetic_graph(0, floor=True)
    assert len(floor.planes) == 1 and len(floor.poses) == len(ring.poses)
    assert floor.num_edges == ring.num_edges + len(ring.poses) - 1  # the anchor node sees no floor


# -- the parallel phase's helpers ---------------------------------------------------------


def _anchored_backend(adaptive=True):
    """A stand-in for a loaded HdlGraphSlam: keyframe 0 (node 0), the fixed
    anchor (node 1), keyframes 1 and 2 (nodes 2 and 3) at stamps 0, 3 and
    6, estimates 1.8 m above their odometry."""
    import types

    from hdl_graph_slam_tpu_torch.graph import GraphBuilder

    g = GraphBuilder()
    odoms, est = [], []
    for k in range(3):
        odom = np.eye(4)
        odom[:3, 3] = [2.0 * k, 0.1 * k, 0.0]
        odoms.append(odom)
        est.append(odom.copy())
        est[-1][2, 3] = 1.8
    nodes = [g.add_se3_node(est[0]), g.add_se3_node(np.eye(4), fixed=True), g.add_se3_node(est[1]),
             g.add_se3_node(est[2])]
    kfs = [types.SimpleNamespace(node_id=n, odom=o, stamp=float(3 * k))
           for k, (n, o) in enumerate(zip((nodes[0], nodes[2], nodes[3]), odoms))]
    backend = types.SimpleNamespace(fix_first_node_adaptive=adaptive)
    return types.SimpleNamespace(graph=g, keyframes=kfs, anchor_node_id=nodes[1], anchor_edge_first_kf=nodes[0],
                                 cfg=types.SimpleNamespace(backend=backend)), est


@pytest.mark.parametrize("adaptive", [True, False])
def test_odometry_chain_resets_keyframes_and_the_anchor(adaptive):
    slam, est = _anchored_backend(adaptive)
    chain = chip_smoke.odometry_chain(slam)
    for kf in slam.keyframes:
        np.testing.assert_array_equal(chain.poses[kf.node_id], kf.odom)
    # the anchor sits where the backend puts it before its first solve
    np.testing.assert_array_equal(chain.poses[1], slam.keyframes[0].odom if adaptive else np.eye(4))
    np.testing.assert_array_equal(slam.graph.poses[0], est[0])  # the backend's own graph is untouched
    assert chain.pose_fixed == slam.graph.pose_fixed


def test_keyframe_ate_aligns_and_measures():
    """Keyframe poses on the truth read 0; moved rigidly they still read 0
    (Umeyama alignment); one keyframe 0.3 m off reads the RMSE of that."""
    slam, _ = _anchored_backend()
    truth = [np.eye(4) for _ in range(7)]
    for i, T in enumerate(truth):
        T[:3, 3] = [2.0 * i / 3.0, 0.1 * i / 3.0 + 0.02 * (i % 2), 0.0]
    chain = chip_smoke.odometry_chain(slam)
    for kf in slam.keyframes:
        chain.poses[kf.node_id] = truth[int(kf.stamp)].copy()
    assert chip_smoke.keyframe_ate(chain, slam.keyframes, truth) < 1e-9
    shift = np.eye(4)
    shift[:3, 3] = [5.0, -3.0, 1.8]
    for kf in slam.keyframes:
        chain.poses[kf.node_id] = shift @ chain.poses[kf.node_id]
    assert chip_smoke.keyframe_ate(chain, slam.keyframes, truth) < 1e-9
    chain.poses[slam.keyframes[1].node_id][2, 3] += 0.3
    assert 0.05 < chip_smoke.keyframe_ate(chain, slam.keyframes, truth) < 0.3


def test_run_ranks_stops_failed_and_hung_ranks(tmp_path, monkeypatch):
    """A rank that fails (a backend torch.distributed does not know) raises
    with its log; ranks still running at the timeout are killed and raise.
    The ranks' success path is tests/test_torch_multiprocess.py."""
    from hdl_graph_slam_tpu_torch import state

    arrays = state.graph_data_to_numpy(chip_smoke.chain_graph().freeze(device="cpu"))
    with pytest.raises(RuntimeError, match="rank 0 of 1"):
        chip_smoke.run_ranks(arrays, str(tmp_path / "bad"), world=1, device="cpu", backend="no_such_backend",
                             iterations=2, timeout_s=120)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_CHILD", "import time\ntime.sleep(60)\n")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="killed at the timeout"):
        chip_smoke.run_ranks(arrays, str(tmp_path / "hung"), world=2, device="cpu", backend="gloo", iterations=2,
                             timeout_s=1.0)
    assert time.perf_counter() - t0 < 30


def test_launch_counts_read_the_gicp_wrappers():
    """The GICP wrappers' counters (one a form of gicp_step_kernel) appear
    under chip_smoke.GICP_COUNTERS' names (the CLI child hands them back
    too; the ungated forms are the CLI's required ones); reset_launches
    zeroes them; require_gicp_launches holds a path to 1 + 2 x its LM
    iterations GICP launches a frame."""
    from hdl_graph_slam_tpu_torch.registration import gicp

    gicp.associate.launches, gicp.linearize.launches, gicp.cost.launches = 2, 3, 4
    gicp.associate_linearize.launches = 5
    got = chip_smoke.read_launches(knn)
    assert (got["gicp_associate"], got["gicp_linearize"], got["gicp_cost"], got["gicp_associate_linearize"]) == (
        2, 3, 4, 5)
    assert set(chip_smoke.GICP_UNGATED) <= set(chip_smoke.CLI_REQUIRED)
    assert set(chip_smoke.GICP_GATED) | set(chip_smoke.GICP_UNGATED) <= set(chip_smoke.GICP_COUNTERS)
    chip_smoke.require_gicp_launches("t", got, 2, 3.0)  # 7 a frame at 3 iterations
    with pytest.raises(RuntimeError, match="GICP launches a frame"):
        chip_smoke.require_gicp_launches("t", got, 2, 2.0)
    chip_smoke.reset_launches(knn)
    assert set(chip_smoke.read_launches(knn).values()) == {0}


def test_gicp_bounds_take_the_larger_of_bytes_and_operations():
    """The association reads each row's covariance, index and gate inputs
    and each named target row once and writes each row's Mw; the
    linearization reads every row's Mw (its gate) and the point, index and
    named target point of valid rows. Both move bytes at the H100's rates;
    at a thousandth of its fp32 peak their operations bound them."""
    peak, hbm = 66.9e12, chip_smoke.HBM_BYTES_PER_S
    w = dict(batch=1, rows=8192, valid=6373, named=5387, named_valid=5139)
    ms, by = chip_smoke.gicp_bounds("gicp_associate", w, peak)
    assert by == "bytes" and ms == pytest.approx(1e3 * (68 + 8192 * 81 + 5387 * 37) / hbm)
    ms, by = chip_smoke.gicp_bounds("gicp_associate", w, peak, found_gate=True)
    assert by == "bytes" and ms == pytest.approx(1e3 * (68 + 8192 * 77 + 5387 * 36) / hbm)
    reads = 36 * 8192 + 16 * 6373 + 12 * 5139
    ms, by = chip_smoke.gicp_bounds("gicp_linearize", w, peak)
    assert by == "bytes" and ms == pytest.approx(1e3 * (64 + 43 * 4 + reads) / hbm)
    assert chip_smoke.gicp_bounds("gicp_cost", w, peak)[0] == pytest.approx(1e3 * (64 + 4 + reads) / hbm)
    # the fused form: the association's bytes, the valid rows' points and named target points, the rows out
    ms, by = chip_smoke.gicp_bounds("gicp_associate_linearize", w, peak)
    assert by == "bytes" and ms == pytest.approx(1e3 * (68 + 8192 * 81 + 5387 * 37 + 43 * 4 + 12 * 6373
                                                        + 12 * 5139) / hbm)
    slow = peak / 1000
    ms, by = chip_smoke.gicp_bounds("gicp_linearize", w, slow)
    assert by == "operations" and ms == pytest.approx(1e3 * 6373 * chip_smoke.GICP_LIN_OPS_PER_ROW / slow)
    ms, by = chip_smoke.gicp_bounds("gicp_associate", w, slow)
    assert by == "operations" and ms == pytest.approx(1e3 * 8192 * chip_smoke.GICP_ASSOC_OPS_PER_ROW / slow)
    ms, by = chip_smoke.gicp_bounds("gicp_associate_linearize", w, slow)
    assert by == "operations" and ms == pytest.approx(1e3 * (8192 * chip_smoke.GICP_ASSOC_OPS_PER_ROW
                                                             + 6373 * chip_smoke.GICP_LIN_OPS_PER_ROW) / slow)


def gicp_problems(B=2, n=600):
    """B sources (points on two planes, a padded tail) against one target,
    GICP-preprocessed on the CPU, at poses near the identity, with one
    search's idx and d2."""
    from hdl_graph_slam_tpu_torch.core import se3
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.registration import gicp

    rng = np.random.default_rng(17)

    def cloud(n_pad):
        u = rng.uniform(-5.0, 5.0, (n, 2))
        wall = rng.random(n) < 0.5
        xyz = np.where(wall[:, None], np.stack([u[:, 0], np.full(n, 4.0), u[:, 1] + 5.0], 1),
                       np.stack([u[:, 0], u[:, 1], np.zeros(n)], 1)) + rng.normal(0.0, 0.02, (n, 3))
        xyz[n - n_pad:] = 1.0e6
        return PointCloud(xyz=torch.from_numpy(xyz.astype(np.float32)), mask=torch.arange(n) < n - n_pad)

    tgt = gicp.preprocess(cloud(40))
    src = gicp.preprocess(PointCloud(*[torch.stack(x) for x in zip(*[(c.xyz, c.mask) for c in
                                                                     (cloud(40 + 30 * b) for b in range(B))])]))
    T = se3.se3_exp(torch.from_numpy(rng.normal(0.0, 0.05, (B, 6)).astype(np.float32)))
    idx, d2 = gicp._correspond(T, src, tgt)
    return gicp, tgt, src, T, idx, d2


def test_check_gicp_gates_the_kernels_against_the_plain_twins(monkeypatch):
    """check_gicp passes wrappers that compute the plain twins' function
    with batch-invariant rows (the kernels' property; here a per-problem
    plain call stands in for every linearization, since the plain einsum's
    b is not), for both gates, and fails a linearization off by 1e-3 of its
    largest entry, a fused call that differs from associate then linearize,
    and rows that depend on the batch."""
    gicp, tgt, src, T, idx, d2 = gicp_problems()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    plain, plain_cost = gicp.linearize_plain, gicp.cost_plain

    def rows_of(fn):
        def per_problem(T, corr, src, tgt_xyz):
            if T.ndim == 2:
                return fn(T, corr, src, tgt_xyz)
            rows = [fn(T[b], gicp.GicpCorr(*[x[b] for x in corr]), gicp.GicpCloud(src.xyz[b], src.mask[b],
                                                                                   src.covs[b]), tgt_xyz)
                    for b in range(T.shape[0])]
            return tuple(torch.stack(x) for x in zip(*rows)) if isinstance(rows[0], tuple) else torch.stack(rows)

        return per_problem

    per_problem = rows_of(plain)
    monkeypatch.setattr(gicp, "linearize_plain", per_problem)  # the fused twin's and the prepared call's too
    monkeypatch.setattr(gicp, "linearize", per_problem)
    monkeypatch.setattr(gicp, "cost_plain", rows_of(plain_cost))
    gate = gicp.DistanceGate(d2, tgt.mask, chip_smoke.GICP_MAX_CORR_M)
    row, corr = chip_smoke.check_gicp("t", T, src, tgt.covs, tgt.xyz, idx, gate)
    assert row["Mw_identical"] and row["single_identical"] and row["repeat_identical"] and row["cost_only_identical"]
    assert row["fused_identical"] and row["prepared_identical"] and row["trial_identical"]
    assert row["valid"] == corr.num.tolist() and min(row["valid"]) > 400
    assert max(row["H_err"], row["b_err"], row["cost_err"]) < 1e-5 and len(row["plain_f64_err"]) == 3
    row, _ = chip_smoke.check_gicp("t", T, src, tgt.covs, tgt.xyz, idx, d2 < 0.01)
    assert row["gate"] == "found" and row["valid"] == (d2 < 0.01).sum(-1).tolist()

    def off(T, corr, src, tgt_xyz):  # in float32, as the kernel's forms; the float64 reference as it is
        H, b, c, n = per_problem(T, corr, src, tgt_xyz)
        if T.dtype == torch.float32:
            H = H + 1e-3 * H.abs().amax((-1, -2), keepdim=True)
        return H, b, c, n

    monkeypatch.setattr(gicp, "linearize_plain", off)
    monkeypatch.setattr(gicp, "linearize", off)
    with pytest.raises(RuntimeError, match="linearization"):
        chip_smoke.check_gicp("t", T, src, tgt.covs, tgt.xyz, idx, gate)
    monkeypatch.setattr(gicp, "linearize_plain", per_problem)
    with pytest.raises(RuntimeError, match="fused call"):
        chip_smoke.check_gicp("t", T, src, tgt.covs, tgt.xyz, idx, gate)
    monkeypatch.setattr(gicp, "linearize_plain", plain)  # b's rows depend on the batch on the CPU
    monkeypatch.setattr(gicp, "linearize", plain)
    monkeypatch.setattr(gicp, "cost_plain", plain_cost)
    with pytest.raises(RuntimeError, match="single call"):
        chip_smoke.check_gicp("t", T, src, tgt.covs, tgt.xyz, idx, gate)


def test_gicp_work_counts_valid_and_named_rows():
    """gicp_work on a plain association: the valid rows are those with a
    nonzero Mw (num), the named rows the distinct target indices per
    problem, all rows' and the valid rows'."""
    gicp, tgt, src, T, idx, d2 = gicp_problems()
    corr = gicp.associate_plain(T, src, tgt.covs, idx, gicp.DistanceGate(d2, tgt.mask, 1.0))
    w = chip_smoke.gicp_work(corr, 2)
    valid = src.mask & tgt.mask[idx] & (d2 < 1.0)
    assert w == dict(batch=2, rows=1200, valid=int(corr.num.sum()),
                     named=sum(len(np.unique(i)) for i in idx.numpy()),
                     named_valid=sum(len(np.unique(i[v])) for i, v in zip(idx.numpy(), valid.numpy())))
    assert w["valid"] == int(valid.sum())
