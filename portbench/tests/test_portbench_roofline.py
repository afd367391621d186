"""The roofline yardstick and the metric arithmetic, on synthetic numbers."""

import pytest
import torch

from portbench import harness, readers, roofline, trace


def test_search_bound_is_bytes_once_not_pairs():
    # linear in the rows: a brute-force scan's n * m pair tests are in no bound
    a = roofline.search_bytes(32768, 32768, 20)
    assert roofline.search_bytes(65536, 65536, 20) == 2 * a
    assert a == 12 * 32768 * 2 + 8 * 32768 * 20
    assert roofline.radius_count_bytes(1000, 1000) == 12 * 2000 + 4 * 1000
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)


def test_gicp_work_counts_rows_and_valid_rows():
    w = dict(batch=1, rows=100, valid=60, named=50, named_valid=40)
    nbytes, ops = roofline.gicp_step_work(roofline.ASSOCIATE, w)
    assert nbytes == 68 + 100 * 81 + 50 * 37 and ops == 100 * 155
    nbytes, ops = roofline.gicp_step_work(roofline.FUSED, w)
    assert nbytes == 68 + 100 * 81 + 50 * 37 + 172 + 12 * 60 + 12 * 40 and ops == 100 * 155 + 60 * 142
    nbytes, ops = roofline.gicp_step_work(roofline.COST, w)
    assert nbytes == 68 + 3600 + 960 + 480 and ops == 60 * 46
    nbytes, ops = roofline.gicp_step_work(roofline.LINEARIZE, w, found_gate=True)
    assert nbytes == 64 + 172 + 3600 + 960 + 480 and ops == 60 * 142


def test_padded_rows_do_not_change_the_bounds():
    # the search and radius bounds count the rows that hold points, not the
    # capacity the program pads its clouds to
    from hdl_graph_slam_tpu_torch.ops import knn

    pts = torch.rand(300, 3, generator=torch.Generator().manual_seed(0)) * 10.0

    def bounds(pad):
        cloud = torch.cat([pts, torch.full((pad, 3), 1.0e6)]) if pad else pts
        rec = trace.Launches(device_types=("cpu",)).install()
        try:
            knn.nn1(cloud, cloud)
            knn.knn_select(cloud, cloud, 10)
            knn.radius_count(cloud, cloud, 0.5)
        finally:
            rec.restore()
        rec.finish()
        return dict(rec.calls), dict(rec.bound_s)

    calls, bound = bounds(0)
    assert calls == {"search": 2, "radius_count": 1}
    assert bound["search"] * roofline.HBM_BYTES_PER_S == pytest.approx(
        roofline.search_bytes(300, 300, 1) + roofline.search_bytes(300, 300, 10))
    assert bounds(212) == (calls, bound)


def _ctx(calls=10, kernel_calls=10):
    return {"profile": {"frames": 4, "wall_s": 2.0, "busy_s": 0.5, "device_ops": 400,
                        "groups": {"search": {"calls": kernel_calls, "seconds": 0.01},
                                   "gicp_step": {"calls": 0, "seconds": 0.0},
                                   "radius_count": {"calls": 4, "seconds": 0.002}},
                        "launch_calls": {"search": calls, "radius_count": 4},
                        "bound_s": {"search": 0.0001, "radius_count": 0.0004}},
            "syncs": {"count": 36, "frames": 4},
            "spans": {"window_s": 10.0, "frame": [0.1] * 19 + [0.3], "optimize_cycle": [1.0, 2.0],
                      "graph_optimize": [0.5, 1.5], "graph_iterations": [10, 30]}}


def test_metric_readers_on_synthetic_spans_and_events():
    ctx = _ctx()
    read = {name: harness.metric_reader(name)(ctx) for name in (
        "device_ops_per_frame.odom", "host_syncs_per_frame.odom", "frame_ms_p95", "backend_wall_share",
        "graph_ms_per_iteration", "search_roofline.odom", "radius_count_roofline.slam",
        "gicp_step_roofline.odom", "device_idle_share.slam")}
    assert read["device_ops_per_frame.odom"] == 100
    assert read["host_syncs_per_frame.odom"] == 9
    assert read["frame_ms_p95"] == pytest.approx(110.0)
    assert read["backend_wall_share"] == pytest.approx(0.3)
    assert read["graph_ms_per_iteration"] == pytest.approx(50.0)
    assert read["search_roofline.odom"] == pytest.approx(1.0)
    assert read["radius_count_roofline.slam"] == pytest.approx(20.0)
    assert read["gicp_step_roofline.odom"] is None  # nothing ran: no number, never 0
    assert read["device_idle_share.slam"] == pytest.approx(0.75)


def test_a_trace_that_lost_launches_reads_nothing():
    assert readers.kernel_roofline(_ctx(calls=10, kernel_calls=9), "search") is None
    assert readers.kernel_roofline({}, "search") is None
    assert readers.idle_share({}) is None
