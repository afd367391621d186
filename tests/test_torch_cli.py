"""The port's offline CLI (hdl_graph_slam_tpu_torch/run.py) and its backend
threads (run_windowed(overlap_backend=True), AsyncBackend), on the CPU.

The CLI runs in-process with ``--device cpu`` on tests/test_cli.py's
8-frame synthetic bag (tests/test_pipeline.py's room, a 4 m square at 1 m
steps, seeds 0-7) and on a 12-frame KITTI sequence of the same room at
10 Hz. The thread tests mirror tests/test_pipeline.py's with the same
tolerances.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu_torch import run as cli
from hdl_graph_slam_tpu_torch.backend import HdlGraphSlam
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import PRESETS, SlamConfig
from hdl_graph_slam_tpu_torch.io import pcd, trajectory
from hdl_graph_slam_tpu_torch.pipeline import AsyncBackend, SlamPipeline, frames_from_rosbag
from hdl_graph_slam_tpu_torch.utils.metrics import GLOBAL_TIMER, device_trace, tracing
from test_cli import write_bag
from test_pipeline import drive_square, make_world, scan_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY = 4096


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU pipelines: the tier-1 lane
    runs six workers on the machine's cores, where more threads a worker
    only contend (these tests took 8x longer with the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return make_world()


@pytest.fixture(scope="module")
def bag(world, tmp_path_factory):
    """tests/test_cli.py's synthetic bag: 8 frames, 0.5 s apart."""
    poses = drive_square(side=4.0, step=1.0)[:8]
    frames = [(float(i) * 0.5, scan_at(world, p, seed=i).astype(np.float32)) for i, p in enumerate(poses)]
    path = str(tmp_path_factory.mktemp("bag") / "synthetic.bag")
    write_bag(path, frames)
    return path


def run_cli(argv):
    """main(argv) in-process; its stdout JSON lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


BASE_ARGV = ["--preset", "base", "--cloud-capacity", str(CAPACITY), "--map-resolution", "0.5", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_run(bag, tmp_path_factory):
    """One CLI run over the bag with every output, the trajectory it hands
    to save_tum, and an in-process SlamPipeline.run() over the same frames."""
    tmp = tmp_path_factory.mktemp("cli")
    out = {k: str(tmp / k) for k in ("traj.txt", "odom.txt", "map.pcd", "dump", "graph.json", "trace.json")}
    handed = {}
    save_tum = trajectory.save_tum

    def recording_save_tum(path, traj):
        handed[path] = traj
        save_tum(path, traj)

    trajectory.save_tum = recording_save_tum
    try:
        (stats,) = run_cli(["--bag", bag] + BASE_ARGV + [
            "--out-traj", out["traj.txt"], "--out-odom-traj", out["odom.txt"], "--out-map", out["map.pcd"],
            "--dump", out["dump"], "--out-graph-json", out["graph.json"], "--trace", out["trace.json"]])
    finally:
        trajectory.save_tum = save_tum
    ref = SlamPipeline(PRESETS["base"](), cloud_capacity=CAPACITY, device="cpu").run(frames_from_rosbag(bag))
    return dict(stats=stats, out=out, traj=handed[out["traj.txt"]], odom=handed[out["odom.txt"]], ref=ref)


def test_cli_writes_every_output(cli_run):
    """The stats line and every output: TUM trajectories, the map PCD, the
    dump, the graph JSON and the stage trace."""
    stats, out = cli_run["stats"], cli_run["out"]
    assert stats["frames"] == 8 and stats["keyframes"] >= 2 and stats["edges"] >= 1
    trace = json.load(open(out["trace.json"]))
    spans = trace["spans"]
    assert {"frame", "ingest", "prefilter", "odometry", "optimize_cycle", "save_map", "dump"} <= set(spans)
    assert spans["odometry"]["count"] == spans["frame"]["count"] == 8
    assert all(0.0 <= v["self_s"] <= v["total_s"] for v in spans.values())
    assert trace["counters"]["lm_iterations"] > 0 and trace["dropped"] == 0
    graph = json.load(open(out["graph.json"]))
    assert len(graph["nodes"]) == stats["keyframes"] and graph["num_edges"] == stats["edges"]
    xyz, _ = pcd.load_pcd(out["map.pcd"])
    assert xyz.shape[0] > 100
    np.testing.assert_allclose(np.abs((xyz / np.float32(0.5)) % 1.0 - 0.5), 0.0, atol=1e-4)  # voxel centres
    assert os.path.exists(os.path.join(out["dump"], "000000", "cloud.pcd"))
    assert os.path.exists(os.path.join(out["dump"], "graph.g2o"))
    assert len(trajectory.load_tum(out["traj.txt"])) == stats["keyframes"]
    assert len(trajectory.load_tum(out["odom.txt"])) == 8


def test_cli_trajectory_is_the_pipelines_bit_for_bit(cli_run):
    """The trajectories the CLI writes are those of SlamPipeline.run() on the
    same frames, bit for bit."""
    for mine, ref in ((cli_run["traj"], cli_run["ref"].trajectory),
                      (cli_run["odom"], cli_run["ref"].odometry_trajectory)):
        assert [s for s, _ in mine] == [s for s, _ in ref]
        np.testing.assert_array_equal(np.stack([T for _, T in mine]), np.stack([T for _, T in ref]))


def test_cli_imu_preset_matches_the_jax_cli(bag, tmp_path):
    """``--preset imu`` (NDT_OMP odometry at 10 m cells, deskewing, GICP
    loops) through the port's CLI on the CPU and the JAX package's CLI on the
    same bag: the same keyframe and frame stamps, and every optimized and
    odometry pose within 1e-4 (float32 rounding of the chained aligns;
    measured 2e-6, the TUM files' 6-digit text)."""
    from hdl_graph_slam_tpu import run as jcli

    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = {k: str(tmp_path / f"{name}_{k}") for k in ("traj.txt", "odom.txt")}
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["--bag", bag, "--preset", "imu", "--cloud-capacity", str(CAPACITY), "--out-traj",
                         out["traj.txt"], "--out-odom-traj", out["odom.txt"]] + extra) == 0
        outs[name] = {k: trajectory.load_tum(v) for k, v in out.items()}
    for k in ("traj.txt", "odom.txt"):
        mine, ref = outs["port"][k], outs["jax"][k]
        assert [s for s, _ in mine] == [s for s, _ in ref] and len(mine) >= (2 if k == "traj.txt" else 8)
        np.testing.assert_allclose(np.stack([T for _, T in mine]), np.stack([T for _, T in ref]), atol=1e-4)


def test_cli_resumes_from_its_dump(bag, cli_run, tmp_path):
    """A second run that loads the dump and reads 3 more frames grows the
    graph and dumps more keyframes."""
    stats = cli_run["stats"]
    (resumed,) = run_cli(["--bag", bag] + BASE_ARGV + ["--load", cli_run["out"]["dump"], "--max-frames", "3",
                                                      "--dump", str(tmp_path / "dump2")])
    assert resumed["frames"] == 3
    assert resumed["edges"] > stats["edges"]
    assert len([d for d in os.listdir(tmp_path / "dump2") if d.isdigit()]) > stats["keyframes"]


def test_cli_kitti_ref_poses(world, tmp_path):
    """--ref-poses on a 12-frame KITTI sequence at 10 Hz (stamps i * 0.1,
    the reference stamps the CLI assumes) prints ate_rmse_m below 0.05 m."""
    seq = tmp_path / "00"
    (seq / "velodyne").mkdir(parents=True)
    poses = drive_square(side=4.0, step=0.5)[:12]
    for i, pose in enumerate(poses):
        xyz = scan_at(world, pose, seed=i)
        np.c_[xyz, np.zeros(len(xyz))].astype(np.float32).tofile(str(seq / "velodyne" / f"{i:06d}.bin"))
    np.savetxt(str(seq / "times.txt"), np.arange(12) * 0.1)
    ref = np.stack(poses)
    np.savetxt(str(tmp_path / "poses.txt"), ref[:, :3, :].reshape(-1, 12))
    lines = run_cli(["--kitti", str(seq), "--preset", "base", "--cloud-capacity", str(CAPACITY), "--device", "cpu",
                     "--ref-poses", str(tmp_path / "poses.txt")])
    assert lines[0]["frames"] == 12
    assert set(lines[1]) == {"ate_rmse_m", "rpe_trans_m", "rpe_rot_rad"}
    assert lines[1]["ate_rmse_m"] < 0.05


def test_cli_defaults_to_cuda_and_never_falls_back(bag, tmp_path):
    """Without --device the CLI runs on cuda; without a GPU it raises, in
    process and as ``python -m``, before reading a frame."""
    if torch.cuda.is_available():
        assert SlamPipeline().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--bag", bag])
    out = subprocess.run([sys.executable, "-m", "hdl_graph_slam_tpu_torch.run", "--bag", bag],
                         capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=""), timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr and not out.stdout
    # the imu preset (NDT odometry) runs when asked for the CPU and writes its outputs
    traj = tmp_path / "imu_traj.txt"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--bag", bag, "--preset", "imu", "--device", "cpu", "--max-frames", "3",
                         "--cloud-capacity", str(CAPACITY), "--out-traj", str(traj)]) == 0
    assert len(trajectory.load_tum(str(traj))) >= 1


def test_process_frame_spans(world):
    """With the tracer on, process_frame records its stages in GLOBAL_TIMER
    (module-global, so enabled for this run only: it is off by default)."""
    cfg = PRESETS["outdoor"]()
    pipe = SlamPipeline(cfg, cloud_capacity=2048, device="cpu")
    with tracing():
        for i in range(4):
            pose = np.eye(4)
            pose[0, 3] = 0.5 * i
            pipe.process_frame(2.0 * i, scan_at(world, pose, seed=i, n_keep=2000))
    counts = GLOBAL_TIMER.summary()["spans"]
    assert {k: counts[k]["count"] for k in ("frame", "ingest", "prefilter", "odometry", "floor")} == dict(
        frame=4, ingest=4, prefilter=4, odometry=4, floor=4)
    assert counts["optimize_cycle"]["count"] >= 1
    GLOBAL_TIMER.reset()
    assert GLOBAL_TIMER.summary() == {"spans": {}, "counters": {}, "dropped": 0}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace is a torch.profiler context that leaves a Chrome trace
    of the enclosed work in its directory."""
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_run_windowed_overlap_backend(world):
    """tests/test_pipeline.py's test_run_windowed_overlap_backend on the port:
    the backend on a worker thread gives the synchronous run's odometry
    within 1e-6 and its final trajectory within 1e-2 after the settling
    flush (9 frames, window 4)."""
    def mk():
        cfg = SlamConfig()
        cfg.prefilter.downsample_resolution = 0.4
        cfg.prefilter.outlier_removal_method = "NONE"
        cfg.odometry.keyframe_delta_trans = 1.0
        cfg.odometry.keyframe_delta_time = 1e9
        cfg.backend.keyframe_delta_trans = 1.0
        cfg.backend.graph_update_interval = 3.0
        return cfg

    poses = drive_square(side=4.0, step=1.0)[:9]
    frames = [(float(i), scan_at(world, p, seed=i, n_keep=3000), None) for i, p in enumerate(poses)]
    r_sync = SlamPipeline(mk(), cloud_capacity=CAPACITY, device="cpu").run_windowed(list(frames), window=4)
    r_ovl = SlamPipeline(mk(), cloud_capacity=CAPACITY, device="cpu").run_windowed(
        list(frames), window=4, overlap_backend=True)
    assert r_ovl.num_frames == r_sync.num_frames == 9
    assert r_ovl.num_keyframes == r_sync.num_keyframes
    for (_, T1), (_, T2) in zip(r_sync.odometry_trajectory, r_ovl.odometry_trajectory):
        np.testing.assert_allclose(T1, T2, atol=1e-6)
    for (s1, T1), (s2, T2) in zip(r_sync.trajectory, r_ovl.trajectory):
        assert s1 == s2
        np.testing.assert_allclose(T1, T2, atol=1e-2)


def test_async_backend(world):
    """tests/test_pipeline.py's TestAsyncBackend on the port: optimize cycles
    run on the timer thread while frames arrive; stop() re-raises the
    worker's first error."""
    cfg = SlamConfig()
    cfg.backend.keyframe_delta_trans = 0.5
    cfg.backend.max_keyframes_per_update = 100
    slam = HdlGraphSlam(cfg, device="cpu")
    with AsyncBackend(slam, interval=0.05) as bk:
        for i in range(8):
            T = np.eye(4)
            T[0, 3] = float(i)
            slam.add_frame(float(i), T, cloud.from_numpy(scan_at(world, T, seed=i), capacity=2560, device="cpu"))
            time.sleep(0.03)
    assert bk.cycles >= 1
    assert len(slam.keyframes) >= 6

    class Boom(Exception):
        pass

    def fail():
        raise Boom("worker")

    broken = HdlGraphSlam(cfg, device="cpu")
    broken.optimize_cycle = fail
    bk = AsyncBackend(broken, interval=0.01)
    with pytest.raises(Boom):
        with bk:
            time.sleep(0.1)
    assert bk.cycles == 0 and len(bk.errors) >= 1
