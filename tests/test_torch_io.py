"""The port's host I/O and map voxel ops against the JAX package, on the CPU:
the copied readers and writers (PCD, KITTI, rosbag with plain and bz2
chunks, Ford, the native ingest helper, the viewer), g2o text (save and
load, with the robust-kernel sidecar) and the occupied-voxel-centre
downsample. Every input is made from a seed with numpy, or is a fixture of
tests/test_io.py, and goes through both packages; each comparison is exact
(identical arrays or identical file bytes) unless a tolerance is stated.
"""

import filecmp
import os
import struct

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import test_io
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.graph import io as jgio
from hdl_graph_slam_tpu.graph import types as jtypes
from hdl_graph_slam_tpu.io import ford as jford
from hdl_graph_slam_tpu.io import kitti as jkitti
from hdl_graph_slam_tpu.io import native as jnative
from hdl_graph_slam_tpu.io import pcd as jpcd
from hdl_graph_slam_tpu.io import rosbag as jrb
from hdl_graph_slam_tpu.ops import voxel as jvoxel
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.graph import io as gio
from hdl_graph_slam_tpu_torch.graph import types
from hdl_graph_slam_tpu_torch.io import ford, kitti, native, pcd
from hdl_graph_slam_tpu_torch.io import rosbag as rb
from hdl_graph_slam_tpu_torch.ops import voxel
from hdl_graph_slam_tpu_torch.pipeline import frames_from_kitti, frames_from_rosbag

FIXTURE_G2O = os.path.join(os.path.dirname(__file__), "fixtures", "reference_dump.g2o")


def same_files(a, b) -> bool:
    return filecmp.cmp(a, b, shallow=False)


# -- PCD --------------------------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_cross_roundtrip(tmp_path, binary):
    """Each package reads what the other writes (seed 0, 500 points with
    intensity), and both write the same bytes."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-50, 50, (500, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 500).astype(np.float32)
    pj, pp = str(tmp_path / "j.pcd"), str(tmp_path / "p.pcd")
    jpcd.save_pcd(pj, xyz, intensity=inten, binary=binary)
    pcd.save_pcd(pp, xyz, intensity=inten, binary=binary)
    assert same_files(pj, pp)
    for path in (pj, pp):
        (x1, i1), (x2, i2) = pcd.load_pcd(path), jpcd.load_pcd(path)
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(x1, xyz, atol=0 if binary else 1e-3)


# -- KITTI, bags, Ford, native ----------------------------------------------------------------


def test_kitti_sequence_and_poses(tmp_path):
    """tests/test_io.py TestKitti's sequence (seed 0, 3 scans of 100 rows at
    0.1 s) and poses file (seed 1): the port's reader, its frame iterator and
    read_poses give the JAX reader's arrays."""
    seq = tmp_path / "00"
    (seq / "velodyne").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        rng.standard_normal((100, 4)).astype(np.float32).tofile(str(seq / "velodyne" / f"{i:06d}.bin"))
    np.savetxt(str(seq / "times.txt"), np.arange(3) * 0.1)
    ours, theirs = list(frames_from_kitti(str(seq))), list(jkitti.KittiOdometrySequence(str(seq)))
    assert len(ours) == len(theirs) == 3
    for (s1, x1, r1), (s2, x2, r2) in zip(ours, theirs):
        assert s1 == s2
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(r1, r2)

    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, 3] = rng.standard_normal((5, 3))
    path = str(tmp_path / "poses.txt")
    np.savetxt(path, poses[:, :3, :].reshape(5, 12))
    np.testing.assert_array_equal(kitti.read_poses(path), jkitti.read_poses(path))


def test_rosbag_pointcloud2(tmp_path):
    """tests/test_io.py's hand-made bag with one PointCloud2: the same
    messages, and frames_from_rosbag yields the parsed cloud."""
    path = str(tmp_path / "mini.bag")
    test_io.TestRosbag().make_mini_bag(path)
    ours, theirs = list(rb.BagReader(path).messages()), list(jrb.BagReader(path).messages())
    assert [(m.topic, m.msg_type, m.stamp, m.raw) for m in ours] == [(m.topic, m.msg_type, m.stamp, m.raw)
                                                                     for m in theirs]
    (stamp, xyz, inten), = list(frames_from_rosbag(path))
    assert abs(stamp - 100.5) < 1e-9
    np.testing.assert_array_equal(xyz, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(inten, [10, 20])


def test_rosbag_bz2_chunk_and_message_parsers(tmp_path):
    """A bz2-compressed chunk (tests/test_io.py TestRosbagBz2's bag) and the
    IMU / NavSatFix / GeoPoint / NMEA parsers on TestMsgParsers' payloads."""
    import bz2

    rec = test_io._bag_record
    conn_hdr = {b"op": b"\x07", b"conn": struct.pack("<I", 0), b"topic": b"/t"}
    conn_payload = b"".join(
        struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v
        for k, v in {b"type": b"std_msgs/Header", b"md5sum": b"x", b"message_definition": b""}.items()
    )
    msg_hdr = {b"op": b"\x02", b"conn": struct.pack("<I", 0), b"time": struct.pack("<II", 7, 0)}
    payload = rec(conn_hdr, conn_payload) + rec(msg_hdr, b"payload")
    chunk_hdr = {b"op": b"\x05", b"compression": b"bz2", b"size": struct.pack("<I", len(payload))}
    bag_hdr = {b"op": b"\x03", b"index_pos": struct.pack("<Q", 0),
               b"conn_count": struct.pack("<I", 1), b"chunk_count": struct.pack("<I", 1)}
    path = str(tmp_path / "c.bag")
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n" + rec(bag_hdr, b" " * 128) + rec(chunk_hdr, bz2.compress(payload)))
    (m,) = list(rb.BagReader(path).messages())
    assert m.topic == "/t" and m.raw == b"payload" and abs(m.stamp - 7.0) < 1e-9

    header = struct.pack("<III", 0, 5, 0) + struct.pack("<I", 3) + b"imu"
    imu = (header + struct.pack("<4d", 0.1, 0.2, 0.3, 0.9) + struct.pack("<9d", *([0.0] * 9))
           + struct.pack("<3d", 0.01, 0.02, 0.03) + struct.pack("<9d", *([0.0] * 9))
           + struct.pack("<3d", 0.0, 0.0, 9.8) + struct.pack("<9d", *([0.0] * 9)))
    fix = (struct.pack("<III", 0, 9, 500000000) + struct.pack("<I", 3) + b"gps" + struct.pack("<bH", 0, 1)
           + struct.pack("<3d", 35.0, 139.0, 40.0) + struct.pack("<9d", *([0.0] * 9)) + b"\x00")
    geo = struct.pack("<III", 0, 2, 0) + struct.pack("<I", 1) + b"g" + struct.pack("<3d", -33.8, 151.2, 5.0)
    s = b"$GPRMC,x*00"
    nmea = struct.pack("<III", 0, 1, 0) + struct.pack("<I", 2) + b"nm" + struct.pack("<I", len(s)) + s
    for name, raw in (("parse_imu", imu), ("parse_navsatfix", fix), ("parse_geopoint", geo),
                      ("parse_nmea_sentence", nmea)):
        ours, theirs = getattr(rb, name)(raw), getattr(jrb, name)(raw)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_ford_scan_and_gps(tmp_path):
    """tests/test_io.py TestFord's dataset directory (two scipy-written
    scans, a text GPS.log) and its binary GPS.log: the same frames and
    fixes through both packages."""
    writer = test_io.TestFord()
    scans = tmp_path / "SCANS"
    scans.mkdir()
    for i, x in enumerate([0.0, 1.0]):
        pts = np.array([[x, 0.0, 0.0], [x, 1.0, 0.5], [x, -1.0, 0.5], [x, 2.0, 1.0]])
        writer._write_scan(scans / f"Scan{i:04d}.mat", pts, (i + 1) * 1e6)
    (tmp_path / "GPS.log").write_text("1000000 0 0 0.7 -1.4 100\n")
    ours, theirs = ford.FordDataset(str(tmp_path)), jford.FordDataset(str(tmp_path))
    frames = list(ours.frames())
    assert len(frames) == 2
    for (s1, x1, _), (s2, x2, _) in zip(frames, theirs.frames()):
        assert s1 == s2
        np.testing.assert_array_equal(x1, x2)
    assert list(ours.gps()) == list(theirs.gps())

    rec = struct.pack("<qddd", 1_000_000, 1.0, 2.0, 3.0) + struct.pack(
        "<dddd", np.radians(42.294319), np.radians(-83.223099), 150.5, 0.25) + struct.pack("<16d", *range(16))
    (tmp_path / "bin.log").write_bytes(rec + b"\x00" * 24)
    assert list(ford.read_gps_log(str(tmp_path / "bin.log"))) == list(jford.read_gps_log(str(tmp_path / "bin.log")))


def test_native_ingest_helpers():
    """The copied native bindings load the repository's native/ library and
    give the JAX package's results (TestNative's inputs; seed 0 for the
    voxel downsample)."""
    assert native.available()
    pts = np.array([[1, 2, 3, 9], [np.nan, 0, 0, 0], [4, 5, 6, 8]], dtype=np.float32)
    for a, b in zip(native.pc2_extract(pts.tobytes(), 3, 16, 0, 4, 8, 12),
                    jnative.pc2_extract(pts.tobytes(), 3, 16, 0, 4, 8, 12)):
        np.testing.assert_array_equal(a, b)
    band = np.array([[0.5, 0, 0], [5, 0, 0], [200, 0, 0]], dtype=np.float32)
    np.testing.assert_array_equal(native.distance_filter(band, 1.0, 100.0), jnative.distance_filter(band, 1.0, 100.0))
    uni = np.random.default_rng(0).uniform(-10, 10, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.voxel_downsample(uni, 1.0, cap=4096),
                                  jnative.voxel_downsample(uni, 1.0, cap=4096))


def test_view_map_renders(tmp_path):
    """The copied viewer renders a map, a trajectory and a graph to a PNG."""
    pytest.importorskip("matplotlib")
    from hdl_graph_slam_tpu_torch.tools.view_map import render

    rng = np.random.default_rng(0)
    traj = []
    for i in range(5):
        T = np.eye(4)
        T[0, 3] = float(i)
        traj.append((float(i), T))
    graph = {"nodes": [{"id": i, "position": [float(i), 0.0, 0.0]} for i in range(5)],
             "edges": {"se3_se3": [{"vi": i, "vj": i + 1, "kernel": 0} for i in range(4)]}}
    out = render(rng.uniform(-5, 5, (1000, 3)), traj, graph, out=str(tmp_path / "v.png"), side=True)
    assert os.path.getsize(out) > 1000


# -- g2o --------------------------------------------------------------------------------------


def every_edge_graph(mod, seed: int):
    """A graph with every vertex kind (fixed and free) and every edge type,
    some with robust kernels, built from ``seed`` through ``mod``'s
    GraphBuilder."""
    rng = np.random.default_rng(seed)
    g = mod.GraphBuilder()

    def pose():
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 1.0, 3)).as_matrix()
        T[:3, 3] = rng.normal(0, 10, 3)
        return T

    def spd(d):
        A = rng.normal(size=(d, d))
        return A @ A.T + d * np.eye(d)

    for i in range(6):
        g.add_se3_node(pose(), fixed=i == 0)
    for i in range(2):
        g.add_plane_node(rng.normal(size=4), fixed=i == 0)
        g.add_point_xyz_node(rng.normal(size=3), fixed=i == 1)
    for i in range(5):
        g.add_se3_edge(i, i + 1, pose(), spd(6), kernel="Huber" if i % 2 else "NONE", kernel_delta=0.1 * (i + 1))
    g.add_se3_plane_edge(1, 0, rng.normal(size=4), spd(3), kernel="Cauchy", kernel_delta=0.5)
    g.add_se3_prior_xy_edge(2, rng.normal(size=2), spd(2))
    g.add_se3_prior_xyz_edge(3, rng.normal(size=3), spd(3))
    g.add_se3_prior_vec_edge(4, [0, 0, -1], rng.normal(size=3), spd(3))
    g.add_se3_prior_quat_edge(5, rng.normal(size=4), spd(3))
    g.add_plane_normal_prior_edge(1, rng.normal(size=3), spd(3))
    g.add_plane_distance_prior_edge(1, rng.normal(), spd(1))
    g.add_plane_identity_edge(0, 1, rng.normal(size=4), spd(4))
    g.add_plane_parallel_edge(0, 1, rng.normal(size=3), spd(3))
    g.add_plane_perpendicular_edge(0, 1, spd(1))
    g.add_se3_point_xyz_edge(2, 1, rng.normal(size=3), spd(3), kernel="Huber", kernel_delta=2.0)
    return g


def assert_same_graph(a, b, atol=0.0):
    for kind in ("poses", "planes", "points"):
        assert len(getattr(a, kind)) == len(getattr(b, kind))
        for x, y in zip(getattr(a, kind), getattr(b, kind)):
            np.testing.assert_allclose(x, y, rtol=0, atol=atol)
    assert (a.pose_fixed, a.plane_fixed, a.point_fixed) == (b.pose_fixed, b.plane_fixed, b.point_fixed)
    for etype, rows in a.edge_rows.items():
        assert len(rows) == len(b.edge_rows[etype]), etype
        for r, s in zip(rows, b.edge_rows[etype]):
            assert (r["vi"], r["vj"], r["kernel_id"], r["kernel_delta"]) == (s["vi"], s["vj"], s["kernel_id"],
                                                                                s["kernel_delta"])
            np.testing.assert_allclose(r["meas"], s["meas"], rtol=0, atol=atol)
            np.testing.assert_allclose(r["info"], s["info"], rtol=0, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_save_g2o_text_matches_jax(tmp_path, seed):
    """The same graph (every edge type the port has) saved by each package:
    graph.g2o and its .kernels sidecar are byte-identical, and each package
    loads the other's file to the same graph: rotations rebuilt from the
    quaternions within 1e-12 (the float64 quaternion-to-matrix products round
    differently in XLA and in PyTorch, by an ulp), every other value exact."""
    pj, pp = str(tmp_path / "j.g2o"), str(tmp_path / "p.g2o")
    jgio.save_g2o(every_edge_graph(jtypes, seed), pj)
    gio.save_g2o(every_edge_graph(types, seed), pp)
    assert same_files(pj, pp) and same_files(pj + ".kernels", pp + ".kernels")
    assert_same_graph(gio.load_g2o(pj), jgio.load_g2o(pp), atol=1e-12)


def test_load_reference_dump_matches_jax(tmp_path):
    """tests/fixtures/reference_dump.g2o (a real g2o build's schema, with its
    kernel sidecar): the same vertices, edges and kernels as the JAX load,
    and a byte-identical re-save."""
    ours, theirs = gio.load_g2o(FIXTURE_G2O), jgio.load_g2o(FIXTURE_G2O)
    assert_same_graph(ours, theirs)
    assert len(ours.poses) == 4 and len(ours.planes) == 2 and ours.num_edges == theirs.num_edges
    assert any(r["kernel_id"] for rows in ours.edge_rows.values() for r in rows)
    pj, pp = str(tmp_path / "j.g2o"), str(tmp_path / "p.g2o")
    jgio.save_g2o(theirs, pj)
    gio.save_g2o(ours, pp)
    assert same_files(pj, pp) and same_files(pj + ".kernels", pp + ".kernels")


# -- occupied voxel centres ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,res,cap", [(0, 0.5, 128), (1, 0.5, 1024), (2, 0.05, 2048), (3, 1.0, 64)])
def test_occupied_voxel_centers_match_jax(seed, res, cap):
    """Random clouds around the origin (negative coordinates on every axis)
    with 100 padded rows, at capacities below and above the occupied count:
    identical centres and mask (the lowest keys win on overflow)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6, 6, (900, 3)).astype(np.float32)
    jc = jcloud.from_numpy(xyz, capacity=1000)
    pc = cloud.from_numpy(xyz, capacity=1000, device="cpu")
    ours = voxel.occupied_voxel_centers(pc, res, max_voxels=cap)
    theirs = jvoxel.occupied_voxel_centers(jc, res, max_voxels=cap)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(theirs.mask))
    np.testing.assert_array_equal(ours.xyz.numpy(), np.asarray(theirs.xyz))
    keys = voxel.voxel_keys(pc.xyz, pc.mask, res)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jvoxel.voxel_keys(jc.xyz, jc.mask, res)))
    occupied = len(np.unique(keys.numpy()[pc.mask.numpy()]))
    assert int(ours.mask.sum()) == min(cap, occupied)
    if cap < occupied:  # the kept voxels are the lowest keys
        kept = voxel.voxel_keys(ours.xyz, ours.mask, res)[ours.mask]
        np.testing.assert_array_equal(kept.numpy(), np.unique(keys.numpy()[pc.mask.numpy()])[:cap])


def test_voxel_keys_stay_exact_int64():
    """Keys above 2^24 (far cells at a fine resolution, both signs) are
    built in integers: the centre of each key holds its point, and key_to_center
    matches the JAX function."""
    xyz = torch.tensor([[4000.03, -3999.97, 0.01], [-52000.0, 51000.5, -0.02], [1.0e6, 0.0, 0.0]],
                       dtype=torch.float32)
    mask = torch.tensor([True, True, False])
    keys = voxel.voxel_keys(xyz, mask, 0.05)
    assert keys.dtype == torch.int64 and int(keys[2]) == torch.iinfo(torch.int64).max
    assert int(keys[:2].min()) > 2**40
    centers = voxel.key_to_center(keys[:2], 0.05)
    assert float((centers - xyz[:2]).abs().max()) <= 0.025 + 1e-2
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jvoxel.key_to_center(np.asarray(keys[:2]), 0.05)))
