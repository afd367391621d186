"""The port's map and persistence (backend/map_cloud.py, HdlGraphSlam's
generate_map, save_map, dump and load, utils/markers.py) against the JAX
package, on the CPU.

One backend state is built from seed 0 with numpy in both packages: 6
keyframes with clouds of 300 to 1400 rows (capacity buckets of 512 to
2048), an anchor, a floor plane, GPS priors with a UTM datum and IMU
fields. Dumps are read both ways; the maps of both paths (one capacity,
mixed capacities) are compared point for point.
"""

import filecmp
import os

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from hdl_graph_slam_tpu.backend import HdlGraphSlam as JHdlGraphSlam
from hdl_graph_slam_tpu.backend.keyframe import KeyFrame as JKeyFrame
from hdl_graph_slam_tpu.backend.keyframe import KeyFrameSnapshot as JSnapshot
from hdl_graph_slam_tpu.backend.map_cloud import MapCloudGenerator as JMapCloudGenerator
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
from hdl_graph_slam_tpu.utils import markers as jmarkers
from hdl_graph_slam_tpu_torch.backend import HdlGraphSlam, KeyFrame, KeyFrameSnapshot
from hdl_graph_slam_tpu_torch.backend.map_cloud import MapCloudGenerator
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import SlamConfig
from hdl_graph_slam_tpu_torch.utils import markers

POSE_ATOL = 1e-7  # a dump's poses are %.9g text
KF_FIELDS = ("floor_coeffs", "utm_coord", "acceleration", "orientation")


def random_pose(rng, spread=5.0):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
    T[:3, 3] = rng.normal(0, spread, 3)
    return T


def state_arrays(seed: int = 0, n_kf: int = 6) -> dict:
    """The numpy content of one backend state."""
    rng = np.random.default_rng(seed)
    kfs = []
    for i in range(n_kf):
        n = int(rng.integers(300, 1400))  # buckets 512, 1024 and 2048
        kfs.append(dict(
            stamp=10.0 + 1.25 * i, odom=random_pose(rng), est=random_pose(rng), accum_distance=2.5 * i,
            xyz=rng.uniform(-10, 10, (n, 3)).astype(np.float32),
            floor_coeffs=np.r_[rng.normal(0, 0.05, 2), 1.0, -1.8] if i % 2 == 0 else None,
            utm_coord=rng.normal(0, 10, 3) if i < 3 else None,
            acceleration=rng.normal(0, 1, 3) if i == 4 else None,
            orientation=Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_quat()[[3, 0, 1, 2]] if i == 4 else None,
        ))
    return dict(kfs=kfs, zero_utm=np.array([500123.25, 4649776.5, 12.0]),
                rel=[random_pose(rng, 1.0) for _ in range(n_kf)], info=np.diag(rng.uniform(10, 100, 6)))


def build_state(slam, kf_cls, from_numpy, arrays):
    """Fill ``slam`` (either package) with ``arrays``: pose nodes, a fixed
    anchor, odometry edges, a fixed floor plane with plane edges, GPS priors."""
    g = slam.graph
    for i, k in enumerate(arrays["kfs"]):
        node = g.add_se3_node(k["est"])
        kf = kf_cls(stamp=k["stamp"], odom=k["odom"], accum_distance=k["accum_distance"],
                    cloud=from_numpy(k["xyz"]), node_id=node)
        for name in KF_FIELDS:
            setattr(kf, name, k[name])
        if i == 0:
            slam.anchor_node_id = g.add_se3_node(np.eye(4), fixed=True)
            slam.anchor_edge_first_kf = node
            g.add_se3_edge(slam.anchor_node_id, node, np.eye(4), np.eye(6))
        else:
            g.add_se3_edge(node, slam.keyframes[-1].node_id, arrays["rel"][i], arrays["info"], kernel="Huber")
        if kf.floor_coeffs is not None:
            if slam.floor_plane_node_id is None:
                slam.floor_plane_node_id = g.add_plane_node([0.0, 0.0, 1.0, 0.0], fixed=True)
            g.add_se3_plane_edge(node, slam.floor_plane_node_id, kf.floor_coeffs, np.eye(3) * 0.1)
        if kf.utm_coord is not None:
            g.add_se3_prior_xyz_edge(node, kf.utm_coord, np.eye(3) * 1e-4)
        slam.keyframes.append(kf)
        slam.keyframe_hash[kf.stamp] = kf
    slam.zero_utm = arrays["zero_utm"].copy()
    return slam


def port_state(arrays):
    slam = HdlGraphSlam(SlamConfig(), device="cpu")
    build_state(slam, KeyFrame, lambda x: cloud.from_numpy(x, device="cpu"), arrays)
    slam.snapshots = [KeyFrameSnapshot(pose=slam.graph.poses[kf.node_id], cloud=kf.cloud) for kf in slam.keyframes]
    return slam


def jax_state(arrays):
    slam = JHdlGraphSlam(JSlamConfig())
    build_state(slam, JKeyFrame, jcloud.from_numpy, arrays)
    slam.snapshots = [JSnapshot(pose=slam.graph.poses[kf.node_id], cloud=kf.cloud) for kf in slam.keyframes]
    return slam


def dump_files(directory):
    return sorted(os.path.relpath(os.path.join(d, f), directory) for d, _, fs in os.walk(directory) for f in fs)


def assert_same_state(a, b):
    """Two backends (either package) hold the same keyframes and graph;
    poses within POSE_ATOL, everything else exact."""
    assert len(a.keyframes) == len(b.keyframes)
    for ka, kb in zip(a.keyframes, b.keyframes):
        assert (ka.stamp, ka.node_id, ka.accum_distance) == (kb.stamp, kb.node_id, kb.accum_distance)
        np.testing.assert_allclose(ka.odom, kb.odom, rtol=0, atol=POSE_ATOL)
        for name in KF_FIELDS:
            va, vb = getattr(ka, name), getattr(kb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(np.asarray(ka.cloud.xyz)[np.asarray(ka.cloud.mask)],
                                      np.asarray(kb.cloud.xyz)[np.asarray(kb.cloud.mask)])
    assert a.graph.num_edges == b.graph.num_edges
    for pa, pb in zip(a.graph.poses, b.graph.poses):
        np.testing.assert_allclose(pa, pb, rtol=0, atol=POSE_ATOL)
    assert (a.anchor_node_id, a.anchor_edge_first_kf, a.floor_plane_node_id) == (
        b.anchor_node_id, b.anchor_edge_first_kf, b.floor_plane_node_id)
    np.testing.assert_array_equal(a.zero_utm, b.zero_utm)
    ua, ub = a.keyframe_updater, b.keyframe_updater
    assert (ua.is_first, ua.accum_distance) == (ub.is_first, ub.accum_distance)
    np.testing.assert_array_equal(ua.prev_keypose, ub.prev_keypose)


@pytest.fixture(scope="module")
def arrays():
    return state_arrays()


def test_dump_is_byte_identical_to_jax(tmp_path, arrays):
    """The same state dumped by each package: the same files (graph.g2o and
    its sidecar, %06d/{data,cloud.pcd}, zero_utm, special_nodes.csv) with the
    same bytes."""
    port_state(arrays).dump(str(tmp_path / "p"))
    jax_state(arrays).dump(str(tmp_path / "j"))
    files = dump_files(str(tmp_path / "j"))
    assert files == dump_files(str(tmp_path / "p"))
    assert {"graph.g2o", "graph.g2o.kernels", "zero_utm", "special_nodes.csv", "000005/data",
            "000005/cloud.pcd"} <= set(files)
    for f in files:
        assert filecmp.cmp(str(tmp_path / "j" / f), str(tmp_path / "p" / f), shallow=False), f


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dump_loads_both_ways(tmp_path, arrays, writer):
    """A dump written by one package loads in the other: the two loads agree
    exactly (poses within 1e-7: quaternions to matrices), and hold the state
    that was dumped: poses and odometry within 1e-7, keyframe fields to
    their %.9g text, stamps to the nanosecond, the same clouds, special
    nodes and keyframe-updater state."""
    src = jax_state(arrays) if writer == "jax" else port_state(arrays)
    src.dump(str(tmp_path / "d"))
    ours = HdlGraphSlam(SlamConfig(), device="cpu")
    ours.load(str(tmp_path / "d"))
    theirs = JHdlGraphSlam(JSlamConfig())
    theirs.load(str(tmp_path / "d"))
    assert_same_state(ours, theirs)

    assert len(ours.keyframes) == len(src.keyframes)
    for k, s in zip(ours.keyframes, src.keyframes):
        assert abs(k.stamp - s.stamp) < 1e-9 and k.node_id == s.node_id
        np.testing.assert_allclose(k.odom, s.odom, rtol=0, atol=POSE_ATOL)
        for name in KF_FIELDS + ("accum_distance",):
            v = getattr(s, name)
            if v is not None:
                np.testing.assert_array_equal(getattr(k, name), [float("%.9g" % x) for x in np.atleast_1d(v)]
                                              if name != "accum_distance" else float("%.9g" % v))
        np.testing.assert_array_equal(k.cloud.to_numpy(), np.asarray(s.cloud.xyz)[np.asarray(s.cloud.mask)])
    for a, b in zip(ours.graph.poses, src.graph.poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL)
    assert (ours.anchor_node_id, ours.floor_plane_node_id) == (src.anchor_node_id, src.floor_plane_node_id)
    assert ours.anchor_edge_first_kf == src.keyframes[0].node_id
    assert not ours.keyframe_updater.is_first
    np.testing.assert_array_equal(ours.keyframe_updater.prev_keypose, ours.keyframes[-1].odom)
    assert ours.keyframes[0].cloud.xyz.device.type == "cpu"
    assert [kf.cloud.capacity for kf in ours.keyframes] == [kf.cloud.capacity for kf in theirs.keyframes]
    assert len({kf.cloud.capacity for kf in ours.keyframes}) > 1


def test_loaded_map_save_map_and_markers_match_jax(tmp_path, arrays):
    """After a load (mixed capacities: the map's per-snapshot path), the
    port's generate_map at 0.05 m equals JAX's point for point; save_map
    with utm writes the same PCD and .utm sidecar; the graph JSON and PLY
    markers are the same."""
    jax_state(arrays).dump(str(tmp_path / "d"))
    ours = HdlGraphSlam(SlamConfig(), device="cpu")
    ours.load(str(tmp_path / "d"))
    theirs = JHdlGraphSlam(JSlamConfig())
    theirs.load(str(tmp_path / "d"))
    m, mj = ours.generate_map(0.05), theirs.generate_map(0.05)
    assert m.shape[0] > 1000
    np.testing.assert_array_equal(m, mj)
    for utm in (False, True):
        ours.save_map(str(tmp_path / f"p{utm}.pcd"), resolution=0.05, utm=utm)
        theirs.save_map(str(tmp_path / f"j{utm}.pcd"), resolution=0.05, utm=utm)
        for suffix in ("", ".utm"):
            assert filecmp.cmp(str(tmp_path / f"p{utm}.pcd{suffix}"), str(tmp_path / f"j{utm}.pcd{suffix}"),
                               shallow=False)
    assert markers.graph_summary(ours) == jmarkers.graph_summary(theirs)
    markers.save_graph_ply(ours, str(tmp_path / "p.ply"))
    jmarkers.save_graph_ply(theirs, str(tmp_path / "j.ply"))
    assert filecmp.cmp(str(tmp_path / "p.ply"), str(tmp_path / "j.ply"), shallow=False)


@pytest.mark.parametrize("case", ["one_capacity", "mixed", "full_resolution", "overflow"])
def test_map_cloud_generator_matches_jax(case):
    """MapCloudGenerator.generate on 5 snapshots of one capacity (the batched
    path, padded to 8) and on 3 of mixed capacities (the per-snapshot path),
    both at 0.05 m; the one-capacity path at resolution 0 (every point); and
    a 0.5 m map capped at 256 voxels (the lowest keys win). Seed 1; the same
    points as the JAX generator, exactly."""
    rng = np.random.default_rng(1)
    caps = {"mixed": [512, 1024, 2048]}.get(case, [512] * 5)
    snaps, snaps_j = [], []
    for c in caps:
        pose = random_pose(rng)
        xyz = rng.uniform(-8, 8, (int(rng.integers(c // 2 + 1, c)), 3)).astype(np.float32)
        snaps.append(KeyFrameSnapshot(pose=pose, cloud=cloud.from_numpy(xyz, capacity=c, device="cpu")))
        snaps_j.append(JSnapshot(pose=pose, cloud=jcloud.from_numpy(xyz, capacity=c)))
    kw = dict(resolution={"full_resolution": 0.0, "overflow": 0.5}.get(case, 0.05))
    if case == "overflow":
        kw["max_points"] = 256
    ours, theirs = MapCloudGenerator().generate(snaps, **kw), JMapCloudGenerator().generate(snaps_j, **kw)
    np.testing.assert_array_equal(ours, theirs)
    if case == "overflow":
        assert ours.shape[0] == 256
    if case == "full_resolution":
        assert ours.shape[0] == sum(int(s.cloud.mask.sum()) for s in snaps)
    assert MapCloudGenerator().generate([]) is None


def test_map_paths_agree():
    """The batched one-capacity path and the per-snapshot path give the same
    map for the same clouds (5 snapshots, seed 2): the overflow rule and the
    voxel keys do not depend on the path."""
    rng = np.random.default_rng(2)
    snaps = []
    for _ in range(5):
        xyz = rng.uniform(-8, 8, (400, 3)).astype(np.float32)
        snaps.append(KeyFrameSnapshot(pose=random_pose(rng), cloud=cloud.from_numpy(xyz, capacity=512, device="cpu")))
    fast = MapCloudGenerator().generate(snaps, resolution=0.05)
    wide = KeyFrameSnapshot(pose=snaps[0].pose, cloud=cloud.from_numpy(snaps[0].cloud.to_numpy(), capacity=1024,
                                                                         device="cpu"))
    mixed = MapCloudGenerator().generate([wide] + snaps[1:], resolution=0.05)
    np.testing.assert_array_equal(np.unique(fast, axis=0), np.unique(mixed, axis=0))
    assert fast.shape == mixed.shape
