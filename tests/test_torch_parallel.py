"""Parity of the port's parallel/ (hdl_graph_slam_tpu_torch/parallel/) with
the JAX package's, on the CPU in float64: every test of tests/test_parallel.py
on both sides.

A port mesh of n CPU entries stands where the JAX tests use n of the eight
virtual CPU devices (tests/conftest.py). Graphs are built once with the JAX
GraphBuilder and copied row for row into the port's, so both sides solve the
same numbers.

Tolerances. Against the JAX package: the LM runs are the same float64
algorithm, differing in summation order and in LAPACK calls (Cholesky in the
port, LU in JAX's distributed step), so poses agree to ~1e-12 m and chi2 to
~1e-12 relative; the hierarchy chains several LMs, and the gap measured
here is below 1e-9 m, held to 1e-6 m. The condensed prior quadratics are
one Jacobian program per edge type on both sides: 1e-9 relative.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_parallel as jtp
from hdl_graph_slam_tpu.core import cloud as jcloud
from hdl_graph_slam_tpu.core import plane as jplane
from hdl_graph_slam_tpu.core import se3 as jse3
from hdl_graph_slam_tpu.core.config import SlamConfig as JSlamConfig
from hdl_graph_slam_tpu.graph import GraphBuilder as JGraphBuilder
from hdl_graph_slam_tpu.parallel import distributed_lm_step as jdistributed_lm_step
from hdl_graph_slam_tpu.parallel import distributed_optimize as jdistributed_optimize
from hdl_graph_slam_tpu.parallel import hierarchical_optimize as jhierarchical_optimize
from hdl_graph_slam_tpu.parallel import make_mesh as jmake_mesh
from hdl_graph_slam_tpu.parallel import partition as jpartition
from hdl_graph_slam_tpu.parallel import sharded_candidate_align as jsharded_candidate_align
from hdl_graph_slam_tpu.registration import gicp as jgicp
from hdl_graph_slam_tpu_torch.backend import HdlGraphSlam
from hdl_graph_slam_tpu_torch.backend import slam as slam_mod
from hdl_graph_slam_tpu_torch.core import cloud
from hdl_graph_slam_tpu_torch.core.config import SlamConfig
from hdl_graph_slam_tpu_torch.graph import EDGE_SPECS, GraphBuilder, linearize, optimize
from hdl_graph_slam_tpu_torch.parallel import (distributed_lm_step, distributed_optimize, hierarchical_optimize,
                                               make_mesh, partition, sharded_candidate_align)
from hdl_graph_slam_tpu_torch.parallel import dist
from hdl_graph_slam_tpu_torch.registration import gicp

CPU = "cpu"
POSE_ATOL_VS_JAX = 1e-6
HIER_POSE_ATOL_VS_JAX = 1e-6
CONDENSED_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small CPU solves: the tier-1
    lane runs six workers on the machine's cores, where more threads a
    worker only contend (as tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_builder(jg) -> GraphBuilder:
    """The port's GraphBuilder holding ``jg``'s vertices and edge rows."""
    g = GraphBuilder()
    for name in ("poses", "pose_fixed", "planes", "plane_fixed", "points", "point_fixed"):
        setattr(g, name, copy.deepcopy(getattr(jg, name)))
    g.edge_rows = copy.deepcopy(jg.edge_rows)
    return g


def port_data(jg):
    return port_builder(jg).freeze(device=CPU)


def n_poses(jg) -> int:
    return len(jg.poses)


# -- the mesh -----------------------------------------------------------------


def test_mesh_entries():
    """8 CPU entries stand for the JAX tests' 8 virtual devices; a mesh may
    name one device many times; with no card the default mesh raises."""
    assert len(jax.devices()) >= 8 and jmake_mesh(8).devices.size == 8
    mesh = make_mesh(8, CPU)
    assert mesh.size == 8 and all(d == torch.device(CPU) for d in mesh.devices)
    assert make_mesh(device=CPU).size == 1
    with pytest.raises(ValueError):
        make_mesh(0, CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


# -- candidate-parallel registration --------------------------------------------


def _slope_cloud():
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-10, 10, 800), rng.uniform(-10, 10, 800), rng.normal(0, 0.02, 800)], 1)
    pts[400:, 2] = pts[400:, 0] * 0.5  # a slope so full 6-dof is constrained
    xi = rng.standard_normal((8, 6)) * 0.05
    return pts.astype(np.float32), np.asarray(jax.vmap(jse3.se3_exp)(jnp.asarray(xi, jnp.float32)))


def test_sharded_candidate_align_matches_jax():
    """tests/test_parallel.py's 800-point slope cloud, K = 8 guesses around
    the truth (identity): the 8-entry mesh against the JAX 8-device mesh
    (1e-4 m, the loop gate: float32 GICP on both sides), against the
    unsharded batched align, and a one-entry mesh bit for bit; a 3-entry
    mesh cuts 3/3/2 and lands within 1e-4 m as well."""
    pts, guesses = _slope_cloud()
    K = guesses.shape[0]
    tgt_j = jgicp.preprocess(jcloud.from_numpy(pts, capacity=1024))
    src_j = jgicp.preprocess(jcloud.from_numpy(pts, capacity=1024))
    srcs_j = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (K,) + a.shape), src_j)
    res_j = jsharded_candidate_align(jmake_mesh(8), tgt_j, srcs_j, jnp.asarray(guesses),
                                     lambda t, s, g: jgicp.align(t, s, g))
    T_j = np.asarray(res_j.transformation)

    c = cloud.from_numpy(pts, capacity=1024, device=CPU)
    tgt = gicp.preprocess(c)
    srcs = gicp.preprocess(cloud.PointCloud(xyz=c.xyz.expand(K, -1, -1), mask=c.mask.expand(K, -1)))
    g = torch.from_numpy(guesses)
    align = lambda t, s, gg: gicp.align(t, s, gg)  # noqa: E731
    whole = align(tgt, srcs, g)
    one = sharded_candidate_align(make_mesh(1, CPU), tgt, srcs, g, align)
    assert all(torch.equal(a, b) for a, b in zip(one, whole))
    for n in (8, 3):
        res = sharded_candidate_align(make_mesh(n, CPU), tgt, srcs, g, align)
        T = res.transformation.numpy()
        assert T.shape == (K, 4, 4) and res.converged.shape == (K,)
        np.testing.assert_allclose(T, whole.transformation.numpy(), atol=1e-4)
        np.testing.assert_allclose(T[:, :3, 3], T_j[:, :3, 3], atol=1e-4)
        np.testing.assert_allclose(T[:, :3, :3], T_j[:, :3, :3], atol=1e-4)
        for k in range(K):  # identity is the truth (same cloud)
            assert np.linalg.norm(np.linalg.inv(T[k])[:3, 3]) < 0.05


# -- edge-parallel LM ------------------------------------------------------------


@pytest.mark.parametrize("loop", [False, True])
def test_distributed_lm_step_matches_jax_and_single_chip(loop):
    """One sharded LM step on 8 entries: chi2 and poses against the JAX
    8-device step and the port's single-device step (the JAX test's 1e-9
    relative and 1e-8 m), on the JAX test's chain and on the chain with a
    loop edge. The chain starts at its optimum, where chi2 (~1e-26) is the
    rounding of two packages' se3 logs: there it is held to 1e-20."""
    g, _ = _loop_chain() if loop else jtp.build_chain_graph()
    data = port_data(g)
    lam = 1e-5
    out_j, chi2_j = jdistributed_lm_step(jmake_mesh(8), g.freeze(), lam)

    H, b, _, chi2_ref = linearize.build_system(data)
    free = linearize.free_dof_mask(data).to(H.dtype)
    Hf = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    ref = linearize.apply_delta(data, -torch.linalg.solve(Hf + lam * torch.diag(free), b * free))

    out, chi2 = distributed_lm_step(make_mesh(8, CPU), data, lam)
    np.testing.assert_allclose(float(chi2), float(chi2_ref), rtol=1e-9)
    np.testing.assert_allclose(float(chi2), float(chi2_j), rtol=1e-9, atol=1e-20)
    np.testing.assert_allclose(out.poses.numpy(), ref.poses.numpy(), atol=1e-8)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(out_j.poses), atol=1e-8)
    assert (float(chi2) > 1.0) == loop


def test_distributed_lm_reduces_chi2():
    g, _ = jtp.build_chain_graph()
    mesh = make_mesh(8, CPU)
    d1, chi2_0 = distributed_lm_step(mesh, port_data(g), 1e-5)
    _, chi2_1 = distributed_lm_step(mesh, d1, 1e-5)
    assert float(chi2_1) < float(chi2_0)


def _loop_chain(seed=5, n=24):
    """build_chain_graph with a Huber loop edge from the last pose back to
    the first (an optimum with residuals, many LM iterations)."""
    g, ids = jtp.build_chain_graph(n=n, seed=seed)
    meas = np.eye(4)
    meas[0, 3] = float(n - 1)
    g.add_se3_edge(ids[-1], ids[0], meas, np.eye(6) * 100.0, kernel="Huber", kernel_delta=1.0)
    return g, ids


@functools.lru_cache(maxsize=1)
def _loop_chain_references():
    """The port's optimize and the JAX package's 8-device
    distributed_optimize of _loop_chain, 30 iterations (computed once)."""
    g, ids = _loop_chain()
    ref, ref_stats = optimize(port_data(g), max_iterations=30)
    out_j, stats_j = jdistributed_optimize(jmake_mesh(8), g.freeze(), max_iterations=30)
    return g, ids, ref, ref_stats, np.asarray(out_j.poses), float(stats_j.chi2_robust_after)


@pytest.mark.parametrize("n_shards", [8, 3, 1])
def test_distributed_optimize_matches_jax_and_single_chip(n_shards):
    """The sharded LM against the port's optimize and the JAX package's
    distributed_optimize (the JAX test's 1e-6 m and 1e-6 chi2). 3 shards
    pad the 64-row tables to 66 (the padding rows); one shard is the
    port's optimize bit for bit."""
    g, ids, ref, ref_stats, poses_j, chi2_j = _loop_chain_references()
    out, stats = distributed_optimize(make_mesh(n_shards, CPU), port_data(g), max_iterations=30)
    n = len(ids)
    if n_shards == 1:
        assert torch.equal(out.poses, ref.poses) and torch.equal(stats.chi2_robust_after, ref_stats.chi2_robust_after)
    assert int(stats.iterations) > 3
    np.testing.assert_allclose(out.poses[:n].numpy(), ref.poses[:n].numpy(), atol=1e-6)
    assert abs(float(stats.chi2_robust_after) - float(ref_stats.chi2_robust_after)) < 1e-6
    np.testing.assert_allclose(out.poses[:n].numpy(), poses_j[:n], atol=POSE_ATOL_VS_JAX)
    np.testing.assert_allclose(float(stats.chi2_robust_after), chi2_j, rtol=1e-9)
    assert float(stats.chi2_robust_after) < 0.5 * float(stats.chi2_robust_before)


def _every_edge_type_graph():
    """One or two edges of every type, at vertices away from identity."""
    rng = np.random.default_rng(4)
    g = GraphBuilder()
    poses = [g.add_se3_node(np.asarray(jse3.se3_exp(jnp.asarray(rng.standard_normal(6) * 0.5)))) for _ in range(3)]
    planes = [g.add_plane_node(np.concatenate([rng.standard_normal(3), [1.0]])) for _ in range(2)]
    pt = g.add_point_xyz_node(rng.standard_normal(3))
    g.add_se3_edge(poses[0], poses[1], np.eye(4), np.eye(6))
    g.add_se3_plane_edge(poses[1], planes[0], np.array([0.0, 0.0, 1.0, -1.0]), np.eye(3))
    g.add_se3_prior_xy_edge(poses[2], [0.5, 0.5], np.eye(2))
    g.add_se3_prior_xyz_edge(poses[2], [0.5, 0.5, 0.5], np.eye(3))
    g.add_se3_prior_vec_edge(poses[1], [0.0, 0.0, -1.0], [0.1, 0.0, -1.0], np.eye(3))
    g.add_se3_prior_quat_edge(poses[0], [1.0, 0.1, 0.0, 0.0], np.eye(3))
    g.add_plane_normal_prior_edge(planes[1], [0.0, 0.0, 1.0], np.eye(3))
    g.add_plane_distance_prior_edge(planes[1], 2.0, np.eye(1))
    g.add_plane_identity_edge(planes[0], planes[1], np.zeros(4), np.eye(4))
    g.add_plane_parallel_edge(planes[0], planes[1], np.zeros(3), np.eye(3))
    g.add_plane_perpendicular_edge(planes[0], planes[1], np.eye(1))
    g.add_se3_point_xyz_edge(poses[2], pt, [1.0, 0.0, 0.0], np.eye(3))
    return g


def test_shard_padding_rows_add_exactly_zero():
    """Rows the shards pad with (and freeze's own bucket padding) add
    nothing: a table of padding rows alone, for every edge type, gives H,
    b and chi2 exactly zero, so no 0 x NaN reaches b; the shards' sum is
    the whole graph's system within summation rounding."""
    data = _every_edge_type_graph().freeze(device=CPU)
    assert all(t.vi.shape[0] == 64 for t in data.edges.values())
    shards = dist.shard_edges(data, 3)  # 64 rows -> 66: two padding rows at the end of shard 2
    for etype in EDGE_SPECS:
        assert [s[etype].vi.shape[0] for s in shards] == [22, 22, 22]
        pad_only = {e: dist.EdgeTable(*(getattr(t, f.name)[-20:] if e == etype else getattr(t, f.name)[:0]
                                        for f in dataclasses.fields(t)))
                    for e, t in shards[2].items()}
        assert not pad_only[etype].mask.any()
        H, b, c_raw, c_rob = linearize.build_system(data.replace(edges=pad_only))
        assert torch.count_nonzero(H) == 0 and torch.count_nonzero(b) == 0 and float(c_raw) == float(c_rob) == 0.0
    whole = linearize.build_system(data)
    sharded = dist.ShardedLinearizer([(torch.device(CPU), s) for s in shards], home=torch.device(CPU)).system(data)
    for a, b in zip(sharded, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def test_pcg_refuses_a_linearizer():
    g, _ = jtp.build_chain_graph()
    data = port_data(g)
    with pytest.raises(ValueError, match="pcg"):
        optimize(data, 4, linear_solver="pcg", linearizer=linearize.Linearizer())


# -- the submap hierarchy ---------------------------------------------------------


def _hier_loop_graph():
    """tests/test_parallel.py::test_hierarchical_optimize_approximates_full's
    48-pose chain with a loop edge every 12 poses (JAX GraphBuilder)."""
    rng = np.random.default_rng(3)
    n = 48
    g = JGraphBuilder()
    est = np.eye(4)
    for k in range(n):
        if k == 0:
            g.add_se3_node(np.eye(4), fixed=True)
            continue
        rel = np.eye(4)
        rel[0, 3] = 1.0
        noise = np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]))))
        rel_noisy = rel @ noise
        est = est @ rel_noisy
        g.add_se3_node(est.copy())
        g.add_se3_edge(k, k - 1, np.linalg.inv(rel_noisy), np.eye(6) * 50.0)
    for k in range(12, n, 12):
        T_true_k = np.eye(4)
        T_true_k[0, 3] = float(k)
        T_true_p = np.eye(4)
        T_true_p[0, 3] = float(k - 12)
        g.add_se3_edge(k, k - 12, np.linalg.inv(T_true_k) @ T_true_p, np.eye(6) * 100.0)
    return g, [np.array([float(k), 0.0, 0.0]) for k in range(n)]


def _hier_prior_graph():
    """tests/test_parallel.py::test_hierarchical_optimize_with_prior_edges's
    30-pose drifting chain with GPS xyz / xy, IMU quat / gravity priors and
    floor edges to a fixed plane (JAX GraphBuilder); returns it, the truth
    poses and the height."""
    rng = np.random.default_rng(7)
    n, height = 30, 1.5

    def truth_pose(k):
        T = np.eye(4)
        yaw = 0.02 * k
        T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        T[:3, 3] = [1.0 * k, 0.05 * k, height]
        return T

    truths = [truth_pose(k) for k in range(n)]
    g = JGraphBuilder()
    floor_world = np.array([0.0, 0.0, 1.0, 0.0])
    fid = g.add_plane_node(floor_world, fixed=True)
    est = truths[0].copy()
    for k in range(n):
        if k == 0:
            g.add_se3_node(est.copy())
        else:
            rel = np.linalg.inv(truths[k - 1]) @ truths[k]
            noise = np.asarray(
                jse3.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, 0.04, 3), rng.normal(0, 0.015, 3)])))
            )
            rel_noisy = rel @ noise
            est = est @ rel_noisy
            g.add_se3_node(est.copy())
            g.add_se3_edge(k, k - 1, np.linalg.inv(rel_noisy), np.eye(6) * 50.0)
        gt = truths[k]
        if k % 2 == 0:
            g.add_se3_prior_xyz_edge(k, gt[:3, 3], np.eye(3) * 20.0)
        else:
            g.add_se3_prior_xy_edge(k, gt[:2, 3], np.eye(2) * 20.0)
        q = np.asarray(jse3.quat_from_mat(jnp.asarray(gt[:3, :3])))
        g.add_se3_prior_quat_edge(k, q, np.eye(3) * 10.0)
        g.add_se3_prior_vec_edge(k, [0.0, 0.0, -1.0], gt[:3, :3].T @ np.array([0.0, 0.0, -1.0]), np.eye(3) * 10.0)
        meas = np.asarray(jplane.transform(jnp.asarray(np.linalg.inv(gt)), jnp.asarray(floor_world)))
        g.add_se3_plane_edge(k, fid, meas, np.eye(3) * 10.0)
    return g, truths, height


def _max_pose_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))


def test_hierarchical_optimize_approximates_full_and_matches_jax():
    """The JAX test's gates (within ~2x of the dense solve's truth error),
    and the port's poses within 1e-6 m of the JAX hierarchy's."""
    jg, truth = _hier_loop_graph()
    n = n_poses(jg)
    g_full, g_hier = port_builder(jg), port_builder(jg)
    data, _ = optimize(g_full.freeze(device=CPU), max_iterations=60)
    g_full.update_estimates(data)
    hierarchical_optimize(g_hier, block_size=12, rounds=2, device=CPU)
    jhierarchical_optimize(jg, block_size=12, rounds=2)

    e_full = [np.linalg.norm(g_full.poses[k][:3, 3] - truth[k]) for k in range(n)]
    e_hier = [np.linalg.norm(g_hier.poses[k][:3, 3] - truth[k]) for k in range(n)]
    assert np.mean(e_hier) < 2.5 * np.mean(e_full) + 0.05, (np.mean(e_hier), np.mean(e_full))
    assert max(e_hier) < 2.0 * max(e_full) + 0.05, (max(e_hier), max(e_full))
    assert _max_pose_diff(g_hier.poses, jg.poses) <= HIER_POSE_ATOL_VS_JAX


def test_hierarchical_optimize_with_prior_edges_matches_jax():
    """Submap mode keeps the non-SE3 constraints: the JAX test's gates on the
    drifting chain with GPS / IMU priors and floor edges (block 8, 3
    rounds), and the port's poses within 1e-6 m of the JAX hierarchy's."""
    jg, truths, height = _hier_prior_graph()
    n = len(truths)
    g_full, g_hier = port_builder(jg), port_builder(jg)
    init_z_err = np.mean([abs(g_hier.poses[k][2, 3] - height) for k in range(n)])
    data, _ = optimize(g_full.freeze(device=CPU), max_iterations=100)
    g_full.update_estimates(data)
    hierarchical_optimize(g_hier, block_size=8, rounds=3, device=CPU)
    jhierarchical_optimize(jg, block_size=8, rounds=3)

    e_full = [np.linalg.norm(g_full.poses[k][:3, 3] - truths[k][:3, 3]) for k in range(n)]
    e_hier = [np.linalg.norm(g_hier.poses[k][:3, 3] - truths[k][:3, 3]) for k in range(n)]
    d_hier_full = [np.linalg.norm(g_hier.poses[k][:3, 3] - g_full.poses[k][:3, 3]) for k in range(n)]
    assert init_z_err > 0.05, init_z_err
    assert np.mean(e_full) < 0.1, np.mean(e_full)
    assert np.mean(d_hier_full) < 0.05, (np.mean(d_hier_full), max(d_hier_full))
    assert np.mean(e_hier) < 1.5 * np.mean(e_full) + 0.02, (np.mean(e_hier), np.mean(e_full))
    assert np.mean([abs(g_hier.poses[k][2, 3] - height) for k in range(n)]) < 0.05
    assert _max_pose_diff(g_hier.poses, jg.poses) <= HIER_POSE_ATOL_VS_JAX


def test_condense_priors_matches_jax():
    """Each block's prior quadratic (H_b, b_b), both sides at the same
    locals (the drifted poses in their block base's frame, as a round
    before its intra-block solves), within 1e-9 relative of its scale."""
    jg, _, _ = _hier_prior_graph()
    g = port_builder(jg)
    blocks = partition.partition_poses(len(g.poses), 8, offset=4)
    assert [b.pose_ids for b in blocks] == [b.pose_ids for b in jpartition.partition_poses(len(jg.poses), 8, 4)]
    local, block_of = {}, {}
    for bi, block in enumerate(blocks):
        base_inv = np.linalg.inv(g.poses[block.base_id])
        for gid in block.pose_ids:
            local[gid], block_of[gid] = base_inv @ g.poses[gid], bi
    quads = partition._condense_priors(g, blocks, local, block_of, torch.device(CPU))
    quads_j = jpartition._condense_priors(jg, blocks, local, block_of, jnp.float64)
    assert sorted(quads) == sorted(quads_j) == list(range(len(blocks)))
    for b in quads:
        for a, aj in zip(quads[b], quads_j[b]):
            np.testing.assert_allclose(a, aj, rtol=CONDENSED_RTOL, atol=CONDENSED_RTOL * np.abs(aj).max())


def _floor_ring(n: int = 16, seed: int = 3):
    """No fixed pose: n poses on an 8 m circle at z = 0, noisy odometry
    (information 25), a loop edge, and floor edges saying the fixed z = 0
    plane lies 1.8 m below every pose."""
    rng = np.random.default_rng(seed)
    g = GraphBuilder()
    floor = g.add_plane_node([0.0, 0.0, 1.0, 0.0], fixed=True)

    def pose(k):
        a = 2.0 * np.pi * k / n
        T = np.eye(4)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:3, 3] = [8.0 * np.cos(a), 8.0 * np.sin(a), 0.0]
        return T

    est = pose(0)
    ids = [g.add_se3_node(est)]
    for k in range(1, n):
        twist = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3)])
        rel = np.linalg.inv(pose(k - 1)) @ pose(k) @ np.asarray(jse3.se3_exp(jnp.asarray(twist)))
        est = est @ rel
        ids.append(g.add_se3_node(est))
        g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel), np.eye(6) * 25.0)
    g.add_se3_edge(ids[-1], ids[0], np.linalg.inv(pose(n - 1)) @ pose(0), np.eye(6) * 100.0)
    for i in ids:
        g.add_se3_plane_edge(i, floor, np.array([0.0, 0.0, 1.0, 1.8]), np.eye(3) * 10.0)
    return g, ids


def test_hierarchy_pins_the_gauge_the_priors_leave_free():
    """No fixed pose and floor edges only: world x, y and yaw are free, and
    the condensed graph gets a gauge edge on block 0's base with
    information on exactly those three motions (rank 3; none where GPS and
    IMU priors pin all six, tests above). Without it the condensed LM
    wanders along them (on the CLI's golden_town graph 165 and 385
    iterations, a 1e-12 m change of the input moving the result 1.1e-5 m;
    with it 15 iterations and 2.0e-8 m); on this ring the round's result
    then raised the full chi2 and the best-chi2 safeguard kept the start.
    With it one round lowers the chi2 and lifts the poses onto the floor."""
    g, ids = _floor_ring()
    blocks = partition.partition_poses(len(g.poses), 6)
    local = {i: np.linalg.inv(g.poses[b.base_id]) @ g.poses[i] for b in blocks for i in b.pose_ids}
    block_of = {i: bi for bi, b in enumerate(blocks) for i in b.pose_ids}
    quads = partition._condense_priors(g, blocks, local, block_of, torch.device(CPU))
    meas, W = partition._gauge_edge([g.poses[b.base_id] for b in blocks], quads, torch.device(CPU))
    np.testing.assert_allclose(meas, np.linalg.inv(g.poses[blocks[0].base_id]))
    evals, evecs = np.linalg.eigh(W)
    assert np.sum(evals > 1.0) == 3 and np.abs(evals[:3]).max() < 1e-6 * evals.max()
    # the pinned residual components: x, y translation and the yaw's qz
    pinned = evecs[:, 3:] @ evecs[:, 3:].T
    np.testing.assert_allclose(np.diag(pinned), [1, 1, 0, 0, 0, 1], atol=1e-9)
    chi2_start = float(linearize.chi2_only(g.freeze(device=CPU))[1])
    hierarchical_optimize(g, block_size=6, rounds=1, intra_iterations=60, inter_iterations=60, device=CPU)
    assert float(linearize.chi2_only(g.freeze(device=CPU))[1]) < 0.5 * chi2_start
    assert np.mean([g.poses[i][2, 3] for i in ids]) > 0.9


def _floor_chain(n: int = 12):
    """A chain at z = 0 with the backend's fixed anchor node (node 1) tied
    to keyframe 0 by a weak edge (z information 1e-3) and floor edges
    saying the fixed z = 0 plane lies 1.8 m below every keyframe."""
    rng = np.random.default_rng(9)
    g = GraphBuilder()
    ids = [g.add_se3_node(np.eye(4))]
    anchor = g.add_se3_node(np.eye(4), fixed=True)
    g.add_se3_edge(anchor, ids[0], np.eye(4), np.diag([0.1, 0.1, 0.001, 1.0, 1.0, 1.0]))
    floor = g.add_plane_node([0.0, 0.0, 1.0, 0.0], fixed=True)
    est = np.eye(4)
    for k in range(1, n):
        rel = np.eye(4)
        rel[0, 3] = 1.0
        rel = rel @ np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, 0.02, 3),
                                                                          rng.normal(0, 0.002, 3)]))))
        est = est @ rel
        ids.append(g.add_se3_node(est))
        g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel), np.eye(6) * 25.0)
    for i in ids:
        g.add_se3_plane_edge(i, floor, np.array([0.0, 0.0, 1.0, 1.8]), np.eye(3) * 10.0)
    return g, ids, anchor


def test_hierarchy_bases_a_block_at_its_fixed_pose():
    """The backend's layout: keyframe 0, then the fixed anchor node tied to
    it by a weak edge (z information 1e-3), the odometry chain at z = 0 and
    floor edges saying the fixed z = 0 plane lies 1.8 m below every
    keyframe. The block holding the anchor is based at the anchor, so
    keyframe 0 rises with the others: within 0.01 m of the dense solve
    (measured 0.003; based at keyframe 0, as the JAX package bases it, it
    stays at z = 0, 1.81 m off), every pose within 0.1 m (measured 0.044;
    two rounds of the block-coordinate hierarchy)."""
    g, ids, anchor = _floor_chain()
    dense = copy.deepcopy(g)
    dense.update_estimates(optimize(g.freeze(device=CPU), max_iterations=60)[0])
    blocks = partition._based_at_fixed(partition.partition_poses(len(g.poses), 6), g.pose_fixed)
    assert [b.base_id for b in blocks] == [anchor, 6, 12]
    hierarchical_optimize(g, block_size=6, rounds=2, intra_iterations=60, inter_iterations=60, device=CPU)
    assert abs(dense.poses[ids[0]][2, 3] - 1.8) < 0.05
    assert abs(g.poses[ids[0]][2, 3] - dense.poses[ids[0]][2, 3]) < 0.01
    assert _max_pose_diff(g.poses, dense.poses) < 0.1


@pytest.mark.parametrize("kind", ["plane_prior_distance", "free_plane"])
def test_hierarchy_dense_fallback_matches_jax(kind):
    """Edges the hierarchy cannot condense (a plane prior; an se3_plane edge
    to a free plane) send the graph through the final full-graph LM pass,
    on both sides: on a 16-pose chain (two blocks of 8, one round) the
    port's poses and planes within 1e-6 of JAX's."""
    jg, _ = jtp.build_chain_graph(n=16, seed=2)
    fixed = kind == "plane_prior_distance"
    pid = jg.add_plane_node([0.0, 0.0, 1.0, 0.5], fixed=fixed)
    if fixed:
        # a distance prior on the fixed plane: nothing to condense, the dense pass only
        jg.add_plane_distance_prior_edge(pid, -0.5, np.eye(1) * 10.0)
    for k in range(1, n_poses(jg), 3):
        jg.add_se3_plane_edge(k, pid, np.array([0.0, 0.0, 1.0, 0.5]), np.eye(3) * 5.0)
    g = port_builder(jg)
    assert partition._needs_dense_fallback(g) and jpartition._needs_dense_fallback(jg)
    hierarchical_optimize(g, block_size=8, rounds=1, intra_iterations=20, inter_iterations=20, device=CPU)
    jhierarchical_optimize(jg, block_size=8, rounds=1, intra_iterations=20, inter_iterations=20)
    assert _max_pose_diff(g.poses, jg.poses) <= HIER_POSE_ATOL_VS_JAX
    assert _max_pose_diff(g.planes, jg.planes) <= HIER_POSE_ATOL_VS_JAX


# -- the backend ------------------------------------------------------------------


def _chain_cfg(cfg, **backend):
    cfg.backend.keyframe_delta_trans = 0.5
    cfg.backend.max_keyframes_per_update = 100
    cfg.backend.g2o_solver_num_iterations = 30
    for k, v in backend.items():
        setattr(cfg.backend, k, v)
    cfg.loop.distance_thresh = 0.0
    return cfg


def _feed_chain_port(cfg, n=14):
    """tests/test_parallel.py::_feed_chain_slam on the port: the same
    seeded clouds and odometry chain (JAX's se3_exp), fed to HdlGraphSlam
    on the CPU."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-8, 8, 600), rng.uniform(-8, 8, 600), rng.normal(0, 0.02, 600)], 1)
    pts[300:, 2] = pts[300:, 0] * 0.4
    c = cloud.from_numpy(pts.astype(np.float32), capacity=1024, device=CPU)
    slam = HdlGraphSlam(cfg, device=CPU)
    T = np.eye(4)
    for i in range(n):
        step = np.eye(4)
        step[0, 3] = 1.0
        noise = np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]))))
        T = T @ step @ noise
        slam.add_frame(float(i), T.copy(), c)
    slam.flush()
    return slam


def _assert_same_keyframes_and_poses(s, s_j, atol):
    assert [k.stamp for k in s.keyframes] == [k.stamp for k in s_j.keyframes]
    for a, b in zip(s.keyframes, s_j.keyframes):
        np.testing.assert_allclose(s.graph.poses[a.node_id], s_j.graph.poses[b.node_id], atol=atol)


def test_backend_distributed_matches_dense_and_jax(monkeypatch):
    """backend.distributed=True through HdlGraphSlam: the port's sharded LM
    (a 3-entry CPU mesh, so the shards pad) against the port's dense path
    (the JAX test's 1e-6 m) and against the JAX backend with distributed=True
    fed the same chain."""
    monkeypatch.setattr(slam_mod, "make_mesh", lambda device=None: make_mesh(3, device))
    s_ref = _feed_chain_port(_chain_cfg(SlamConfig()))
    s_dist = _feed_chain_port(_chain_cfg(SlamConfig(), distributed=True))
    assert s_dist._mesh.size == 3 and s_dist.last_stats is not None
    s_j = jtp._feed_chain_slam(_chain_cfg(JSlamConfig(), distributed=True))
    assert len(s_ref.keyframes) == len(s_dist.keyframes) >= 10
    _assert_same_keyframes_and_poses(s_dist, s_ref, 1e-6)
    _assert_same_keyframes_and_poses(s_dist, s_j, POSE_ATOL_VS_JAX)


def test_backend_submap_matches_jax():
    """backend.submap_block_size=6 routes the graph through the hierarchy:
    the JAX test's monotone chain, and the JAX backend's poses."""
    slam = _feed_chain_port(_chain_cfg(SlamConfig(), submap_block_size=6), n=16)
    s_j = jtp._feed_chain_slam(_chain_cfg(JSlamConfig(), submap_block_size=6), n=16)
    assert len(slam.keyframes) >= 14
    xs = [slam.graph.poses[k.node_id][0, 3] for k in slam.keyframes]
    assert all(b - a > 0.3 for a, b in zip(xs, xs[1:])), xs
    _assert_same_keyframes_and_poses(slam, s_j, HIER_POSE_ATOL_VS_JAX)
