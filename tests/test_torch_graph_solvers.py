"""Parity of the port's PCG and Schur linear solvers (hdl_graph_slam_tpu_torch/
graph/pcg.py, graph/schur.py and their branches of graph/solver.py) with the
JAX reference, on the CPU in float64.

Mirrors tests/test_graph.py TestPcgSolver (both tests) and TestSchurSolver
(the landmark graph and the coupling refusal). Both packages get the same
graph: the JAX GraphBuilder's frozen arrays carried into the port as numpy
(state.graph_data_from_numpy). Tolerances: poses within 1e-5 of the port's
dense solve and of JAX's run of the same solver, chi2 within 1e-6 (relative
to 1 + chi2 for the landmark graph, as the JAX test holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import se3 as jse3
from hdl_graph_slam_tpu.graph import GraphBuilder as JGraphBuilder
from hdl_graph_slam_tpu.graph import optimize as joptimize
from hdl_graph_slam_tpu.graph import pcg as jpcg
from hdl_graph_slam_tpu.graph import schur as jschur
from hdl_graph_slam_tpu_torch.graph import linearize, optimize, pcg, schur
from test_graph import TestSchurSolver as JTestSchurSolver
from test_torch_graph import jax_graph_to_numpy, port_data

POSE_ATOL = 1e-5
CHI2_ATOL = 1e-6


def _trans(x):
    T = np.eye(4)
    T[0, 3] = float(x)
    return T


def chain_graph(correlated: bool):
    """TestPcgSolver's graphs: a noisy 20-pose chain with a loop edge
    (information 50 and 100), or a 12-pose chain whose odometry edges carry
    dense SPD information matrices (A A^T + 10 I)."""
    rng = np.random.default_rng(13 if correlated else 11)
    n = 12 if correlated else 20
    tsd, rsd = (0.03, 0.02) if correlated else (0.02, 0.01)
    g = JGraphBuilder()
    ids = [g.add_se3_node(np.eye(4), fixed=True)]
    est = np.eye(4)
    for k in range(1, n):
        rel = np.eye(4)
        rel[0, 3] = 1.0
        noise = np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, tsd, 3), rng.normal(0, rsd, 3)]))))
        rel_noisy = rel @ noise
        est = est @ rel_noisy
        ids.append(g.add_se3_node(est))
        if correlated:
            A = rng.normal(0, 1, (6, 6))
            info = A @ A.T + 10.0 * np.eye(6)
        else:
            info = np.eye(6) * 50.0
        g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel_noisy), info)
    g.add_se3_edge(ids[-1], ids[0], np.linalg.inv(_trans(n - 1)), np.eye(6) * 100.0)
    return g, ids, (30 if correlated else 40)


def landmark_graph():
    """TestSchurSolver's landmark-heavy graph: 10 poses, 12 points, 6 planes."""
    return JTestSchurSolver()._landmark_graph()


@pytest.mark.parametrize("correlated", [False, True])
def test_pcg_matches_dense_and_jax(correlated):
    """TestPcgSolver::test_pcg_matches_dense / test_pcg_correlated_information:
    linear_solver="pcg" reaches the dense solve's optimum (poses 1e-5, chi2
    1e-6), and JAX's PCG run on the same graph likewise. The iteration counts
    may differ: past the optimum each LM step is CG-tolerance noise (1e-8
    relative), and whether it passes the 1e-10 step test or is rejected
    until lambda blows up is that noise's, on either side."""
    g, ids, iters = chain_graph(correlated)
    data_j, arrays = jax_graph_to_numpy(g)
    dense, dense_st = optimize(port_data(arrays), max_iterations=iters, linear_solver="dense")
    out, st = optimize(port_data(arrays), max_iterations=iters, linear_solver="pcg")
    out_j, st_j = joptimize(data_j, max_iterations=iters, linear_solver="pcg")
    n = len(ids)
    np.testing.assert_allclose(out.poses[:n].numpy(), dense.poses[:n].numpy(), atol=POSE_ATOL)
    assert abs(float(st.chi2_robust_after) - float(dense_st.chi2_robust_after)) < CHI2_ATOL
    np.testing.assert_allclose(out.poses[:n].numpy(), np.asarray(out_j.poses[:n]), atol=POSE_ATOL)
    assert abs(float(st.chi2_robust_after) - float(st_j.chi2_robust_after)) < CHI2_ATOL


def test_pcg_pieces_match_jax():
    """linearize_blocks (b, the H diagonal, robust chi2), hv and one solve_pcg
    on a graph with loops, against JAX's; hv against the dense H product
    restricted to the free dofs; the solve against (H + lam I)^-1."""
    g, _, _ = chain_graph(True)
    data_j, arrays = jax_graph_to_numpy(g)
    data = port_data(arrays)
    sys_, sys_j = pcg.linearize_blocks(data), jpcg.linearize_blocks(data_j)
    np.testing.assert_allclose(sys_.b.numpy(), np.asarray(sys_j.b), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(sys_.diag_blocks.numpy(), np.asarray(sys_j.diag_blocks), rtol=1e-10)
    np.testing.assert_allclose(float(sys_.chi2_robust), float(sys_j.chi2_robust), rtol=1e-12)
    free = linearize.free_dof_mask(data)
    freef = free.double()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=data.num_dof))
    lam = torch.tensor(0.3, dtype=torch.float64)
    y = pcg.hv(sys_, x, lam, freef)
    np.testing.assert_allclose(y.numpy(), np.asarray(jpcg.hv(sys_j, jnp.asarray(x.numpy()), 0.3,
                                                               jnp.asarray(freef.numpy()))), rtol=1e-10, atol=1e-10)
    H, _, _, _ = linearize.build_system(data)
    Hf = H * freef[:, None] * freef[None, :]
    np.testing.assert_allclose(y.numpy(), ((Hf @ (x * freef)) + 0.3 * x * freef).numpy(), rtol=1e-9, atol=1e-9)
    dx = pcg.solve_pcg(sys_, lam, free)
    dx_j = jpcg.solve_pcg(sys_j, 0.3, jnp.asarray(free.numpy()))
    # both stop at ||r|| <= 1e-8 ||b||: their iterates agree to that tolerance
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-8)
    A = Hf + torch.diag(1.0 - freef) + 0.3 * torch.diag(freef)
    np.testing.assert_allclose(dx.numpy(), torch.linalg.solve(A, -sys_.b * freef).numpy(), atol=1e-6)


def test_schur_matches_dense_and_jax():
    """TestSchurSolver::test_matches_dense_on_landmark_graph: poses 1e-5 and
    points 1e-4 of the dense solve, chi2 within 1e-6 (1 + chi2), and JAX's
    Schur run on the same graph likewise (the iteration counts may differ:
    past the optimum the accept test compares chi2 values that differ in
    their last bits)."""
    g, ids = landmark_graph()
    assert len(g.planes) + len(g.points) >= 16
    data_j, arrays = jax_graph_to_numpy(g)
    dense, dense_st = optimize(port_data(arrays), max_iterations=40, linear_solver="dense")
    out, st = optimize(port_data(arrays), max_iterations=40, linear_solver="schur")
    out_j, st_j = joptimize(data_j, max_iterations=40, linear_solver="schur")
    n = len(ids)
    tol = CHI2_ATOL * (1 + float(dense_st.chi2_robust_after))
    np.testing.assert_allclose(out.poses[:n].numpy(), dense.poses[:n].numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(out.points.numpy(), dense.points.numpy(), atol=1e-4)
    assert abs(float(st.chi2_robust_after) - float(dense_st.chi2_robust_after)) < tol
    np.testing.assert_allclose(out.poses[:n].numpy(), np.asarray(out_j.poses[:n]), atol=POSE_ATOL)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(out_j.points), atol=1e-4)
    assert abs(float(st.chi2_robust_after) - float(st_j.chi2_robust_after)) < tol


def test_solve_schur_matches_jax_and_the_dense_solve():
    """One damped Schur solve of the landmark graph's system against JAX's
    solve_schur and torch.linalg.solve of the whole system (1e-8); without
    landmarks it is the plain solve."""
    g, _ = landmark_graph()
    data_j, arrays = jax_graph_to_numpy(g)
    data = port_data(arrays)
    H, b, _, _ = linearize.build_system(data)
    freef = linearize.free_dof_mask(data).double()
    A = H * freef[:, None] * freef[None, :] + torch.diag(1.0 - freef) + 0.01 * torch.diag(freef)
    bf = b * freef
    P = 6 * data.poses.shape[0]
    dx = schur.solve_schur(A, bf, P)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jschur.solve_schur(jnp.asarray(A.numpy()), jnp.asarray(bf.numpy()),
                                                                           P)), atol=1e-8)
    np.testing.assert_allclose(dx.numpy(), -torch.linalg.solve(A, bf).numpy(), atol=1e-8)
    Ap = A[:P, :P]
    np.testing.assert_allclose(schur.solve_schur(Ap, bf[:P], P).numpy(), -torch.linalg.solve(Ap, bf[:P]).numpy(),
                               atol=1e-10)
    m = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 3, 3)))
    np.testing.assert_allclose(schur._inv3x3(m).numpy(), np.asarray(jschur._inv3x3(jnp.asarray(m.numpy()))), rtol=1e-12)


def test_schur_rejects_landmark_coupling():
    """TestSchurSolver::test_rejects_landmark_coupling: a plane_parallel edge
    couples two landmarks; "schur" raises ValueError, as JAX's does, and the
    check agrees with JAX's has_landmark_coupling."""
    g = JGraphBuilder()
    p1 = g.add_plane_node([0, 0, 1, 0])
    p2 = g.add_plane_node([0, 0, 1, 1])
    g.add_plane_parallel_edge(p1, p2, np.zeros(3), np.eye(3))
    data_j, arrays = jax_graph_to_numpy(g)
    data = port_data(arrays)
    assert schur.has_landmark_coupling(data) and jschur.has_landmark_coupling(data_j)
    with pytest.raises(ValueError, match="plane-plane"):
        optimize(data, max_iterations=5, linear_solver="schur")
    with pytest.raises(ValueError):
        joptimize(data_j, max_iterations=5, linear_solver="schur")
    assert not schur.has_landmark_coupling(port_data(jax_graph_to_numpy(landmark_graph()[0])[1]))
    with pytest.raises(ValueError, match="unknown"):
        optimize(data, max_iterations=1, linear_solver="cholmod")
