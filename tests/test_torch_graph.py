"""Parity of the port's pose graph (hdl_graph_slam_tpu_torch/graph/, core/plane.py)
with the JAX reference, on the CPU in float64.

Both sides get the same graph: the JAX GraphBuilder's frozen arrays are
carried into the port as numpy (state.graph_data_from_numpy), so every
residual, robust kernel, linear system and LM run is compared on identical
inputs. The JAX side runs in float64 (x64 is on in tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdl_graph_slam_tpu.core import plane as jplane
from hdl_graph_slam_tpu.core import se3 as jse3
from hdl_graph_slam_tpu.graph import GraphBuilder as JGraphBuilder
from hdl_graph_slam_tpu.graph import edges as jedges
from hdl_graph_slam_tpu.graph import linearize as jlin
from hdl_graph_slam_tpu.graph import optimize as joptimize
from hdl_graph_slam_tpu.graph.robust import rho_and_weight as jrho
from hdl_graph_slam_tpu_torch import state as statelib
from hdl_graph_slam_tpu_torch.core import plane
from hdl_graph_slam_tpu_torch.graph import EDGE_SPECS, GraphBuilder, edges, linearize, optimize
from hdl_graph_slam_tpu_torch.graph.robust import KERNEL_IDS, rho_and_weight
from hdl_graph_slam_tpu_torch.graph import solver as port_solver
from hdl_graph_slam_tpu_torch.graph.solver import dense_step

ROBUST_NAMES = list(KERNEL_IDS)


def rand_pose(rng, tmag=1.0, rmag=0.5):
    xi = np.concatenate([rng.standard_normal(3) * tmag, rng.standard_normal(3) * rmag])
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)))


def rand_plane(rng):
    c = np.concatenate([rng.standard_normal(3), rng.standard_normal(1)])
    return c / np.linalg.norm(c[:3])


def jax_graph_to_numpy(g):
    """The numpy form (state.py) of the JAX GraphBuilder's frozen graph."""
    data = g.freeze()
    out = {k: np.asarray(getattr(data, k)) for k in statelib.GRAPH_VERTEX_KEYS}
    for e, table in data.edges.items():
        for k in statelib.EDGE_KEYS:
            out[f"{e}.{k}"] = np.asarray(getattr(table, k))
    return data, out


def port_data(arrays):
    return statelib.graph_data_from_numpy(arrays, dtype=torch.float64, device="cpu")


def t64(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


# -- residuals and robust kernels ------------------------------------------


def _edge_inputs(etype, rng):
    """Vertex values and a measurement for one edge of ``etype``, near but
    not at a consistent configuration (a nonzero residual)."""
    kinds, mshape, _ = EDGE_SPECS[etype]
    make = {"pose": lambda: rand_pose(rng), "plane": lambda: rand_plane(rng),
            "point": lambda: rng.standard_normal(3)}
    verts = [make[k]() for k in kinds]
    if etype == "se3_se3":
        meas = rand_pose(rng, 0.5, 0.2)
    elif etype in ("se3_plane", "plane_identity"):
        meas = rand_plane(rng)
    elif etype == "se3_prior_vec":
        d, m = rng.standard_normal(3), rng.standard_normal(3)
        meas = np.concatenate([d / np.linalg.norm(d), m / np.linalg.norm(m)])
    elif etype == "se3_prior_quat":
        q = rng.standard_normal(4)
        meas = q / np.linalg.norm(q)
    else:
        meas = rng.standard_normal(mshape)
    return verts, meas


_JRES = {k: getattr(jedges, k) for k in EDGE_SPECS}
_PRES = {k: getattr(edges, k) for k in EDGE_SPECS}


@pytest.mark.parametrize("etype", list(EDGE_SPECS))
def test_residual_matches_jax(etype):
    """Each residual of EDGE_SPECS on five random configurations, float64,
    atol 1e-10 (both sides do the same float64 arithmetic up to op order)."""
    rng = np.random.default_rng(sorted(EDGE_SPECS).index(etype))
    for _ in range(5):
        verts, meas = _edge_inputs(etype, rng)
        args = verts + ([] if etype == "plane_perpendicular" else [meas])
        r_j = np.asarray(_JRES[etype](*[jnp.asarray(a) for a in args]))
        r_t = _PRES[etype](*[t64(a) for a in args]).numpy()
        assert r_t.shape == r_j.shape == (EDGE_SPECS[etype][2],)
        np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ROBUST_NAMES)
def test_robust_kernel_matches_jax(name):
    """rho0 and rho1 over chi2 from 0 to 50 and deltas 0.5, 1, 3: float64,
    1e-10 relative."""
    e2 = np.concatenate([[0.0], np.geomspace(1e-4, 50.0, 40)])
    for delta in (0.5, 1.0, 3.0):
        kid = np.full(e2.shape, KERNEL_IDS[name], np.int32)
        d = np.full(e2.shape, delta)
        r0_j, r1_j = (np.asarray(x) for x in jrho(jnp.asarray(e2), jnp.asarray(kid), jnp.asarray(d)))
        r0_t, r1_t = rho_and_weight(t64(e2), torch.from_numpy(kid), t64(d))
        np.testing.assert_allclose(r0_t.numpy(), r0_j, rtol=1e-10, atol=1e-300)
        np.testing.assert_allclose(r1_t.numpy(), r1_j, rtol=1e-10, atol=1e-300)


def test_plane_ops_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        p, q, T, v = rand_plane(rng), rand_plane(rng), rand_pose(rng), 0.1 * rng.standard_normal(3)
        for fj, ft, args in ((jplane.oplus, plane.oplus, (p, v)), (jplane.transform, plane.transform, (T, p)),
                             (jplane.ominus, plane.ominus, (p, q)), (jplane.ominus_safe, plane.ominus_safe, (p, q)),
                             (jplane.rotation_of_normal, plane.rotation_of_normal, (p[:3],))):
            np.testing.assert_allclose(ft(*[t64(a) for a in args]).numpy(),
                                       np.asarray(fj(*[jnp.asarray(a) for a in args])), atol=1e-12)


# -- the linear system --------------------------------------------------------


def every_edge_graph(seed=0):
    """A JAX GraphBuilder with 5 poses, 3 planes (one fixed), 2 points and
    two edges of every type, robust kernels cycling through all ten ids,
    random SPD information matrices."""
    rng = np.random.default_rng(seed)
    g = JGraphBuilder()
    poses = [g.add_se3_node(rand_pose(rng), fixed=(i == 0)) for i in range(5)]
    planes = [g.add_plane_node(rand_plane(rng), fixed=(i == 0)) for i in range(3)]
    points = [g.add_point_xyz_node(rng.standard_normal(3)) for _ in range(2)]
    ids = {"pose": poses, "plane": planes, "point": points}
    k = 0
    for etype, (kinds, _, rdim) in EDGE_SPECS.items():
        for rep in range(2):
            verts, meas = _edge_inputs(etype, rng)
            vi = ids[kinds[0]][(rep + 1) % len(ids[kinds[0]])]
            vj = ids[kinds[1]][(rep + 2) % len(ids[kinds[1]])] if len(kinds) == 2 else 0
            A = rng.standard_normal((rdim, rdim))
            info = A @ A.T + rdim * np.eye(rdim)
            name = ROBUST_NAMES[k % len(ROBUST_NAMES)]
            k += 1
            row = dict(vi=vi, vj=vj, meas=np.asarray(meas).reshape(EDGE_SPECS[etype][1]), info=info,
                       kernel_id=KERNEL_IDS[name], kernel_delta=float(rng.uniform(0.5, 3.0)))
            g.edge_rows[etype].append(row)
    return g


def test_graph_data_round_trip_and_freeze_match_jax():
    """The port's GraphBuilder freezes to the same padded arrays as the JAX
    one; the numpy form survives graph_data_from_numpy / to_numpy."""
    gj = every_edge_graph(1)
    _, arrays = jax_graph_to_numpy(gj)
    g = GraphBuilder()
    g.poses, g.pose_fixed = list(gj.poses), list(gj.pose_fixed)
    g.planes, g.plane_fixed = list(gj.planes), list(gj.plane_fixed)
    g.points, g.point_fixed = list(gj.points), list(gj.point_fixed)
    g.edge_rows = {k: list(v) for k, v in gj.edge_rows.items()}
    ours = g.freeze_numpy()
    assert set(ours) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(ours[key], arrays[key], err_msg=key)
    back = statelib.graph_data_to_numpy(port_data(arrays))
    for key in arrays:
        np.testing.assert_array_equal(back[key], arrays[key].astype(back[key].dtype), err_msg=key)
    with pytest.raises(KeyError):
        statelib.graph_data_from_numpy({"poses": arrays["poses"]}, device="cpu")


def test_build_system_matches_jax():
    """H, b, raw and robust chi2 on a graph with every edge type and every
    robust kernel: float64, 1e-9 relative to each quantity's scale (the
    Jacobians are forward-mode AD on both sides; only summation order
    differs)."""
    data_j, arrays = jax_graph_to_numpy(every_edge_graph(0))
    data = port_data(arrays)
    H_j, b_j, c_j, cr_j = (np.asarray(x) for x in jax.jit(jlin.build_system)(data_j))
    H, b, c, cr = (x.numpy() for x in linearize.build_system(data))
    assert np.isfinite(H).all() and np.abs(H).max() > 0
    np.testing.assert_allclose(H, H_j, rtol=1e-9, atol=1e-9 * np.abs(H_j).max())
    np.testing.assert_allclose(b, b_j, rtol=1e-9, atol=1e-9 * np.abs(b_j).max())
    np.testing.assert_allclose(c, c_j, rtol=1e-9)
    np.testing.assert_allclose(cr, cr_j, rtol=1e-9)
    c2, cr2 = (x.numpy() for x in linearize.chi2_only(data))
    np.testing.assert_allclose([c2, cr2], [c, cr], rtol=1e-12)
    np.testing.assert_array_equal(linearize.free_dof_mask(data).numpy(), np.asarray(jlin.free_dof_mask(data_j)))
    dx = np.random.default_rng(3).normal(0.0, 0.05, data.num_dof)
    moved_j = jlin.apply_delta(data_j, jnp.asarray(dx))
    moved = linearize.apply_delta(data, t64(dx))
    for key in ("poses", "planes", "points"):
        np.testing.assert_allclose(getattr(moved, key).numpy(), np.asarray(getattr(moved_j, key)), atol=1e-12)


# -- the LM solver ------------------------------------------------------------


def noisy_loop_graph():
    """tests/test_graph.py::TestOptimize::test_noisy_loop_closes."""
    rng = np.random.default_rng(7)
    n = 12
    truth = [np.eye(4)]
    for k in range(1, n):
        step = np.eye(4)
        step[0, 3] = 1.0
        if k % 3 == 0:
            step[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray([0.0, 0.0, np.pi / 2])))
        truth.append(truth[-1] @ step)
    g = JGraphBuilder()
    ids = []
    est = np.eye(4)
    for k in range(n):
        if k == 0:
            ids.append(g.add_se3_node(np.eye(4), fixed=True))
            continue
        rel_true = np.linalg.inv(truth[k - 1]) @ truth[k]
        noise = np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)]))))
        rel_noisy = rel_true @ noise
        est = est @ rel_noisy
        ids.append(g.add_se3_node(est))
        g.add_se3_edge(ids[k], ids[k - 1], np.linalg.inv(rel_noisy), np.eye(6) * 100.0)
    g.add_se3_edge(ids[-1], ids[0], np.linalg.inv(truth[-1]) @ truth[0], np.eye(6) * 400.0)
    return g


def robust_outlier_graph():
    """tests/test_graph.py::TestOptimize::test_robust_kernel_rejects_outlier_loop."""
    g = JGraphBuilder()
    i0 = g.add_se3_node(np.eye(4), fixed=True)
    T1 = np.eye(4)
    T1[0, 3] = 1.0
    i1 = g.add_se3_node(T1)
    g.add_se3_edge(i1, i0, np.linalg.inv(T1), np.eye(6) * 100.0)
    bad = np.eye(4)
    bad[0, 3] = -10.0
    g.add_se3_edge(i1, i0, bad, np.eye(6) * 100.0, kernel="Huber", kernel_delta=1.0)
    return g


def every_edge_solver_graph():
    return every_edge_graph(2)


@pytest.mark.parametrize("make,iters,same_count", [
    (noisy_loop_graph, 5, True),
    (noisy_loop_graph, 100, False),
    (robust_outlier_graph, 50, True),
    (every_edge_solver_graph, 12, True),
])
@pytest.mark.parametrize("check_every", [1, port_solver.CHECK_EVERY])
def test_optimize_matches_jax(make, iters, same_count, check_every, monkeypatch):
    """The same LM run on both sides: poses within 1e-6, the same chi2
    before and after (1e-9 relative) and, while every accept is decided
    above the float64 rounding floor, the same iteration count and final
    damping. ``check_every`` is how often the host reads ``done``: every
    iteration, or the solver's own CHECK_EVERY; the frozen state keeps the
    result identical.

    The noisy loop's full run ends at that floor: each side's accept test
    there compares values that differ only in summation-order rounding (the
    residuals already differ by a few ulp), and the two stop 7 vs 9
    iterations in (measured), at the same poses within 1e-10. There the
    count is held within 2, and the iterations after the earlier stop must
    move each side's chi2 by less than 1e-15 relative, so that a flipped
    accept above the rounding floor still fails."""
    monkeypatch.setattr(port_solver, "CHECK_EVERY", check_every)
    g = make()
    data_j, arrays = jax_graph_to_numpy(g)
    out_j, st_j = joptimize(data_j, max_iterations=iters)
    out, st = optimize(port_data(arrays), max_iterations=iters)
    if same_count:
        assert int(st.iterations) == int(st_j.iterations)
        np.testing.assert_allclose(float(st.lam_final), float(st_j.lam_final), rtol=1e-9)
    else:
        assert abs(int(st.iterations) - int(st_j.iterations)) <= 2
        n = min(int(st.iterations), int(st_j.iterations))
        _, st_n = optimize(port_data(arrays), max_iterations=n)
        _, st_jn = joptimize(data_j, max_iterations=n)
        for early, full in ((st_n, st), (st_jn, st_j)):
            a, b = float(early.chi2_robust_after), float(full.chi2_robust_after)
            assert abs(a - b) < 1e-15 * abs(b), (a, b)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(out_j.poses), atol=1e-6)
    np.testing.assert_allclose(out.planes.numpy(), np.asarray(out_j.planes), atol=1e-6)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(out_j.points), atol=1e-6)
    for a, b in ((st.chi2_before, st_j.chi2_before), (st.chi2_robust_after, st_j.chi2_robust_after)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-9, atol=1e-12)
    assert float(st.chi2_robust_after) <= float(st.chi2_robust_before)


def test_indefinite_damped_step_is_rejected_not_raised():
    """A negative information matrix makes H + lam I indefinite: the
    Cholesky fails, the trial is rejected (no raise), the poses stay, and
    lambda grows exactly as in the JAX loop."""
    g = JGraphBuilder()
    i0 = g.add_se3_node(np.eye(4), fixed=True)
    T1 = np.eye(4)
    T1[:3, 3] = [0.5, 0.2, -0.1]
    i1 = g.add_se3_node(T1)
    meas = np.eye(4)
    meas[0, 3] = -1.0
    g.add_se3_edge(i1, i0, meas, -np.eye(6))
    data_j, arrays = jax_graph_to_numpy(g)
    data = port_data(arrays)
    H, b, _, _ = linearize.build_system(data)
    free_f = linearize.free_dof_mask(data).double()
    assert not np.isfinite(dense_step(H, b, torch.tensor(1e-5, dtype=torch.float64), free_f).numpy()).any()
    out_j, st_j = joptimize(data_j, max_iterations=6)
    out, st = optimize(data, max_iterations=6)
    assert int(st.iterations) == int(st_j.iterations) == 6
    np.testing.assert_array_equal(out.poses.numpy(), arrays["poses"])
    np.testing.assert_allclose(np.asarray(out_j.poses), arrays["poses"], atol=0)
    np.testing.assert_allclose(float(st.lam_final), float(st_j.lam_final), rtol=1e-12)


@pytest.mark.parametrize("solver", ["pcg", "schur"])
def test_unported_solvers_raise(solver):
    g = robust_outlier_graph()
    _, arrays = jax_graph_to_numpy(g)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimize(port_data(arrays), max_iterations=2, linear_solver=solver)
