"""Parity of the port's SE(3)/SO(3) module (hdl_graph_slam_tpu_torch/core/se3.py)
with the JAX reference (hdl_graph_slam_tpu/core/se3.py), mirroring
tests/test_se3.py.

Inputs are float32 arrays made with numpy from a seed and fed to both sides.
Tolerance: atol 1e-6 on O(1) outputs (about 8 float32 ulp): the two sides
evaluate the same formulas, and torch's and XLA's float32 sin/cos/acos/sqrt
differ by an ulp or two.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hdl_graph_slam_tpu.core import se3 as jse3
from hdl_graph_slam_tpu_torch.core import se3

ATOL = 1e-6


def f32(x):
    return np.asarray(x, dtype=np.float32)


def both(fn_name, *args):
    """(port result, JAX result) as numpy for the same float32 inputs."""
    out_t = getattr(se3, fn_name)(*[torch.from_numpy(f32(a)) for a in args])
    out_j = getattr(jse3, fn_name)(*[jnp.asarray(f32(a)) for a in args])
    return out_t.numpy(), np.asarray(out_j)


def test_so3_exp_log_roundtrip_and_parity():
    rng = np.random.default_rng(0)
    for scale in [1e-6, 1e-3, 0.5, 1.5, 3.0]:
        w = rng.standard_normal(3)
        w = f32(w / np.linalg.norm(w) * scale)
        R_t, R_j = both("so3_exp", w)
        np.testing.assert_allclose(R_t, R_j, atol=ATOL)
        w_t, w_j = both("so3_log", R_t)
        np.testing.assert_allclose(w_t, w_j, atol=ATOL)
        # float32 round trip: the log's theta/(2 sin theta) scale amplifies
        # the rotation's rounding as theta nears pi
        np.testing.assert_allclose(w_t, w, atol=2e-5 if scale > 2 else ATOL)


def test_so3_log_near_pi_mixed_sign_axis():
    """At/near theta=pi the vee differences vanish; mixed-sign axes must still
    round-trip (signs from the off-diagonal sums, so3_log near-pi branch)."""
    axes = [
        np.array([1.0, -1.0, 0.0]),
        np.array([-1.0, 1.0, 1.0]),
        np.array([0.0, 1.0, -1.0]),
        np.array([1.0, -0.3, 0.8]),
        np.array([0.0, 0.0, -1.0]),
    ]
    for a in axes:
        a = a / np.linalg.norm(a)
        for theta in [np.pi, np.pi - 1e-7, np.pi - 1e-5, np.pi - 5e-5]:
            R = se3.so3_exp(torch.from_numpy(a * theta))  # float64, as test_se3 runs
            R2 = se3.so3_exp(se3.so3_log(R))
            # the log is only defined up to sign at exactly pi; the rotation
            # it encodes must match
            np.testing.assert_allclose(R2.numpy(), R.numpy(), atol=ATOL)
            w_j = np.asarray(jse3.so3_log(jnp.asarray(R.numpy())))
            np.testing.assert_allclose(se3.so3_log(R).numpy(), w_j, atol=ATOL)


def test_so3_exp_is_rotation():
    rng = np.random.default_rng(1)
    R, R_j = both("so3_exp", rng.standard_normal((32, 3)))
    np.testing.assert_allclose(R, R_j, atol=ATOL)
    R = R.astype(np.float64)
    assert np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max() < 1e-6
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)


def test_se3_exp_log_roundtrip_and_parity():
    rng = np.random.default_rng(2)
    xi = rng.standard_normal((16, 6))
    wn = np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
    xi[:, 3:] *= 2.8 / np.maximum(wn, 2.8 / 0.9)
    T_t, T_j = both("se3_exp", xi)
    np.testing.assert_allclose(T_t, T_j, atol=ATOL)
    xi_t, xi_j = both("se3_log", T_t)
    np.testing.assert_allclose(xi_t, xi_j, atol=2e-6)  # |v| up to ~3 carries 2x the rounding
    np.testing.assert_allclose(xi_t, f32(xi), atol=1e-5)


def test_inverse_compose():
    rng = np.random.default_rng(3)
    T = se3.se3_exp(torch.from_numpy(f32(rng.standard_normal(6))))
    np.testing.assert_allclose(se3.compose(T, se3.inverse(T)).numpy(), np.eye(4), atol=ATOL)
    inv_t, inv_j = both("inverse", T.numpy())
    np.testing.assert_allclose(inv_t, inv_j, atol=ATOL)
    batch = se3.se3_exp(torch.from_numpy(f32(rng.standard_normal((5, 6)))))
    c_t, c_j = both("compose", batch.numpy(), se3.inverse(batch).numpy())
    np.testing.assert_allclose(c_t, c_j, atol=ATOL)


def test_quat_roundtrip():
    rng = np.random.default_rng(4)
    for _ in range(20):
        R = se3.so3_exp(torch.from_numpy(f32(rng.standard_normal(3) * 2.0)))
        q_t, q_j = both("quat_from_mat", R.numpy())
        np.testing.assert_allclose(q_t, q_j, atol=ATOL)
        np.testing.assert_allclose(se3.mat_from_quat(torch.from_numpy(q_t)).numpy(), R.numpy(), atol=ATOL)


def test_quat_near_pi():
    R = np.diag([-1.0, -1.0, 1.0])
    q_t, q_j = both("quat_from_mat", R)
    np.testing.assert_allclose(q_t, q_j, atol=ATOL)
    np.testing.assert_allclose(se3.mat_from_quat(torch.from_numpy(q_t)).numpy(), R, atol=ATOL)


def test_mqt_roundtrip():
    rng = np.random.default_rng(5)
    delta = f32(rng.standard_normal(6) * 0.3)
    T_t, T_j = both("mqt_exp", delta)
    np.testing.assert_allclose(T_t, T_j, atol=ATOL)
    d_t, d_j = both("mqt_log", T_t)
    np.testing.assert_allclose(d_t, d_j, atol=ATOL)
    np.testing.assert_allclose(d_t, delta, atol=ATOL)
    # |qvec| > 1 is normalized as g2o does
    big_t, big_j = both("mqt_exp", [0.0, 0.0, 0.0, 1.2, 0.3, 0.0])
    np.testing.assert_allclose(big_t, big_j, atol=ATOL)


def test_mqt_exp_matches_quaternion_semantics():
    T = se3.mqt_exp(torch.tensor([1.0, 2.0, 3.0, 0.0, 0.0, 0.0]))
    np.testing.assert_allclose(T[:3, 3].numpy(), [1, 2, 3], atol=1e-12)
    np.testing.assert_allclose(T[:3, :3].numpy(), np.eye(3), atol=1e-12)


def test_se3_oplus_parity():
    rng = np.random.default_rng(8)
    T = se3.se3_exp(torch.from_numpy(f32(rng.standard_normal(6)))).numpy()
    o_t, o_j = both("se3_oplus", T, f32(rng.standard_normal(6) * 0.2))
    np.testing.assert_allclose(o_t, o_j, atol=ATOL)


def test_transform_points():
    rng = np.random.default_rng(6)
    pts = f32(rng.standard_normal((100, 3)))
    T = se3.se3_exp(torch.from_numpy(f32(rng.standard_normal(6)))).numpy()
    out_t, out_j = both("transform_points", T, pts)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    expected = pts.astype(np.float64) @ T[:3, :3].T.astype(np.float64) + T[:3, 3]
    np.testing.assert_allclose(out_t, expected, atol=ATOL)


def test_rotation_angle_and_acos_qw():
    R = se3.so3_exp(torch.tensor([0.0, 0.0, 0.7]))
    assert abs(float(se3.rotation_angle(R)) - 0.7) < 1e-6
    # acos(q.w) is half the rotation angle (the reference's threshold measure)
    assert abs(float(se3.acos_qw_angle(R)) - 0.35) < 1e-6
    a_t, a_j = both("acos_qw_angle", R.numpy())
    np.testing.assert_allclose(a_t, a_j, atol=ATOL)


def test_batched_exp_log():
    rng = np.random.default_rng(7)
    xi = f32(rng.standard_normal((8, 6)))
    T = se3.se3_exp(torch.from_numpy(xi))
    assert T.shape == (8, 4, 4)
    np.testing.assert_allclose(se3.se3_log(T).numpy(), xi, atol=1e-5)


def test_project_so3_parity_and_repair():
    rng = np.random.default_rng(9)
    T = se3.se3_exp(torch.from_numpy(f32(rng.standard_normal((4, 6))))).numpy()
    T[:, :3, :3] += f32(1e-3 * rng.standard_normal((4, 3, 3)))  # off SO(3)
    p_t, p_j = both("project_so3", T)
    np.testing.assert_allclose(p_t, p_j, atol=ATOL)
    R = p_t[:, :3, :3].astype(np.float64)
    assert np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max() < 1e-5
    np.testing.assert_array_equal(p_t[:, :3, 3], T[:, :3, 3])
    np.testing.assert_array_equal(p_t[:, 3], T[:, 3])


def test_precision_policy_is_true_fp32():
    """Importing the port turns TF32 off (NN selection and pose products are
    correctness surfaces)."""
    import hdl_graph_slam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
