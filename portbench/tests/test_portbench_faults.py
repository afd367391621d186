"""Each cell's run with the timed path broken underneath: ``correct`` has to
come out false. The small cells run the port's plain PyTorch path on the
CPU (the harness's look for a card is skipped); a sound run comes out true."""

import pytest
import torch

from portbench.tests.helpers import run_small, small_cell

ODOM, SLAM = "kitti_hdl64.odometry_window", "hdl400_hdl32.slam_run"


def _state_unchanged(monkeypatch):
    """Every scan match returns its initial guess as the converged result."""
    from hdl_graph_slam_tpu_torch.registration import base, factory

    def align(cfg, tgt, source, guess):
        dev = guess.device
        z = torch.zeros(guess.shape[:-2], dtype=torch.int32, device=dev)
        return base.AlignResult(transformation=guess, converged=torch.ones(guess.shape[:-2], dtype=torch.bool,
                                                                           device=dev),
                                iterations=z, error=torch.zeros(guess.shape[:-2], device=dev), num_inliers=z)

    monkeypatch.setattr(factory, "align", align)


def _half_batch(monkeypatch):
    """The scan matcher sums over every other source row only."""
    from hdl_graph_slam_tpu_torch.core.cloud import PointCloud
    from hdl_graph_slam_tpu_torch.registration import factory

    orig = factory.prepare_source

    def prepare(cfg, cloud):
        keep = torch.ones_like(cloud.mask)
        keep[1::2] = False
        return orig(cfg, PointCloud(xyz=torch.where(keep[:, None], cloud.xyz, 1.0e6), mask=cloud.mask & keep))

    monkeypatch.setattr(factory, "prepare_source", prepare)


def _altered_match(monkeypatch):
    """Each scan match's answer comes out 1 cm off along its x, where it is
    produced (everything downstream takes it as it comes)."""
    from hdl_graph_slam_tpu_torch.registration import factory

    orig = factory.align

    def align(cfg, tgt, source, guess):
        res = orig(cfg, tgt, source, guess)
        T = res.transformation.clone()
        T[..., 0, 3] += 0.01
        return res._replace(transformation=T)

    monkeypatch.setattr(factory, "align", align)


def _quarter_of_frames(monkeypatch):
    """One scan match in four comes out 1 cm off along its x: a fault on a
    share of the frames too small to move the median gap."""
    from hdl_graph_slam_tpu_torch.registration import factory

    orig, calls = factory.align, [0]

    def align(cfg, tgt, source, guess):
        res = orig(cfg, tgt, source, guess)
        calls[0] += 1
        if calls[0] % 4:
            return res
        T = res.transformation.clone()
        T[..., 0, 3] += 0.01
        return res._replace(transformation=T)

    monkeypatch.setattr(factory, "align", align)


def _graph_unchanged(monkeypatch):
    """The pose-graph solve returns the graph it was given."""
    from hdl_graph_slam_tpu_torch.backend import slam

    orig = slam.graph_optimize
    monkeypatch.setattr(slam, "graph_optimize", lambda data, max_iterations=0, **kw: orig(data, max_iterations=0))


@pytest.mark.parametrize("workload", [ODOM, SLAM])
def test_a_sound_small_run_is_correct(workload):
    run = run_small(small_cell(workload))
    assert run.correct, run.checks
    assert run.attempted > 0


@pytest.mark.parametrize("workload,fault", [
    (ODOM, _state_unchanged), (ODOM, _half_batch), (ODOM, _altered_match), (ODOM, _quarter_of_frames),
    (SLAM, _state_unchanged), (SLAM, _half_batch), (SLAM, _altered_match), (SLAM, _quarter_of_frames),
    (SLAM, _graph_unchanged),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    run = run_small(small_cell(workload))
    assert not run.correct, run.checks
