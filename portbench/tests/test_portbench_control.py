"""The control of each cell's ``correct``: the reference in the program's
place one precision below the configuration's (TF32 products; the pose
graph in float32) fails at least one of the cell's numbers. Small cells on
the CPU; the TF32 rounding is the reference's own (``tf32_round``)."""

import time

import pytest
import torch

from portbench import harness
from portbench.reference import precision, tf32_round
from portbench.run import Env
from portbench.tests.helpers import small_cell


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2500.123, 3.14159265])
    assert torch.equal(tf32_round(x), x)  # off outside the control
    with precision(tf32=True):
        got = tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, -2500.0, 3.140625]


@pytest.mark.parametrize("workload", ["kitti_hdl64.odometry_window", "hdl400_hdl32.slam_run"])
def test_the_control_is_not_correct(workload):
    cell = small_cell(workload)
    env = Env(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter())
    readings = harness.entry(cell.mix["entry"]).control(env, 12)
    limits = cell.mix["limits"]
    assert any(readings[k] > lim for k, lim in limits.items()), (readings, limits)
