"""The checks chip_smoke.py gates the port's kernels with, on the CPU.

chip_smoke.py runs on a GPU; its exact row check (rows_valid) is plain
PyTorch, so it is exercised here on the plain selections and on selections
broken on purpose. The script itself must refuse to run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from hdl_graph_slam_tpu_torch.ops import knn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clouds(seed, n=300, m=900, n_pad=60):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(-60, 60, (n, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-60, 60, (m, 3)).astype(np.float32))
    t[m - n_pad:] = 1.0e6
    return q, t, torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("kind", ["nn1", "knn_select"])
def test_rows_valid_accepts_the_plain_selection(kind):
    q, t, rows = clouds(60)
    idx = knn.nn1_plain(q, t)[0] if kind == "nn1" else knn.knn_select_plain(q, t, 20)[0]
    valid, excess = chip_smoke.rows_valid(q, t, idx, rows)
    assert valid == 1.0 and excess <= chip_smoke.ROW_ULPS


@pytest.mark.parametrize("kind", ["nn1", "knn_select"])
def test_rows_valid_rejects_a_farther_neighbour(kind):
    """Replacing the farthest chosen neighbour by the next one out must fail
    on (nearly) every row: the gap is far above the rounding bound."""
    q, t, rows = clouds(61)
    i21 = knn.knn_select_plain(q, t, 21)[0]
    bad = i21[:, 1].contiguous() if kind == "nn1" else torch.cat([i21[:, :19], i21[:, 20:]], 1)
    valid, excess = chip_smoke.rows_valid(q, t, bad, rows)
    assert valid < 0.01 and excess > 1e3 * chip_smoke.ROW_ULPS


def test_rows_valid_with_all_targets_chosen():
    q, t, rows = clouds(62, m=20, n_pad=0)
    idx = knn.knn_select_plain(q, t, 20)[0]
    assert chip_smoke.rows_valid(q, t, idx, rows)[0] == 1.0


def test_refuses_to_run_without_a_gpu_or_alone(tmp_path):
    """Without a card, or copied alone into an empty directory, the script
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
