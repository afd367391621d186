"""Two processes: the port's edge-sharded LM across a real process boundary
(torch.distributed, gloo on the CPU, a file:// store under tmp_path), held
to the JAX package's single-process optimum of tests/mp_worker.py's graph.

The counterpart of tests/test_multiprocess.py (two jax.distributed
processes). The ranks run through chip_smoke.py's rank launcher (run_ranks /
multihost_rank), the same that runs them on the card. Tolerances are
tests/test_multiprocess.py's: poses 1e-5 m and robust chi2 1e-6 relative
against JAX; the two ranks agree bit for bit (each all-reduce hands both the
same sums, and each rank then solves the same system).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hdl_graph_slam_tpu.graph.solver import optimize as joptimize
from hdl_graph_slam_tpu_torch import state
from hdl_graph_slam_tpu_torch.parallel import multihost
from mp_worker import build_graph

RANKS_TIMEOUT_S = 120  # fails the test instead of holding its worker


def test_two_process_distributed_optimize(tmp_path):
    data_j = build_graph().freeze(dtype=jnp.float64)
    arrays = {k: np.asarray(getattr(data_j, k)) for k in state.GRAPH_VERTEX_KEYS}
    for etype, table in data_j.edges.items():
        for k in state.EDGE_KEYS:
            arrays[f"{etype}.{k}"] = np.asarray(getattr(table, k))

    ranks = chip_smoke.run_ranks(arrays, str(tmp_path / "ranks"), world=2, device="cpu", backend="gloo",
                                 iterations=50, timeout_s=RANKS_TIMEOUT_S)
    assert [str(r["group_backend"]) for r in ranks] == ["gloo", "gloo"]
    for key in ("poses", "planes", "iterations", "chi2_robust_before", "chi2_robust_after"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])

    ref, ref_stats = joptimize(data_j, max_iterations=50)
    r = ranks[0]
    assert float(r["chi2_robust_after"]) < float(r["chi2_robust_before"])
    np.testing.assert_allclose(r["poses"], np.asarray(ref.poses), atol=1e-5)
    assert abs(float(r["chi2_robust_after"]) - float(ref_stats.chi2_robust_after)) < 1e-6 * (
        1.0 + float(ref_stats.chi2_robust_after)
    )


@pytest.mark.parametrize("local_rank, process_id, expected", [(None, 0, 0), (None, 5, 1), (None, 3, 3),
                                                               ("2", 5, 2), ("0", 3, 0)])
def test_initialize_puts_each_rank_on_its_own_card(monkeypatch, local_rank, process_id, expected):
    """With device None (cuda) on a box of four cards, initialize makes
    cuda:<LOCAL_RANK> current, else cuda:<rank % 4>; an explicit index is
    kept. torch.cuda and the process group are stand-ins here."""
    chosen, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: chosen.append(torch.device(d)))
    monkeypatch.setattr(multihost.tdist, "init_process_group", lambda **kw: joined.append(kw))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert multihost.initialize("localhost:1234", 8, process_id) == "nccl"
    assert chosen == [torch.device("cuda", expected)]
    assert joined == [dict(backend="nccl", init_method="tcp://localhost:1234", world_size=8, rank=process_id)]
    chosen.clear()
    multihost.initialize("localhost:1234", 8, process_id, device="cuda:3", backend="gloo")
    assert chosen == [torch.device("cuda", 3)]
