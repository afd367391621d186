"""radius_count's tile rule on the CPU (csrc/knn.cu radius_count_kernel,
mirrored in float32 by hdl_graph_slam_tpu_torch/ops/knn.py radius_tile_plan).

The kernel runs only on the card. Here its rule for skipping (query tile,
target tile) pairs is held against the pairs that radius_count_plain counts:
a skipped tile pair holds none, and a tile pair tested against the target
tile's one point of padding holds none among the target tile's valid rows.
Counting only what the plan tests, in the kernel's float32 arithmetic, gives
every row the count of all pairs in that arithmetic. The launch constants
are held against the CUDA source.
"""

import itertools
import os
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke
from hdl_graph_slam_tpu_torch.core.cloud import PAD_COORD
from hdl_graph_slam_tpu_torch import kernels
from hdl_graph_slam_tpu_torch.ops import knn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "hdl_graph_slam_tpu_torch", "csrc", "knn.cu")
T = knn.RC_TILE


def source() -> str:
    with open(SRC) as f:
        return f.read()


def test_launch_constants_match_the_cuda_source():
    """The wrapper's tile and table sizes are knn.cu's; the entry point
    makes one launch; the kernel's only atomics are integer ones (the shared
    list's length, the statistics); a tile's stamp is stored with release
    semantics after its boxes, and read with acquire semantics; a lane
    computes a tile's boxes itself past the wait (counted in the third
    statistic), or at once with ``own``."""
    src = source()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (kRc\w+) = (\d+);", src)}
    assert (knn.RC_TILE, knn.RC_BOX) == (c["kRcTile"], c["kRcBox"]) == (32, 14)
    assert c["kRcThreads"] == 256 and "constexpr int kRcWarps = kRcThreads / 32;" in src
    body = re.search(r"int hgs_radius_count\(.*?\n\}", src, re.S).group(0)
    assert body.count("<<<") == 1 and "radius_count_kernel<<<p.grid, p.threads, 0," in body
    kernel = src[src.index("// -- radius_count ---"):src.index("// -- launch plans ---")]
    assert re.findall(r"\b(atomic\w+)\(([&\w +]+),", kernel) == [
        ("atomicAdd", "&s_nlist"), ("atomicAdd", "stats"), ("atomicAdd", "stats + 1"), ("atomicAdd", "stats + 2")]
    store = re.search(r"void store_boxes\(.*?\n\}", kernel, re.S).group(0)
    assert "if (lane != 0) return;" in store and store.rstrip("}\n ").endswith("st_release(stamps + j, stamp);")
    assert "st.release.gpu.global.u32" in kernel and "ld.acquire.gpu.global.u32" in kernel
    load = re.search(r"TileBoxes load_boxes\(.*?\n\}", kernel, re.S).group(0)
    assert "if (own) return lane_boxes(t, m, j);" in load
    assert re.search(r"if \(!ready\) \{\s*\+\+expired;\s*return lane_boxes\(t, m, j\);\s*\}", load)


def test_radius_count_tiles_on_the_cpu_reads_the_plan():
    """On CPU tensors radius_count_tiles reports radius_tile_plan's tile
    pairs with the plain twin's counts and no expired wait, and launches
    nothing."""
    q, t, r = padded_case()
    before = knn.radius_count.launches
    got = knn.radius_count_tiles(q, t, r)
    plan = knn.radius_tile_plan(q, t, r)
    assert (got["tile_pairs"], got["full"], got["point"]) == (plan.numel(), int((plan == 2).sum()),
                                                              int((plan == 1).sum()))
    assert got["wait_expired"] == 0  # the plan waits for no stamp
    assert torch.equal(got["counts"], knn.radius_count_plain(q, t, r)) and knn.radius_count.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        knn.radius_count_tiles(q.to("meta"), t.to("meta"), r)


def test_radius_launch_refuses_capture_and_zeroes_stamps_at_the_wrap(monkeypatch):
    """A launch under CUDA graph capture raises before it takes a stamp. At
    the stamps' wrap every radius_count stamp table (and no other
    workspace) is zeroed between two synchronizations, so no launch in
    flight on any stream sees it, and the launch takes the first stamp
    after the wrap; own_boxes reaches the entry point."""
    q = torch.zeros(40, 3)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    before = next(knn._stamps)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        knn._radius_launch(q, q, 1.0, None)
    assert next(knn._stamps) == before + 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    seen = []
    other = torch.full((64,), 9, dtype=torch.int32)
    tickets = torch.full((64,), 3, dtype=torch.int32)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: seen.append(("sync", int(other.sum()))))

    class Lib:
        def hgs_radius_count(self, *a):
            seen.append(("launch", a[7], a[8]))  # stamp, own
            return 0

    monkeypatch.setattr(kernels, "load", lambda name: Lib())
    monkeypatch.setattr(kernels, "stream", lambda x: 5)
    monkeypatch.setattr(kernels, "workspaces", {("radius_count", None, 6): (other, torch.zeros(1)),
                                                 ("ndt", None, 6): (tickets, torch.zeros(1))})
    monkeypatch.setattr(knn, "_stamps", itertools.count(knn._STAMP_WRAP))
    knn._radius_launch(q, q, 1.0, None, own_boxes=True)
    assert seen == [("sync", 9 * 64), ("sync", 0), ("launch", 1, 1)]
    assert (tickets == 3).all() and not kernels.workspaces[("radius_count", None, 5)][0].any()


def test_cluster_variants_patch_their_source():
    """tools/radius_cluster_variants.py: every variant's text patches apply
    to its CUDA source, which defines the entry point it calls and keeps
    the tile and thread constants of csrc/knn.cu."""
    import importlib.util

    path = os.path.join(ROOT, "tools", "radius_cluster_variants.py")
    spec = importlib.util.spec_from_file_location("radius_cluster_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert "int hgs_radius_count_cluster(" in tool.CLUSTER_CU and len(tool.VARIANTS) == 8
    for name, patches in tool.VARIANTS.items():
        for a, _ in patches:
            assert tool.CLUSTER_CU.count(a) == 1, (name, a)
    c = {k: int(v) for k, v in re.findall(r"constexpr int (kRc\w+) = (\d+);", tool.CLUSTER_CU)}
    ours = {k: int(v) for k, v in re.findall(r"constexpr int (kRc\w+) = (\d+);", source())}
    assert all(c[k] == ours[k] for k in ("kRcThreads", "kRcTile", "kRcBox", "kRcStage"))


def test_fma32_rounds_once():
    """_fma32 is a * b + c rounded once to float32 (exact rational
    arithmetic decides), across magnitudes where a float64 sum alone would
    round twice."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 2.0, 400).astype(np.float32)
    c = (rng.uniform(0.0, 1.0, 400) * np.exp2(rng.integers(-60, 3, 400))).astype(np.float32)
    got = knn._fma32(torch.from_numpy(a), torch.from_numpy(a), torch.from_numpy(c)).numpy()
    for x, z, g in zip(a, c, got):
        exact = Fraction(float(x)) ** 2 + Fraction(float(z))
        near = [np.nextafter(g, np.float32(-np.inf)), g, np.nextafter(g, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in near]
        assert errs[1] <= min(errs) and (errs[1] < min(errs[0], errs[2]) or int(g.view(np.int32)) % 2 == 0)


# -- the rule against the counted pairs ------------------------------------------------


def _tiles(x: torch.Tensor, fill: float) -> torch.Tensor:
    """(n, ...) -> (tiles, 32, ...), the last tile filled with ``fill``."""
    pad = torch.full((-x.shape[0] % T,) + x.shape[1:], fill, dtype=x.dtype)
    return torch.cat([x, pad]).reshape((-1, T) + x.shape[1:])


def _d2_32(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The kernel's d^2 of every (q row, t row) pair: float32 differences,
    the FMA chain."""
    d = q[:, None, :] - t[None, :, :]
    return knn._dist2_32(d[..., 0], d[..., 1], d[..., 2])


def kernel_counts_all_pairs(q, t, r2, chunk=256):
    """Every pair in the kernel's arithmetic, nothing skipped."""
    return torch.cat([(_d2_32(qc, t) < r2).sum(-1) for qc in torch.split(q, chunk)])


def kernel_counts_by_plan(q, t, r2, plan):
    """What the kernel adds: every pair of a full tile pair; against a
    point tile each query's test of the target tile's other rows' one point,
    times their count."""
    qt, tt = _tiles(q, float("nan")), _tiles(t, float("nan"))
    (_, _, _), (olo, _, on), one = knn._tile_boxes(t)
    counts = torch.zeros(qt.shape[0], T, dtype=torch.int64)
    for i in range(qt.shape[0]):
        full = torch.nonzero(plan[i] == 2).flatten()
        if full.numel():
            counts[i] += (_d2_32(qt[i], tt[full].reshape(-1, 3)) < r2).sum(-1)
        for j in torch.nonzero(plan[i] == 1).flatten().tolist():
            assert bool(one[j])
            counts[i] += (_d2_32(qt[i], olo[j][None]) < r2)[:, 0] * on[j]
    return counts.flatten()[:q.shape[0]]


def lattice_case():
    """The integer lattice in key order, each of 1024 duplicates beside its
    original; r = 1 (the six neighbours at exactly 1 m are not counted)."""
    rng = np.random.default_rng(0)
    g = np.arange(16, dtype=np.float32)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rows = np.sort(np.r_[np.arange(len(lat)), rng.integers(0, len(lat), 1024)])
    x = torch.from_numpy(lat[rows])
    return x, x, 1.0


def ulp_case():
    """Query tiles of one point each; target tiles of one point at d along
    an axis, |d| the float32 values around r where the kernel's d^2 crosses
    r^2, so a tile pair's bound is its pairs' d^2 exactly."""
    r = 0.8
    r2 = np.float32(r * r)
    base = np.float32(np.sqrt(np.float64(r2)))
    ds = [base]
    for _ in range(3):
        ds = [np.nextafter(ds[0], np.float32(0))] + ds + [np.nextafter(ds[-1], np.float32(2))]
    qs = np.array([[0.0, 0.0, 0.0], [5.1, -3.3, 7.7], [-12.25, 0.5, 0.1]], np.float32)
    targets = []
    for q in qs:
        for axis in range(3):
            for sign in (1.0, -1.0):
                for d in ds:
                    p = q.copy()
                    p[axis] = np.float32(q[axis] + np.float32(sign) * d)
                    targets.append(p)
    q = torch.from_numpy(np.repeat(qs, T, 0))
    t = torch.from_numpy(np.repeat(np.array(targets, np.float32), T, 0))
    return q, t, r


def padded_case():
    """A 4096-row cloud ordered along x (as voxel keys order a scan), its
    last 524 rows PAD_COORD; a tile of rows at 2e5 m (invalid, not padding),
    a NaN row and an infinite row among the valid ones."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-20.0, 20.0, (4096, 3)).astype(np.float32)
    x = x[np.argsort(x[:, 0], kind="stable")]
    x[-524:] = PAD_COORD
    x[640:672] = [2.0e5, 1.0, 1.0]
    x[640:672, 2] += np.linspace(0.0, 3.0, 32, dtype=np.float32)
    x[100] = [np.nan, 0.0, 0.0]
    x[101] = [np.inf, 0.0, 0.0]
    x = torch.from_numpy(x)
    return x, x, 0.8


def golden_case():
    """kernel_filters' golden keyframe: golden_town frame 0 through the
    base prefilter at 4096 rows, r = 0.8 m (the outdoor preset's)."""
    x = chip_smoke.golden_cloud(chip_smoke._golden_scan(0), device="cpu").valid_xyz()
    return x, x, chip_smoke.RADIUS_M


CASES = dict(lattice_duplicates=lattice_case, r2_ulp_pairs=ulp_case, padded_rows=padded_case,
             golden_keyframe=golden_case)


def _by_tile(counted: torch.Tensor) -> torch.Tensor:
    """(n, m) bool -> (query tiles, 32, target tiles, 32), missing rows False."""
    n, m = counted.shape
    c = torch.zeros(-(-n // T) * T, -(-m // T) * T, dtype=torch.bool)
    c[:n, :m] = counted
    return c.reshape(c.shape[0] // T, T, c.shape[1] // T, T)


@pytest.mark.parametrize("case", list(CASES))
def test_tile_plan_never_drops_a_counted_pair(case):
    q, t, r = CASES[case]()
    r2 = float(np.float32(r * r))
    plan = knn.radius_tile_plan(q, t, r)
    assert plan.shape == (-(-q.shape[0] // T), -(-t.shape[0] // T)) and plan.dtype == torch.int8
    # the pairs radius_count_plain counts, by tile pair
    counted = torch.cat([((qc[:, None, :] - t[None]) ** 2).sum(-1) < r2 for qc in torch.split(q, 512)])
    plain = knn.radius_count_plain(q, t, r)
    assert torch.equal(counted.sum(-1, dtype=torch.int32), plain)
    by_tile = _by_tile(counted)
    assert not (by_tile.any((1, 3)) & (plan == 0)).any(), "a skipped tile pair holds a counted pair"
    on_valid = (by_tile & _tiles((t.abs() < 1e5).all(-1), False)[None, None]).any((1, 3))
    assert not (on_valid & (plan == 1)).any(), "a point tile pair holds a counted pair on a valid row"
    # counting only what the plan tests, in the kernel's arithmetic: every row
    all_pairs = kernel_counts_all_pairs(q, t, r2)
    assert torch.equal(kernel_counts_by_plan(q, t, r2, plan), all_pairs)
    if case == "lattice_duplicates":  # every d^2 exact: the two arithmetics agree
        assert torch.equal(all_pairs.to(torch.int32), plain)
    if case == "r2_ulp_pairs":  # one point a tile: the bound is the pairs' d^2, full exactly where they count
        assert torch.equal(plan == 2, by_tile.any((1, 3))) and 0 < int((plan == 2).sum()) < plan.numel()
    if case == "padded_rows":  # padded queries count the padded targets; padded tiles meet by one point
        assert (all_pairs[-524:] == 524).all() and (plan == 1).any() and (plan == 2).any()
    assert int((plan > 0).sum()) < plan.numel() // 4, "the rule skips most tile pairs of a compact cloud"
