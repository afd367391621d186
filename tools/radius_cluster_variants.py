"""radius_count_kernel (csrc/knn.cu: target tile boxes in a global table,
per-tile stamps) against a design that keeps no state across launches: each
block holds every target tile's boxes in its shared memory, the blocks of a
thread-block cluster computing 1/kRcCluster of them each and copying the
rest over distributed shared memory between two cluster barriers. Both count
the same pairs with the same arithmetic.

Run on the card from the repo root:

    python3 tools/radius_cluster_variants.py [--rounds 2]

It builds the cluster design (CLUSTER_CU below, nvcc for sm_90a, one build a
variant, in parallel) at kRcCluster 1, 2, 4, 8 with kRcAhead 1 (a warp
reduces its tiles one after another), at 4 and 8 with kRcAhead 8 (a warp
loads 8 tiles' rows before it reduces them), at 8 with kRcAhead 4, and at 8
with 5 blocks an SM (a 16-tile stage); then times each variant and the
package's radius_count on golden_town frame 0 at 4096 rows (r = 0.8 m),
frame 1 through the outdoor and imu prefilters at 16384 rows, 300 odd rows
(NaN, inf, 2e5 m, signed zeros, padding), 40000 rows in a 1 m cube and
20000 uniform rows in a 120 m cube. One JSON line per variant and round:
device_ms (behind a device-side sleep) and kernel_ms (host issue included)
per input, and whether the counts equal the package kernel's.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLUSTER_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

namespace cg = cooperative_groups;

constexpr float kValidAbs = 1.0e5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b < 0 ? b ^ 0x7fffffff : b;
}

__device__ __forceinline__ float unordered(int o) { return __int_as_float(o < 0 ? o ^ 0x7fffffff : o); }

constexpr int kRcThreads = 256;  // radius_count: threads per block
constexpr int kRcWarps = kRcThreads / 32;
constexpr int kRcTile = 32;      // rows per tile, one a lane
constexpr int kRcBox = 14;       // floats of a tile's boxes
constexpr int kRcChunk = 512;    // target tiles whose boxes a block holds at once
constexpr int kRcStage = 32;     // listed tiles the block stages in shared memory at once
constexpr int kRcCluster = 8;    // blocks of a cluster, which share the boxes they compute
constexpr int kRcAhead = 8;      // tiles whose rows a warp loads at once for their boxes

// a tile's boxes, component by component: valid rows' lo, hi; other rows' lo, hi; their counts
constexpr int kVlo = 0, kVhi = 3, kOlo = 6, kOhi = 9, kNv = 12, kNo = 13;

// The rows of one class of a tile: bounding box and count (lo > hi when none).
struct Box {
  float lo[3], hi[3];
  int n;
};

struct TileBoxes {
  Box v, o;  // valid rows, other (non-NaN) rows
};

// The box of the lanes' rows (x, y, z) that are `mine`; warp-uniform.
__device__ __forceinline__ Box warp_box(bool mine, float x, float y, float z) {
  Box b;
  b.n = __popc(__ballot_sync(kFull, mine));
  const float v[3] = {x, y, z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (b.n == 0) {
      b.lo[a] = INFINITY;
      b.hi[a] = -INFINITY;
    } else {
      b.lo[a] = unordered(__reduce_min_sync(kFull, mine ? ordered(v[a]) : INT_MAX));
      b.hi[a] = unordered(__reduce_max_sync(kFull, mine ? ordered(v[a]) : INT_MIN));
    }
  }
  return b;
}

// The boxes of a tile whose lane holds row (x, y, z) when `in`.
__device__ __forceinline__ TileBoxes tile_boxes(bool in, float x, float y, float z) {
  const bool valid = in && fabsf(x) < kValidAbs && fabsf(y) < kValidAbs && fabsf(z) < kValidAbs;
  const bool other = in && !valid && x == x && y == y && z == z;
  return TileBoxes{warp_box(valid, x, y, z), warp_box(other, x, y, z)};
}

__device__ __forceinline__ bool one_point(const Box& b) {
  return b.n > 0 && b.lo[0] == b.hi[0] && b.lo[1] == b.hi[1] && b.lo[2] == b.hi[2];
}

// The pair test's squared distance (and the boxes' lower bound).
__device__ __forceinline__ float dist2(float dx, float dy, float dz) { return fmaf(dx, dx, fmaf(dy, dy, dz * dz)); }

// Whether boxes a and b may hold a pair with d^2 < r2: false when either is
// empty or the lower bound of their distance is >= r2 (a NaN bound reaches).
__device__ __forceinline__ bool reach(const Box& a, const Box& b, float r2) {
  if (a.n == 0 || b.n == 0) return false;
  float g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = fmaxf(0.0f, fmaxf(a.lo[i] - b.hi[i], b.lo[i] - a.hi[i]));
  return !(dist2(g[0], g[1], g[2]) >= r2);
}

// Write tile j's boxes to the table (lane 0).
__device__ __forceinline__ void put_boxes(float (*tab)[kRcChunk], int j, const TileBoxes& b, int lane) {
  if (lane != 0) return;
  const float v[kRcBox] = {b.v.lo[0], b.v.lo[1], b.v.lo[2], b.v.hi[0], b.v.hi[1], b.v.hi[2],
                           b.o.lo[0], b.o.lo[1], b.o.lo[2], b.o.hi[0], b.o.hi[1], b.o.hi[2],
                           __int_as_float(b.v.n), __int_as_float(b.o.n)};
#pragma unroll
  for (int c = 0; c < kRcBox; ++c) tab[c][j] = v[c];
}

// Tile j's boxes from the table.
__device__ __forceinline__ TileBoxes get_boxes(const float (*tab)[kRcChunk], int j) {
  TileBoxes b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.v.lo[a] = tab[kVlo + a][j];
    b.v.hi[a] = tab[kVhi + a][j];
    b.o.lo[a] = tab[kOlo + a][j];
    b.o.hi[a] = tab[kOhi + a][j];
  }
  b.v.n = __float_as_int(tab[kNv][j]);
  b.o.n = __float_as_int(tab[kNo][j]);
  return b;
}

// Target row r as float4(x, y, z, 0); NaN past the end, so it never counts.
__device__ __forceinline__ float4 tile_row(const float* __restrict__ t, int m, int r) {
  if (r >= m) return make_float4(NAN, NAN, NAN, 0.0f);
  const float* p = t + 3 * (size_t)r;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.0f);
}

// This lane's query (qx, qy, qz) counted against the 32 staged rows of a
// target tile (broadcast reads of shared memory).
__device__ __forceinline__ int count_tile(const float4* rows, float qx, float qy, float qz, float r2) {
  int c0 = 0, c1 = 0;  // two chains of integer adds
#pragma unroll
  for (int k = 0; k < kRcTile; k += 2) {
    const float4 a = rows[k], b = rows[k + 1];
    c0 += dist2(qx - a.x, qy - a.y, qz - a.z) < r2;
    c1 += dist2(qx - b.x, qy - b.y, qz - b.z) < r2;
  }
  return c0 + c1;
}

__global__ void __cluster_dims__(kRcCluster, 1, 1) __launch_bounds__(kRcThreads)
radius_count_kernel(const float* __restrict__ q, int n, const float* __restrict__ t, int m, float r2,
                    int* __restrict__ stats, int* __restrict__ out) {
  __shared__ float s_box[kRcBox][kRcChunk];       // the chunk's target tiles' boxes
  __shared__ float4 s_stage[kRcStage * kRcTile];  // staged rows of listed target tiles
  __shared__ int s_cnt[kRcWarps][kRcTile];        // the warps' counts of the block's query tile
  __shared__ int s_list[kRcChunk];                // the query tile's full target tiles of the chunk
  __shared__ int s_nlist;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int qtiles = (n + kRcTile - 1) / kRcTile, ttiles = (m + kRcTile - 1) / kRcTile;

  // this lane's query of query tile qt, 0 past the end (never written)
  auto query = [&](int qt) {
    const int qi = qt * kRcTile + lane;
    return qi < n ? make_float4(__ldg(q + 3 * (size_t)qi), __ldg(q + 3 * (size_t)qi + 1),
                                __ldg(q + 3 * (size_t)qi + 2), 0.0f)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };

  int nfull = 0, npoint = 0;
  for (int c0 = 0; c0 < ttiles; c0 += kRcChunk) {
    const int nc = min(kRcChunk, ttiles - c0);  // the chunk's target tiles c0, ..., c0 + nc - 1
    float4 qnext = query((int)blockIdx.x);
    // this block's share of the chunk's boxes, a warp a tile: a warp loads
    // the rows of kRcAhead tiles before it reduces them
    constexpr int step = kRcCluster * kRcWarps;
    for (int j0 = rank + kRcCluster * warp; j0 < nc; j0 += kRcAhead * step) {
      float4 p[kRcAhead];
#pragma unroll
      for (int u = 0; u < kRcAhead; ++u)  // (no row past the chunk)
        p[u] = tile_row(t, j0 + u * step < nc ? m : 0, (c0 + j0 + u * step) * kRcTile + lane);
#pragma unroll
      for (int u = 0; u < kRcAhead; ++u) {
        const int j = j0 + u * step, r = (c0 + j) * kRcTile + lane;
        if (j < nc) put_boxes(s_box, j, tile_boxes(r < m, p[u].x, p[u].y, p[u].z), lane);
      }
    }
    cluster.sync();  // every block's share is written
    // the other blocks' shares, from their shared memory
    for (int j = threadIdx.x; j < nc; j += kRcThreads) {
      const int owner = j % kRcCluster;
      if (owner == rank) continue;
      const float* src = cluster.map_shared_rank(&s_box[0][0], owner) + j;
      float v[kRcBox];
#pragma unroll
      for (int c = 0; c < kRcBox; ++c) v[c] = src[c * kRcChunk];
#pragma unroll
      for (int c = 0; c < kRcBox; ++c) s_box[c][j] = v[c];
    }
    cluster.sync();  // every block's table is whole, and no block reads another's any more

    for (int qt = blockIdx.x; qt < qtiles; qt += gridDim.x) {
      const int qi = qt * kRcTile + lane;
      const bool qin = qi < n;
      const float qx = qnext.x, qy = qnext.y, qz = qnext.z;
      if (qt + (int)gridDim.x < qtiles) qnext = query(qt + (int)gridDim.x);
      const TileBoxes qb = tile_boxes(qin, qx, qy, qz);
      if (threadIdx.x == 0) s_nlist = 0;
      __syncthreads();  // also: the previous query tile is done with s_list and s_cnt
      int cnt = 0;
      for (int first = warp * kRcTile; first < nc; first += kRcThreads) {
        const int j = first + lane;  // this lane's target tile c0 + j
        bool full = false, point = false;
        float px = 0.0f, py = 0.0f, pz = 0.0f;
        int pn = 0;
        if (j < nc) {
          const TileBoxes tb = get_boxes(s_box, j);
          const bool to_valid = reach(qb.v, tb.v, r2) || reach(qb.o, tb.v, r2);
          const bool to_other = reach(qb.v, tb.o, r2) || reach(qb.o, tb.o, r2);
          full = to_valid || (to_other && !one_point(tb.o));
          point = !full && to_other;
          px = tb.o.lo[0]; py = tb.o.lo[1]; pz = tb.o.lo[2];
          pn = tb.o.n;
        }
        // tiles whose reachable rows are one point: one test for all that share it
        unsigned mp = __ballot_sync(kFull, point);
        npoint += __popc(mp);
        if (mp) {
          const int s0 = __ffs(mp) - 1;
          const float x0 = __shfl_sync(kFull, px, s0), y0 = __shfl_sync(kFull, py, s0), z0 = __shfl_sync(kFull, pz, s0);
          if (__all_sync(kFull, !point || (px == x0 && py == y0 && pz == z0))) {
            const int c = __reduce_add_sync(kFull, point ? pn : 0);
            cnt += dist2(qx - x0, qy - y0, qz - z0) < r2 ? c : 0;
          } else {
            while (mp) {
              const int s = __ffs(mp) - 1;
              mp &= mp - 1;
              const float x = __shfl_sync(kFull, px, s), y = __shfl_sync(kFull, py, s), z = __shfl_sync(kFull, pz, s);
              cnt += dist2(qx - x, qy - y, qz - z) < r2 ? __shfl_sync(kFull, pn, s) : 0;
            }
          }
        }
        // the other tiles not skipped go to the block's list (room for every tile of the chunk)
        const unsigned mf = __ballot_sync(kFull, full);
        nfull += __popc(mf);
        if (mf == 0) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_nlist, __popc(mf));
        base = __shfl_sync(kFull, base, 0) + __popc(mf & lt_mask);
        if (full) s_list[base] = j;
      }
      __syncthreads();
      // the listed tiles, kRcStage at a time: the block reads their rows at
      // once (one row a thread and step, coalesced), then warp w counts the
      // staged tiles w, w + kRcWarps, ...
      const int listed = s_nlist;
      for (int s0 = 0; s0 < listed; s0 += kRcStage) {
        const int rows = min(kRcStage, listed - s0) * kRcTile;
#pragma unroll
        for (int i = 0; i < kRcStage * kRcTile / kRcThreads; ++i) {
          const int e = threadIdx.x + i * kRcThreads;
          if (e < rows) s_stage[e] = tile_row(t, m, (c0 + s_list[s0 + e / kRcTile]) * kRcTile + e % kRcTile);
        }
        __syncthreads();
        for (int k = warp; k * kRcTile < rows; k += kRcWarps) cnt += count_tile(s_stage + k * kRcTile, qx, qy, qz, r2);
        __syncthreads();
      }
      s_cnt[warp][lane] = cnt;
      __syncthreads();
      if (warp == 0 && qin) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < kRcWarps; ++w) total += s_cnt[w][lane];
        out[qi] = c0 == 0 ? total : out[qi] + total;
      }
    }
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(stats, nfull);
    atomicAdd(stats + 1, npoint);
  }
}

}  // namespace

extern "C" {

// out[i] = #{j : |q_i - t_j|^2 < r2} in one launch: a block per query tile,
// rounded up to whole clusters, at most the clusters resident at once.
int hgs_radius_count_cluster(const float* q, int n, const float* t, int m, float r2, int* out, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)radius_count_kernel;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRcCluster);
  cfg.blockDim = dim3(kRcThreads);
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  const int want = ((n + kRcTile - 1) / kRcTile + kRcCluster - 1) / kRcCluster;
  const int grid = (want < clusters ? want : clusters) * kRcCluster;
  radius_count_kernel<<<grid, kRcThreads, 0, (cudaStream_t)stream>>>(q, n, t, m, r2, nullptr, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
"""

VARIANTS = {
    **{f"cluster{c}": [("kRcCluster = 8;", f"kRcCluster = {c};"), ("kRcAhead = 8;", "kRcAhead = 1;")]
       for c in (1, 2, 4, 8)},
    "cluster4_ahead8": [("kRcCluster = 8;", "kRcCluster = 4;")],
    "cluster8_ahead8": [],
    "cluster8_ahead4": [("kRcAhead = 8;", "kRcAhead = 4;")],
    "cluster8_5blocks": [("__launch_bounds__(kRcThreads)", "__launch_bounds__(kRcThreads, 5)"),
                         ("kRcStage = 32;", "kRcStage = 16;")],
}


def build(name: str, out: Path) -> Path:
    from hdl_graph_slam_tpu_torch import kernels

    src = CLUSTER_CU
    for a, b in VARIANTS[name]:
        assert a in src, (name, a)
        src = src.replace(a, b)
    cu, lib = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return lib


def inputs() -> dict:
    """name -> (xyz (n, 3) on the card, radius)."""
    import torch

    import chip_smoke

    g0, g1 = chip_smoke._golden_scan(0), chip_smoke._golden_scan(1)
    frames = {"kf4096": (chip_smoke.golden_cloud(g0).valid_xyz().contiguous(), chip_smoke.RADIUS_M)}
    for preset in chip_smoke.RADIUS_PRESETS:
        x, _, r = chip_smoke.radius_frame(g1, preset)
        frames[f"{preset}16384"] = (x, r)
    rng = np.random.default_rng(0)
    odd = rng.uniform(-3.0, 3.0, (300, 3)).astype(np.float32)
    odd[260:] = 1.0e6
    odd[5:11] = [[2e5, 0, 0], [2e5, 0, 0.3], [np.nan, 0, 0], [np.inf, 0, 0], [-0.0, 0, -0.0], [0, -0.0, 0]]
    frames["odd_rows"] = (torch.from_numpy(odd).cuda(), 1.0)
    frames["cube40000"] = (torch.from_numpy(rng.uniform(0.0, 1.0, (40000, 3)).astype(np.float32)).cuda(), 0.8)
    frames["uniform20000"] = (torch.from_numpy(rng.uniform(-60, 60, (20000, 3)).astype(np.float32)).cuda(), 5.0)
    return frames


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    import chip_smoke
    from hdl_graph_slam_tpu_torch import kernels
    from hdl_graph_slam_tpu_torch.ops import knn

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS) + 1) as ex:
        pkg = ex.submit(kernels.load, "knn")
        libs = dict(zip(VARIANTS, ex.map(lambda v: build(v, Path(tmp)), VARIANTS)))
        pkg.result()
        print(json.dumps({"built_s": time.time() - t0}), flush=True)
        frames = inputs()
        ref = {k: knn.radius_count(x, x, r) for k, (x, r) in frames.items()}
        calls = {"package": {k: (lambda x=x, r=r: knn.radius_count(x, x, r)) for k, (x, r) in frames.items()}}
        outs = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.hgs_radius_count_cluster.argtypes = [p, i, p, i, ctypes.c_float, p, p]
            lib.hgs_radius_count_cluster.restype = i
            calls[name] = {}
            for k, (x, r) in frames.items():
                out = outs[name, k] = torch.empty(x.shape[0], dtype=torch.int32, device="cuda")

                def call(lib=lib, x=x, r=r, out=out):
                    e = lib.hgs_radius_count_cluster(x.data_ptr(), x.shape[0], x.data_ptr(), x.shape[0], r * r,
                                                     out.data_ptr(), kernels.stream(x))
                    if e:
                        raise RuntimeError(f"launch failed: cudaError {e}")
                calls[name][k] = call
        for rnd in range(args.rounds):
            for name, per in calls.items():
                row = {}
                for k, call in per.items():
                    call()
                    torch.cuda.synchronize()
                    same = name == "package" or bool(torch.equal(outs[name, k], ref[k]))
                    row[k] = dict(device_ms=chip_smoke.time_ms(call, device_only=True),
                                  kernel_ms=chip_smoke.time_ms(call), same=same)
                print(json.dumps({"round": rnd, "variant": name, "inputs": row}), flush=True)
    print(json.dumps({"seconds": time.time() - t0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
