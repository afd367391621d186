// Exact brute-force nearest-neighbour kernels for Hopper (sm_90a), fp32 on
// CUDA cores. Plain C interface, loaded with ctypes by
// hdl_graph_slam_tpu_torch/kernels/__init__.py; the wrappers and their plain
// PyTorch twins live in hdl_graph_slam_tpu_torch/ops/knn.py.
//
// nn1_kernel replaces the TPU kernel hdl_graph_slam_tpu/ops/pallas_nn.py
// (nn1_pallas, body _nn_kernel) and its XLA twin ops/knn.py nn1: for each
// query the lowest-index target minimising |t|^2 - 2 q.t (coordinates centred
// on the bounding box of the valid targets, |x| < 1e5 on every axis), then the
// exact squared distance of the winner from the uncentred coordinates.
//
// knn_select_kernel replaces the XLA lowering of ops/knn.py knn_approx
// (lax.approx_min_k) as GICP preprocessing calls it: the exact k nearest
// targets of each query, ordered by (|t|^2 - 2 q.t, index), with the distance
// |t|^2 - 2 q.t + |q|^2 of the centred coordinates.
//
// Bound. At the main path's N = M = 8192 both kernels do N*M = 67 M pairs of
// 3 FMAs plus a compare (and, for knn_select, a rare insertion), and move only
// (N + M) * 12 bytes in and N * (8 or 8k) bytes out: they are bound by fp32
// operations, about 8 us at the H100's 67 TFLOP/s. The N x M distance field
// is never written to memory.
//
// Design. The TPU grid's sequential target axis becomes a loop inside each
// block, so nothing carries between blocks. A group of G consecutive lanes
// owns one query; a block stages TILE targets at a time in shared memory as
// centred float4(x, y, z, |t|^2), and lane g of a group scans entries g, g+G,
// g+2G, ... of every tile, so each lane sees its targets in ascending index
// order and a strict '<' keeps the lowest index among equal distances. The
// G partial results are merged with warp shuffles under the lexicographic
// (distance, index) order, which keeps that tie rule exact. Every block first
// reduces the valid-target bounding box itself (M reads from L2), so one
// launch does the whole function. Distances are fp32 FMA chains, never TF32.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kBlock = 256;            // threads per block
constexpr int kGroup = 4;              // lanes per query
constexpr int kQueries = kBlock / kGroup;
constexpr int kTile = kBlock;          // targets staged per tile (one per thread)
constexpr float kValidAbs = 1.0e5f;    // |coordinate| bound of a valid target
constexpr int kK = 20;                 // knn_select's k (GICP's correspondence_randomness)

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// Centre of the valid targets' bounding box, as ops/knn.py nn1 computes it:
// lo = min(where(valid, t, 1e5)), hi = max(where(valid, t, -1e5)),
// centre = hi >= lo ? 0.5 (lo + hi) : 0, per axis. Every thread of the block
// receives it in `c`.
__device__ void block_center(const float* __restrict__ t, int m, float c[3]) {
  __shared__ float s_lo[3][kBlock];
  __shared__ float s_hi[3][kBlock];
  float lo[3] = {kValidAbs, kValidAbs, kValidAbs};
  float hi[3] = {-kValidAbs, -kValidAbs, -kValidAbs};
  for (int j = threadIdx.x; j < m; j += kBlock) {
    float x = t[3 * j], y = t[3 * j + 1], z = t[3 * j + 2];
    if (fabsf(x) < kValidAbs && fabsf(y) < kValidAbs && fabsf(z) < kValidAbs) {
      lo[0] = fminf(lo[0], x); lo[1] = fminf(lo[1], y); lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x); hi[1] = fmaxf(hi[1], y); hi[2] = fmaxf(hi[2], z);
    }
  }
  for (int a = 0; a < 3; ++a) { s_lo[a][threadIdx.x] = lo[a]; s_hi[a][threadIdx.x] = hi[a]; }
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      for (int a = 0; a < 3; ++a) {
        s_lo[a][threadIdx.x] = fminf(s_lo[a][threadIdx.x], s_lo[a][threadIdx.x + s]);
        s_hi[a][threadIdx.x] = fmaxf(s_hi[a][threadIdx.x], s_hi[a][threadIdx.x + s]);
      }
    }
    __syncthreads();
  }
  for (int a = 0; a < 3; ++a) {
    float l = s_lo[a][0], h = s_hi[a][0];
    c[a] = h >= l ? 0.5f * (l + h) : 0.0f;
  }
  __syncthreads();
}

// Stage targets [base, base + kTile) centred, with |t|^2 in .w.
__device__ __forceinline__ void stage_tile(const float* __restrict__ t, int m, int base,
                                           const float c[3], float4* tile) {
  int j = base + threadIdx.x;
  if (j < m) {
    float x = t[3 * j] - c[0], y = t[3 * j + 1] - c[1], z = t[3 * j + 2] - c[2];
    tile[threadIdx.x] = make_float4(x, y, z, x * x + y * y + z * z);
  }
}

__global__ void __launch_bounds__(kBlock)
nn1_kernel(const float* __restrict__ q, int n, const float* __restrict__ t, int m,
           int* __restrict__ idx_out, float* __restrict__ dist2_out) {
  __shared__ float4 tile[kTile];
  float c[3];
  block_center(t, m, c);

  const int g = threadIdx.x % kGroup;
  const int qi = blockIdx.x * kQueries + threadIdx.x / kGroup;
  const bool active = qi < n;
  const int qr = active ? qi : 0;
  const float qx = q[3 * qr], qy = q[3 * qr + 1], qz = q[3 * qr + 2];
  // -2 (q - c): d = |t|^2 - 2 q.t is then three FMAs on the staged tile
  const float ax = -2.0f * (qx - c[0]), ay = -2.0f * (qy - c[1]), az = -2.0f * (qz - c[2]);

  float best_d = INFINITY;
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    stage_tile(t, m, base, c, tile);
    __syncthreads();
    const int count = min(kTile, m - base);
    for (int j = g; j < count; j += kGroup) {
      const float4 p = tile[j];
      const float d = fmaf(ax, p.x, fmaf(ay, p.y, fmaf(az, p.z, p.w)));
      if (d < best_d) { best_d = d; best_i = base + j; }
    }
  }
  // merge the group's G partial winners (lane g = 0 ends with the result)
  for (int s = 1; s < kGroup; s <<= 1) {
    const float od = __shfl_down_sync(0xffffffffu, best_d, s, kGroup);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, s, kGroup);
    if (lex_less(od, oi, best_d, best_i)) { best_d = od; best_i = oi; }
  }
  if (active && g == 0) {
    const float dx = qx - t[3 * best_i], dy = qy - t[3 * best_i + 1], dz = qz - t[3 * best_i + 2];
    idx_out[qi] = best_i;
    dist2_out[qi] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
}

// Insert (d, i) into the (distance, index)-sorted register list; the caller
// has checked that it beats the last entry. Fully unrolled so the list stays
// in registers.
__device__ __forceinline__ void insert_sorted(float (&bd)[kK], int (&bi)[kK], float d, int i) {
#pragma unroll
  for (int j = kK - 1; j > 0; --j) {
    if (lex_less(d, i, bd[j - 1], bi[j - 1])) {
      bd[j] = bd[j - 1]; bi[j] = bi[j - 1];
    } else if (lex_less(d, i, bd[j], bi[j])) {
      bd[j] = d; bi[j] = i;
    }
  }
  if (lex_less(d, i, bd[0], bi[0])) { bd[0] = d; bi[0] = i; }
}

__global__ void __launch_bounds__(kBlock)
knn_select_kernel(const float* __restrict__ q, int n, const float* __restrict__ t, int m,
                  int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ float4 tile[kTile];
  float c[3];
  block_center(t, m, c);

  const int g = threadIdx.x % kGroup;
  const int qi = blockIdx.x * kQueries + threadIdx.x / kGroup;
  const bool active = qi < n;
  const int qr = active ? qi : 0;
  const float cx = q[3 * qr] - c[0], cy = q[3 * qr + 1] - c[1], cz = q[3 * qr + 2] - c[2];
  const float ax = -2.0f * cx, ay = -2.0f * cy, az = -2.0f * cz;

  float bd[kK];
  int bi[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) { bd[j] = INFINITY; bi[j] = INT_MAX; }

  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    stage_tile(t, m, base, c, tile);
    __syncthreads();
    const int count = min(kTile, m - base);
    for (int j = g; j < count; j += kGroup) {
      const float4 p = tile[j];
      const float d = fmaf(ax, p.x, fmaf(ay, p.y, fmaf(az, p.z, p.w)));
      // indices ascend along a lane, so '<' on the distance alone is the
      // lexicographic test against the current k-th entry
      if (d < bd[kK - 1]) insert_sorted(bd, bi, d, base + j);
    }
  }
  // tree merge of the group's G sorted lists into lane g = 0; a sending lane
  // never modifies its list in the round it sends
  for (int s = 1; s < kGroup; s <<= 1) {
    const bool receiver = (g % (2 * s)) == 0;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const float od = __shfl_down_sync(0xffffffffu, bd[j], s, kGroup);
      const int oi = __shfl_down_sync(0xffffffffu, bi[j], s, kGroup);
      if (receiver && lex_less(od, oi, bd[kK - 1], bi[kK - 1])) insert_sorted(bd, bi, od, oi);
    }
  }
  if (active && g == 0) {
    const float qn = cx * cx + cy * cy + cz * cz;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      idx_out[(size_t)qi * kK + j] = bi[j];
      dist_out[(size_t)qi * kK + j] = bd[j] + qn;
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int hgs_nn1(const float* q, int n, const float* t, int m, int* idx, float* dist2, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  nn1_kernel<<<(n + kQueries - 1) / kQueries, kBlock, 0, (cudaStream_t)stream>>>(q, n, t, m, idx, dist2);
  return (int)cudaGetLastError();
}

// k must equal kK (20); m >= k.
int hgs_knn_select(const float* q, int n, const float* t, int m, int k, int* idx, float* dist,
                   void* stream) {
  if (n <= 0 || k != kK || m < kK) return (int)cudaErrorInvalidValue;
  knn_select_kernel<<<(n + kQueries - 1) / kQueries, kBlock, 0, (cudaStream_t)stream>>>(q, n, t, m, idx, dist);
  return (int)cudaGetLastError();
}

}  // extern "C"
