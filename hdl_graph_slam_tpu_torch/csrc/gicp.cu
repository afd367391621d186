// GICP association and linearization for Hopper (sm_90a), fp32 on CUDA cores.
// Plain C interface, loaded with ctypes by
// hdl_graph_slam_tpu_torch/kernels/__init__.py; the wrappers and their plain
// PyTorch twins live in hdl_graph_slam_tpu_torch/registration/gicp.py.
//
// The JAX package runs these steps of its GICP LM loop as XLA programs
// (hdl_graph_slam_tpu/registration/gicp.py); there is no Pallas kernel to
// port. Each kernel replaces one of them:
//
// gicp_associate_kernel: gicp.py:116 _associate after its 1-NN search, and
//   vgicp.py:112 _associate after its voxel lookup. One thread per (problem
//   b, source point i): the gate (GICP: src.mask & tgt.mask[idx] & (d2 <
//   max_corr_dist^2) from nn1's (idx, d2); VGICP: the lookup's found flag),
//   M = inv3x3(C_tgt[idx] + R C_src R^T) by the adjugate with |det| clamped
//   at 1e-20 (gicp.py:86 _inv3x3), M times the gate as 0.0 / 1.0, written as
//   the (B, n, 3, 3) Mw the LM carries, and the valid rows of each problem
//   counted in int32. Every product and sum is an IEEE __fmul_rn / __fadd_rn
//   (never contracted into an FMA) in the order of the plain twin's
//   elementwise ops, and 1 / det is the correctly rounded __frcp_rn, so the
//   kernel gives the plain twin's bits.
//
// gicp_linearize_kernel: gicp.py:131 _linearize_at and :147 _cost_at (and
//   vgicp.py:124 / :138, the voxel means as the target points). One thread
//   per point of a problem, at its pose T: p = T a, e = x_tgt[idx] - p,
//   Me = M e, and with S = hat(p) and J = [-I | S] (never formed)
//     b += J^T M e = [-Me, S^T Me],   cost += e.Me,
//     H += J^T M J = [[M, -M S], [S M, -S M S]]   (upper triangle),
//   6 + 21 + 1 = 28 sums per thread. The cost_only instantiation adds the
//   cost alone and leaves the other 27 at 0 through the same reduction, so
//   its cost has the full call's bits.
//
// One launch per call. Each block of the linearization writes its partial
// row and draws a ticket from its problem's int32 counter; the block with
// the last ticket sums the problem's rows in float64 and writes (B, 43)
// rows of b (6), H (36, symmetric) and cost, then sets the counter back to 0
// (csrc/ndt.cu's pattern). The association's blocks add their valid counts
// into an int32 counter and draw a ticket the same way; the last block
// takes the count out of the counter (leaving 0) as num. The wrapper keeps
// the counters per (device, stream), zeroed once when made.
//
// Every kernel takes a leading batch B of problems sharing one target (the
// loop detector's candidates; odometry has B = 1) in the last grid
// dimension. The grid depends only on n, each thread's points and each
// sum's order are fixed by it, and the finish's order does not depend on
// which block came last: two runs on one card agree bit for bit, and row b
// of a batch has the bits of the batch of one. No float atomics, no host
// read, no allocation: a CUDA graph can capture both.
//
// Bound. At the main path's shape (8192 rows, ~6400 valid) the association
// must read each row's source covariance, gate inputs and index (~50 B),
// each named target covariance (36 B) and write its Mw (36 B): ~1.0 MB, 0.3 us
// at 3.35 TB/s. The linearization reads each row's point, index and Mw and
// the target point it names (~64 B): ~0.5 MB, 0.16 us, and does ~130 fp32
// operations a row (~1 MFLOP, 0.016 us). Both are latency bound: the launch,
// the dependent gather behind each index, and for the linearization the
// block sum, the ticket and the last block's read of every partial row.
// One point per thread gives 32 blocks of 256 threads at n = 8192 (16 a
// problem at the loop's 4096); the partial rows are 128-byte lines of their
// own, and the last block reads them whole, a warp four rows a load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block of both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // linearization blocks (partial rows) per problem, at most
constexpr int kFinishLoads = 16;  // partial rows a lane of the finish loads at once
constexpr int kRow = 32;  // floats per partial row (kWidth used)
constexpr int kWidth = 28;  // b (6), H upper triangle (21), cost (1)
constexpr int kOut = 43;  // b (6), H (36), cost (1)
constexpr unsigned kFull = 0xffffffffu;

// The linearization's blocks per problem for n points: one point per
// thread up to kMaxBlocks blocks, then a grid-stride loop.
int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks;
}

// -- association ------------------------------------------------------------------

// x * y + z * w and x * y - z * w with both products and the sum rounded, as
// the plain twin's elementwise ops round them
__device__ __forceinline__ float mul_add(float x, float y, float z, float w) {
  return __fadd_rn(__fmul_rn(x, y), __fmul_rn(z, w));
}
__device__ __forceinline__ float mul_sub(float x, float y, float z, float w) {
  return __fsub_rn(__fmul_rn(x, y), __fmul_rn(z, w));
}

// Whether this block is the last of its problem to finish: every thread
// fences its writes, then thread 0 draws a ticket from the problem's
// counter. The last ticket resets the counter to 0 for the next launch;
// kernels on one stream do not overlap, so every launch on it finds 0.
__device__ __forceinline__ bool last_block(int* __restrict__ ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  return last;
}

// counters: B tickets, then B valid counts, all 0 on entry and on exit.
// found == nullptr takes the GICP gate from d2, smask and tmask.
__global__ void __launch_bounds__(kThreads)
gicp_associate_kernel(const float* __restrict__ T, int n, const float* __restrict__ src_covs,
                      const float* __restrict__ tgt_covs, const int* __restrict__ idx, const float* __restrict__ d2,
                      const unsigned char* __restrict__ smask, const unsigned char* __restrict__ tmask, float max_d2,
                      const unsigned char* __restrict__ found, int* __restrict__ counters, float* __restrict__ Mw,
                      int* __restrict__ num) {
  __shared__ float sR[3][3];
  const int b = blockIdx.y, i = blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x < 9) sR[threadIdx.x / 3][threadIdx.x % 3] = T[16 * b + 4 * (threadIdx.x / 3) + threadIdx.x % 3];
  __syncthreads();
  bool valid = false;
  if (i < n) {
    const size_t row = (size_t)b * n + i;
    const int j = idx[row];
    valid = found != nullptr ? found[row] != 0 : (smask[row] != 0 && tmask[j] != 0 && d2[row] < max_d2);
    float C[3][3], A[3][3];
#pragma unroll
    for (int e = 0; e < 9; ++e) C[e / 3][e % 3] = src_covs[9 * row + e];
    // RC = R C, then A = C_tgt + (RC) R^T, each sum of three products left to right
    float RC[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        RC[r][c] = __fadd_rn(mul_add(sR[r][0], C[0][c], sR[r][1], C[1][c]), __fmul_rn(sR[r][2], C[2][c]));
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        A[r][c] = __fadd_rn(__ldg(tgt_covs + 9 * (size_t)j + 3 * r + c),
                            __fadd_rn(mul_add(RC[r][0], sR[c][0], RC[r][1], sR[c][1]), __fmul_rn(RC[r][2], sR[c][2])));
    // gicp.py _inv3x3: the adjugate over the determinant, |det| clamped at 1e-20
    const float a = A[0][0], bb = A[0][1], c = A[0][2], d = A[1][0], e = A[1][1], f = A[1][2];
    const float g = A[2][0], h = A[2][1], k = A[2][2];
    const float cA = mul_sub(e, k, f, h), cB = -mul_sub(d, k, f, g), cC = mul_sub(d, h, e, g);
    const float det = __fadd_rn(mul_add(a, cA, bb, cB), __fmul_rn(c, cC));
    const float inv_det = __frcp_rn(fabsf(det) < 1e-20f ? 1e-20f : det);
    const float adj[9] = {cA, -mul_sub(bb, k, c, h), mul_sub(bb, f, c, e),
                          cB, mul_sub(a, k, c, g), -mul_sub(a, f, c, d),
                          cC, -mul_sub(a, h, bb, g), mul_sub(a, e, bb, d)};
    const float vf = valid ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < 9; ++q) Mw[9 * row + q] = __fmul_rn(__fmul_rn(adj[q], inv_det), vf);
  }
  const int count = __syncthreads_count(valid);
  if (threadIdx.x == 0 && count > 0) atomicAdd(counters + gridDim.y + b, count);
  if (last_block(counters + b) && threadIdx.x == 0) num[b] = atomicExch(counters + gridDim.y + b, 0);
}

// -- linearization ----------------------------------------------------------------

// One level of block_sum's recursive halving across a warp: a lane hands
// the partner H lanes away the half of its first 2H values it gives up and
// adds the partner's copy of the half it keeps into v[0..H). After the
// levels H = 16, ..., 1, lane l holds the warp's sum of value l.
template <int H>
__device__ __forceinline__ void halve(float (&v)[kRow], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float give = up ? v[i] : v[i + H], keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, give, H);
  }
  if constexpr (H > 1) halve<H / 2>(v, lane);
}

// Sum the first kWidth values of each thread over the block in a fixed
// order into out[0..kWidth): inside each warp by recursive halving (31
// shuffles), then the warps in order.
__device__ __forceinline__ void block_sum(float (&v)[kRow], float* __restrict__ out) {
  __shared__ float s[kWarps][kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  halve<kRow / 2>(v, lane);
  s[warp][lane] = v[0];
  __syncthreads();
  if ((int)threadIdx.x < kWidth) {
    float x = s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += s[w][threadIdx.x];
    out[threadIdx.x] = x;
  }
}

// The first kRow floats of a problem's nblk partial rows (row blk at
// p + blk * kRow, 16-byte aligned; written by other blocks of this launch:
// read past L1) summed over the blocks in float64 into s[0..kRow), in an
// order that does not depend on which block came last: a warp reads four
// whole rows at a time (lane l the float4 l % 8 of row l / 8), each lane
// adds its rows in turn, kFinishLoads of them loaded at once; then the lanes
// of one float4 column add in a shuffle tree, and the warps in order.
__device__ __forceinline__ void sum_partials(const float* __restrict__ p, int nblk, double* __restrict__ s) {
  constexpr int Q = kRow / 4, RW = 32 / Q, RB = kWarps * RW;
  __shared__ double sw[kWarps][kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane % Q;
  const float4* p4 = reinterpret_cast<const float4*>(p) + q;
  const int r0 = warp * RW + lane / Q;
  double x[4] = {0.0, 0.0, 0.0, 0.0};
  for (int base = r0; base < nblk; base += kFinishLoads * RB) {
    float4 v[kFinishLoads];
#pragma unroll
    for (int u = 0; u < kFinishLoads; ++u) {
      const int r = base + u * RB;
      v[u] = r < nblk ? __ldcg(p4 + (size_t)r * Q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kFinishLoads; ++u) {
      x[0] += (double)v[u].x; x[1] += (double)v[u].y; x[2] += (double)v[u].z; x[3] += (double)v[u].w;
    }
  }
#pragma unroll
  for (int off = Q; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] += __shfl_xor_sync(kFull, x[e], off);
  if (lane < Q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sw[warp][4 * q + e] = x[e];
  }
  __syncthreads();
  if ((int)threadIdx.x < kRow) {
    double y = sw[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) y += sw[w][threadIdx.x];
    s[threadIdx.x] = y;
  }
  __syncthreads();
}

template <bool kCostOnly>
__global__ void __launch_bounds__(kThreads)
gicp_linearize_kernel(const float* __restrict__ T, int n, const float* __restrict__ xyz, const int* __restrict__ idx,
                      const float* __restrict__ Mw, const float* __restrict__ tgt, float* __restrict__ partial,
                      int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ float sT[16];
  const int b = blockIdx.y;
  if (threadIdx.x < 16) sT[threadIdx.x] = T[16 * b + threadIdx.x];
  __syncthreads();
  float acc[kRow];
#pragma unroll
  for (int j = 0; j < kRow; ++j) acc[j] = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const size_t row = (size_t)b * n + i;
    const int j = idx[row];
    const float x = xyz[3 * row], y = xyz[3 * row + 1], z = xyz[3 * row + 2];
    float M[3][3];
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e / 3][e % 3] = Mw[9 * row + e];
    float p[3], ev[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      p[r] = fmaf(sT[4 * r], x, fmaf(sT[4 * r + 1], y, fmaf(sT[4 * r + 2], z, sT[4 * r + 3])));
      ev[r] = __ldg(tgt + 3 * (size_t)j + r) - p[r];
    }
    float Me[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) Me[r] = fmaf(M[r][0], ev[0], fmaf(M[r][1], ev[1], M[r][2] * ev[2]));
    acc[27] += fmaf(ev[0], Me[0], fmaf(ev[1], Me[1], ev[2] * Me[2]));
    if constexpr (!kCostOnly) {
      // b = [-Me, S^T Me] = [-Me, Me x p]
      acc[0] -= Me[0]; acc[1] -= Me[1]; acc[2] -= Me[2];
      acc[3] += Me[1] * p[2] - Me[2] * p[1];
      acc[4] += Me[2] * p[0] - Me[0] * p[2];
      acc[5] += Me[0] * p[1] - Me[1] * p[0];
      // S = hat(p): S v = p x v
      const float S[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
      float MS[3][3];  // M S
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) MS[r][c] = M[r][0] * S[0][c] + M[r][1] * S[1][c] + M[r][2] * S[2][c];
      float H[6][6];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          H[r][c] = M[r][c];
          H[r][3 + c] = -MS[r][c];
          // S^T M S = -S (M S)
          H[3 + r][3 + c] = -(S[r][0] * MS[0][c] + S[r][1] * MS[1][c] + S[r][2] * MS[2][c]);
        }
      int q = 6;
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int c = r; c < 6; ++c) acc[q++] += H[r][c];
    }
  }
  // one 128-byte partial row per block: no two blocks write one sector
  float* pb = partial + (size_t)b * gridDim.x * kRow;
  block_sum(acc, pb + (size_t)blockIdx.x * kRow);
  if (!last_block(tickets + b)) return;
  __shared__ double s[kRow];
  sum_partials(pb, gridDim.x, s);
  const int e = threadIdx.x;
  if constexpr (kCostOnly) {
    if (e == 0) out[b] = (float)s[27];
  } else {
    float* o = out + (size_t)b * kOut;
    if (e < 6) {
      o[e] = (float)s[e];
    } else if (e < 42) {
      const int rr = (e - 6) / 6, cc = (e - 6) % 6;
      const int lo = rr < cc ? rr : cc, hi = rr < cc ? cc : rr;
      // index of (lo, hi) in the row-major upper triangle
      o[e] = (float)s[6 + lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];
    } else if (e == 42) {
      o[e] = (float)s[27];
    }
  }
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = launched).

// B problems of n source rows against one target: T (B, 4, 4), src_covs
// (B, n, 3, 3), tgt_covs (M, 3, 3), idx (B, n) int32 -> Mw (B, n, 3, 3),
// num (B,) int32, one launch of ceil(n / kThreads) x B blocks. The gate is
// found (B, n) uint8 when given (VGICP), else smask (B, n) uint8 &
// tmask[idx] (M,) uint8 & (d2 (B, n) < max_d2) (GICP). counters holds 2 B
// int32, all 0 (each launch leaves them so).
int hgs_gicp_associate(const float* T, int batch, int n, const float* src_covs, const float* tgt_covs,
                       const int* idx, const float* d2, const unsigned char* smask, const unsigned char* tmask,
                       float max_d2, const unsigned char* found, int* counters, float* Mw, int* num, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || (found == nullptr && (d2 == nullptr || smask == nullptr ||
                                                                     tmask == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grd((n + kThreads - 1) / kThreads, batch);
  gicp_associate_kernel<<<grd, kThreads, 0, (cudaStream_t)stream>>>(T, n, src_covs, tgt_covs, idx, d2, smask, tmask,
                                                                     max_d2, found, counters, Mw, num);
  return (int)cudaGetLastError();
}

// b (B, 6), H (B, 6, 6), cost (B,) as out (B, 43) at the poses T (B, 4, 4)
// of xyz (B, n, 3) under idx (B, n) int32 and Mw (B, n, 3, 3) against the
// target points tgt (M, 3); with cost_only, the cost alone as out (B,). One
// launch; nblk must be blocks_for(n) (the wrapper computes it itself);
// partial is scratch of B * nblk * kRow floats, 16-byte aligned, and
// tickets B int32 counters, all 0 (each launch leaves them so).
int hgs_gicp_linearize(const float* T, int batch, int n, const float* xyz, const int* idx, const float* Mw,
                       const float* tgt, int cost_only, int nblk, float* partial, int* tickets, float* out,
                       void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || nblk != blocks_for(n)) return (int)cudaErrorInvalidValue;
  const dim3 grd(nblk, batch);
  if (cost_only)
    gicp_linearize_kernel<true><<<grd, kThreads, 0, (cudaStream_t)stream>>>(T, n, xyz, idx, Mw, tgt, partial,
                                                                            tickets, out);
  else
    gicp_linearize_kernel<false><<<grd, kThreads, 0, (cudaStream_t)stream>>>(T, n, xyz, idx, Mw, tgt, partial,
                                                                             tickets, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
