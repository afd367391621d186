// NDT association, derivative and trial-score reductions for Hopper (sm_90a),
// fp32 on CUDA cores. Plain C interface, loaded with ctypes by
// hdl_graph_slam_tpu_torch/kernels/__init__.py; the wrappers and their plain
// PyTorch twins live in hdl_graph_slam_tpu_torch/registration/ndt.py.
//
// The JAX package runs these steps of its NDT Newton loop
// (hdl_graph_slam_tpu/registration/ndt.py) as XLA programs; there is no
// Pallas kernel to port. Each kernel replaces one of them:
//
// ndt_associate_kernel: ndt.py:101 _gather_cells with ops/voxel.py:433
//   neighbor_query_keys and :190 lookup_dense (or :405 lookup_voxels when
//   the target has no dense grid). Per source point: transform by T, cell
//   coordinates floor(x / res) (a true fp32 division, as the plain twin's
//   division by a float32 tensor), the K = 1 or 7 neighbour cells
//   (voxel.py neighbor_offsets order) relative to the target's origin, then
//   one read of the dense (G^3,) cell -> row grid, or a binary search of the
//   sorted key table. Out-of-grid cells are not found; their row is the one
//   the JAX function returns (grid cell 0, or the clipped search position).
//   It runs on the reductions' pair grid, one (point, cell) pair a thread,
//   K a template argument: every thread does its own grid read or search,
//   and the idx and found stores of a warp are consecutive.
//
// ndt_derivatives_kernel: ndt.py:155 score_derivatives over :91
//   _gather_mean_icov. One thread per (point, cell) pair of the (n, K)
//   association: for a found pair of a valid point, p = T x, the cell's
//   (12,) [mean | icov] row read by the thread itself, q = p - mu, a = B q,
//   u = max(q.a, 0), E = d1 exp(-d2/2 u), ea = E a and the pair's
//   M = -d2 E a a^T + E B. At a fixed p, ndt.py's block algebra (:200-233)
//   is linear in (M, ea), so each pair adds its own (unscaled by -d2)
//     g  += [ea, p x ea]
//     Hvv += M,  Hvw += -M Hp + hat(ea)/2,
//     Hww += -Hp M Hp + (ea p^T + p ea^T)/2 - (ea.p) I,   Hp = hat(p),
//   and the point's K pairs need not meet: the sum over pairs is the sum of
//   the per-point moments (tests/test_torch_ndt_kernels.py). 6 + 21 (the
//   upper triangle) + 1 (score) sums per thread, a fixed-order block sum
//   into the block's partial row, then the finish below writes g = -d2 g,
//   the symmetric H = -d2 H and the score.
//
// ndt_score_kernel: ndt.py:137 _score under the line search's vmap (:399).
//   The same pair grid, no trial dimension: the problem's L <= kMaxTrials
//   poses sit in shared memory, and each thread reads its point, flags,
//   cell index and cell row once and scores them under all L poses, L sums
//   per thread. L = 10 is the line search, L = 1 the full score and the
//   final error; re-associated trials come as B * L problems of L = 1.
//
// One launch per call. Each block of a reduction writes its partial row
// and draws a ticket from its problem's int32 counter; the block with the
// last ticket sums the problem's rows in float64 and writes the output
// (sum_partials), then sets the counter back to 0. The wrapper keeps the
// counters per (device, stream), zeroed once when made.
//
// Every kernel takes a leading batch B of problems sharing one target (the
// loop detector's candidates; odometry has B = 1) in the last grid
// dimension; the unbatched wrappers are B = 1 of the same launch.
//
// Determinism: no float atomics. The grid depends only on n and K, each
// thread's pairs and each sum's order are fixed by it, and the finish's
// order does not depend on which block came last, so two runs on one card
// agree bit for bit and a batch of B gives each problem the bits of the
// batch of one (chip_smoke.py's gates).
//
// Bound. At ndt_main's shape (8192 rows, 6744 valid, K = 7, ~24.5k found
// pairs, ~320 cells) the association must read ~0.28 MB (flags, points, the
// grid cell of each in-grid key) and write 0.29 MB of idx and found: 0.17 us
// at 3.35 TB/s. The derivatives must read ~0.25 MB (points, flags, indices of
// found pairs, each named cell row once) and do ~2.9 MFLOP (chip_smoke.py
// ndt_bounds): under 0.1 us either way; the 10 trials ~7 MFLOP. What bounds
// all three is latency: the launch, the chain of dependent loads of a pair
// (its point, its grid cell or its search; for the reductions the cell row
// behind its index), and for the reductions the block sum, the ticket and
// the last block's read of every partial row. One point per thread would
// give 32 blocks of 256 threads on 132 SMs at n = 8192, each thread walking
// its K cells (K grid reads, or K searches of log2 V dependent loads) in
// series, with found stored a byte every K; a trial per block would read the
// association L times. The pair grid gives 224 blocks of 256 threads at n =
// 8192 x 7 (448 at the imu path's 16384), each thread one dependent chain;
// the block sum halves across a warp (block_sum); each block's partial row
// is a 128-byte (or 64-byte) line of its own, and the last block reads the
// rows whole, a warp four (or eight) rows a load (sum_partials). The cell
// rows stay in global memory: at max_voxels 16384 the (V, 12) table reaches
// 786 KB, and no measurement shows the gathers bound the kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block of the three kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // blocks (partial rows) per problem, at most
constexpr int kMaxK = 8;  // DIRECT7 = 7, KDTREE = 8 (ndt.py _KDTREE_MAX_CELLS)
constexpr int kMaxTrials = 16;  // trial poses per problem of one score launch
constexpr int kFinishLoads = 16;  // partial rows a lane of the finish loads at once
constexpr int kDerivRow = 32;  // floats per partial row of the derivatives (28 used)
constexpr int kScoreRow = kMaxTrials;  // floats per partial row of the scores (L used)
constexpr int kLocalBits = 10;
constexpr int kLocalRange = 1 << kLocalBits;
constexpr int kLocalInvalid = 0x7fffffff;
constexpr int kDerivWidth = 28;  // g (6), H upper triangle (21), score (1)
constexpr int kDerivOut = 43;  // g (6), H (36), score (1)
constexpr unsigned kFull = 0xffffffffu;

// voxel.py neighbor_offsets: DIRECT1 is the first row, DIRECT7 all seven
__constant__ int c_offsets[7][3] = {{0, 0, 0}, {1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                                    {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};

// The blocks per problem of every kernel here for n x K (point, cell) pairs:
// one pair per thread up to kMaxBlocks blocks, then a grid-stride loop.
int blocks_for(int pairs) {
  const int b = (pairs + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks;
}

// p = R x + t for a row-major 4x4 T (the fp32 FMA chain; the plain twin's
// matmul rounds the same sum in another order).
__device__ __forceinline__ void transform(const float* __restrict__ T, float x, float y, float z, float p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r] = fmaf(T[4 * r], x, fmaf(T[4 * r + 1], y, fmaf(T[4 * r + 2], z, T[4 * r + 3])));
}

__device__ __forceinline__ void load_row(const float4* __restrict__ rows, int i, float mu[3], float B[9]) {
  const float4 a = __ldg(rows + 3 * i), b = __ldg(rows + 3 * i + 1), c = __ldg(rows + 3 * i + 2);
  mu[0] = a.x; mu[1] = a.y; mu[2] = a.z;
  B[0] = a.w; B[1] = b.x; B[2] = b.y;
  B[3] = b.z; B[4] = b.w; B[5] = c.x;
  B[6] = c.y; B[7] = c.z; B[8] = c.w;
}

// One level of block_sum's recursive halving across a warp: a lane hands
// the partner H lanes away the half of its first 2H values it gives up and
// adds the partner's copy of the half it keeps into v[0..H). After the
// levels H = 16 (or 8), ..., 1, lane l holds the warp's sum of value l.
template <int H, int W>
__device__ __forceinline__ void halve(float (&v)[W], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float give = up ? v[i] : v[i + H], keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, give, H);
  }
  if constexpr (H > 1) halve<H / 2, W>(v, lane);
}

// Sum the first width <= W values of each thread over the block in a fixed
// order into out[0..width): inside each warp by recursive halving (W - 1
// shuffles for W = 32, 31 for W = 16, where a 5-level tree per value takes
// 5 W: the shuffles bounded the pair grid at 448 blocks), then the warps in
// order. One value (width == 1) takes the plain 5-level tree.
template <int W>
__device__ __forceinline__ void block_sum(float (&v)[W], int width, float* __restrict__ out) {
  static_assert(W == 16 || W == 32, "halving over a warp");
  __shared__ float s[kWarps][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (width == 1) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[0] += __shfl_down_sync(kFull, v[0], off);
  } else {
    if constexpr (W == 16) {
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] += __shfl_xor_sync(kFull, v[i], 16);
    }
    halve<W / 2, W>(v, lane);
  }
  if (lane < W) s[warp][lane] = v[0];
  __syncthreads();
  if ((int)threadIdx.x < width) {
    float x = s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += s[w][threadIdx.x];
    out[threadIdx.x] = x;
  }
}

// -- association --------------------------------------------------------------

// One (point, cell) pair a thread: thread t of problem b takes point t / K
// and neighbour cell t % K, transforms the point (the same FMA chain and
// division as every other pair of the point, so the K pairs agree on its
// cell), forms its one key and does its one grid read or binary search;
// consecutive threads write consecutive idx and found entries.
template <int K>
__global__ void __launch_bounds__(kThreads)
ndt_associate_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                     const float* __restrict__ T, int n, const int* __restrict__ origin, float res,
                     const int* __restrict__ grid, int G, const int* __restrict__ keys,
                     const unsigned char* __restrict__ vmask, int V, int* __restrict__ idx_out,
                     unsigned char* __restrict__ found_out) {
  const int b = blockIdx.y, pairs = n * K;
  const int lim = G > 0 ? (G < kLocalRange ? G : kLocalRange) : kLocalRange;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < pairs; t += gridDim.x * kThreads) {
    const int i = t / K, k = t - i * K;
    const size_t row = (size_t)b * n + i, pair = (size_t)b * pairs + t;
    float p[3];
    transform(T + 16 * b, xyz[3 * row], xyz[3 * row + 1], xyz[3 * row + 2], p);
    const bool valid = mask[row] != 0;
    int r[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) r[a] = (int)floorf(p[a] / res) - origin[a] + c_offsets[k][a];
    const bool in = valid && r[0] >= 0 && r[0] < lim && r[1] >= 0 && r[1] < lim && r[2] >= 0 && r[2] < lim;
    int id;
    bool f;
    if (G > 0) {  // voxel.py lookup_dense: an out-of-grid query reads cell 0
      const int v = __ldg(grid + (in ? (r[0] * G + r[1]) * G + r[2] : 0));
      f = in && v >= 0;
      id = v > 0 ? v : 0;
    } else {  // voxel.py lookup_voxels: lower bound in the sorted keys
      const int key = in ? (r[0] << (2 * kLocalBits)) | (r[1] << kLocalBits) | r[2] : kLocalInvalid;
      int lo = 0, hi = V;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(keys + mid) < key) lo = mid + 1; else hi = mid;
      }
      id = lo < V - 1 ? lo : V - 1;
      f = in && __ldg(keys + id) == key && vmask[id] != 0;
    }
    idx_out[pair] = id;
    found_out[pair] = f;
  }
}

// -- the last block's finish ----------------------------------------------------

// Whether this block is the last of its problem to finish: every thread
// fences its writes, then thread 0 draws a ticket from the problem's
// counter. The last ticket resets the counter to 0 for the next launch;
// kernels on one stream do not overlap, so every launch on it (the
// overlapped backend's thread launches on the same stream) finds 0.
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

// The first R floats of a problem's nblk partial rows (row blk at
// p + blk * R, 16-byte aligned; written by other blocks of this launch:
// read past L1) summed over the blocks in float64 into s[0..R), in an order
// that does not depend on which block came last. A warp reads 32 / Q whole
// rows at a time (Q = R / 4 float4s a row, lane l the float4 l % Q of row
// l / Q), the block kWarps x 32 / Q rows a step; each lane adds its rows in
// turn, kFinishLoads of them loaded at once; then the lanes of one float4
// column add in a shuffle tree, and the warps in order.
template <int R>
__device__ __forceinline__ void sum_partials(const float* __restrict__ p, int nblk, double* __restrict__ s) {
  constexpr int Q = R / 4, RW = 32 / Q, RB = kWarps * RW;
  static_assert(R % 4 == 0 && 32 % Q == 0, "float4 columns that divide a warp");
  __shared__ double sw[kWarps][R];
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
  if ((int)threadIdx.x < R) {
    double y = sw[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) y += sw[w][threadIdx.x];
    s[threadIdx.x] = y;
  }
  __syncthreads();
}

// -- derivatives ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ndt_derivatives_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                       const float* __restrict__ T, int n, int K, const int* __restrict__ idx,
                       const unsigned char* __restrict__ found, const float4* __restrict__ rows, float d1,
                       float d2, float* __restrict__ partial, int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ float sT[16];
  const int b = blockIdx.y, pairs = n * K;
  if (threadIdx.x < 16) sT[threadIdx.x] = T[16 * b + threadIdx.x];
  __syncthreads();
  float acc[kDerivRow];
#pragma unroll
  for (int j = 0; j < kDerivRow; ++j) acc[j] = 0.0f;
  const float hd2 = -0.5f * d2;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < pairs; t += gridDim.x * kThreads) {
    // every load of the pair is issued before the test: only the cell row
    // waits on another load (its index)
    const size_t row = (size_t)b * n + t / K, pair = (size_t)b * pairs + t;
    const bool on = (mask[row] & found[pair]) != 0;
    const int id = idx[pair];
    const float x = xyz[3 * row], y = xyz[3 * row + 1], z = xyz[3 * row + 2];
    if (!on) continue;
    float p[3], mu[3], B[9];
    transform(sT, x, y, z, p);
    load_row(rows, id, mu, B);
    const float q0 = p[0] - mu[0], q1 = p[1] - mu[1], q2 = p[2] - mu[2];
    const float a0 = fmaf(B[0], q0, fmaf(B[1], q1, B[2] * q2));
    const float a1 = fmaf(B[3], q0, fmaf(B[4], q1, B[5] * q2));
    const float a2 = fmaf(B[6], q0, fmaf(B[7], q1, B[8] * q2));
    const float u = fmaxf(fmaf(q0, a0, fmaf(q1, a1, q2 * a2)), 0.0f);
    const float E = d1 * expf(hd2 * u);
    const float ea[3] = {E * a0, E * a1, E * a2};
    // this pair's M = -d2 E a a^T + E B (symmetric: B is an icov)
    float M[3][3];
    M[0][0] = fmaf(-d2, ea[0] * a0, E * B[0]); M[1][1] = fmaf(-d2, ea[1] * a1, E * B[4]);
    M[2][2] = fmaf(-d2, ea[2] * a2, E * B[8]);
    M[0][1] = M[1][0] = fmaf(-d2, ea[0] * a1, E * B[1]);
    M[0][2] = M[2][0] = fmaf(-d2, ea[0] * a2, E * B[2]);
    M[1][2] = M[2][1] = fmaf(-d2, ea[1] * a2, E * B[5]);
    // Hp = hat(p): Hp v = p x v
    const float Hp[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
    float MH[3][3];  // M Hp
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) MH[r][c] = M[r][0] * Hp[0][c] + M[r][1] * Hp[1][c] + M[r][2] * Hp[2][c];
    const float he[3][3] = {{0.0f, -ea[2], ea[1]}, {ea[2], 0.0f, -ea[0]}, {-ea[1], ea[0], 0.0f}};
    const float adp = ea[0] * p[0] + ea[1] * p[1] + ea[2] * p[2];
    // gradient (unscaled): [E a, p x E a]
    acc[0] += ea[0]; acc[1] += ea[1]; acc[2] += ea[2];
    acc[3] += p[1] * ea[2] - p[2] * ea[1];
    acc[4] += p[2] * ea[0] - p[0] * ea[2];
    acc[5] += p[0] * ea[1] - p[1] * ea[0];
    // H upper triangle, row-major over the 6x6: entries (r, c >= r)
    float Hrow[6][6];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Hrow[r][c] = M[r][c];
        Hrow[r][3 + c] = -MH[r][c] + 0.5f * he[r][c];
        // -Hp M Hp + (E a p^T + p E a^T)/2 - (E a.p) I
        const float HMH = Hp[r][0] * MH[0][c] + Hp[r][1] * MH[1][c] + Hp[r][2] * MH[2][c];
        Hrow[3 + r][3 + c] = -HMH + 0.5f * (ea[r] * p[c] + p[r] * ea[c]) - (r == c ? adp : 0.0f);
      }
    int j = 6;
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = r; c < 6; ++c) acc[j++] += Hrow[r][c];
    acc[27] += E;
  }
  // one 128-byte partial row per block: no two blocks write one sector
  float* pb = partial + (size_t)b * gridDim.x * kDerivRow;
  block_sum<kDerivRow>(acc, kDerivWidth, pb + (size_t)blockIdx.x * kDerivRow);
  if (!last_block(tickets + b)) return;
  // the finish: g = -d2 g, the symmetric H = -d2 H, the score, as (43,)
  __shared__ double s[kDerivRow];
  sum_partials<kDerivRow>(pb, gridDim.x, s);
  const int e = threadIdx.x;
  float* o = out + (size_t)b * kDerivOut;
  if (e < 6) {
    o[e] = (float)(-d2 * s[e]);
  } else if (e < 42) {
    const int rr = (e - 6) / 6, cc = (e - 6) % 6;
    const int lo = rr < cc ? rr : cc, hi = rr < cc ? cc : rr;
    // index of (lo, hi) in the row-major upper triangle
    o[e] = (float)(-d2 * s[6 + lo * 6 - lo * (lo - 1) / 2 + (hi - lo)]);
  } else if (e == 42) {
    o[e] = (float)s[27];
  }
}

// -- trial scores -----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ndt_score_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                 const float* __restrict__ T, int L, int n, int K, const int* __restrict__ idx,
                 const unsigned char* __restrict__ found, const float4* __restrict__ rows, float d1, float d2,
                 float* __restrict__ partial, int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ float sT[kMaxTrials][16];  // the problem's L poses
  const int b = blockIdx.y, pairs = n * K;
  for (int e = threadIdx.x; e < 16 * L; e += kThreads) sT[e >> 4][e & 15] = T[(size_t)b * L * 16 + e];
  __syncthreads();
  const float hd2 = -0.5f * d2;
  float acc[kMaxTrials];
#pragma unroll
  for (int l = 0; l < kMaxTrials; ++l) acc[l] = 0.0f;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < pairs; t += gridDim.x * kThreads) {
    const size_t row = (size_t)b * n + t / K, pair = (size_t)b * pairs + t;
    const bool on = (mask[row] & found[pair]) != 0;
    const int id = idx[pair];
    const float x = xyz[3 * row], y = xyz[3 * row + 1], z = xyz[3 * row + 2];
    if (!on) continue;
    float mu[3], B[9];
    load_row(rows, id, mu, B);
#pragma unroll
    for (int l = 0; l < kMaxTrials; ++l) {
      if (l >= L) break;
      float p[3];
      transform(sT[l], x, y, z, p);
      const float q0 = p[0] - mu[0], q1 = p[1] - mu[1], q2 = p[2] - mu[2];
      const float a0 = fmaf(B[0], q0, fmaf(B[1], q1, B[2] * q2));
      const float a1 = fmaf(B[3], q0, fmaf(B[4], q1, B[5] * q2));
      const float a2 = fmaf(B[6], q0, fmaf(B[7], q1, B[8] * q2));
      const float u = fmaxf(fmaf(q0, a0, fmaf(q1, a1, q2 * a2)), 0.0f);
      acc[l] += d1 * expf(hd2 * u);
    }
  }
  float* pb = partial + (size_t)b * gridDim.x * kScoreRow;
  block_sum<kMaxTrials>(acc, L, pb + (size_t)blockIdx.x * kScoreRow);
  if (!last_block(tickets + b)) return;
  __shared__ double s[kScoreRow];
  sum_partials<kScoreRow>(pb, gridDim.x, s);
  if ((int)threadIdx.x < L) out[(size_t)b * L + threadIdx.x] = (float)s[threadIdx.x];
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 = launched).

// B problems of n points against one target: xyz (B, n, 3), mask (B, n)
// uint8, T (B, 4, 4), K = 1 or 7 -> idx (B, n, K) int32, found (B, n, K)
// uint8, one launch of blocks_for(n K) x B blocks. G > 0 reads the dense
// grid (G^3,); G == 0 searches keys (V,) with vmask (V,).
int hgs_ndt_associate(const float* xyz, const unsigned char* mask, const float* T, int batch, int n, int K,
                      const int* origin, float res, const int* grid, int G, const int* keys,
                      const unsigned char* vmask, int V, int* idx, unsigned char* found, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || (K != 1 && K != 7) || G < 0 || (G == 0 && V <= 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grd(blocks_for(n * K), batch);
  if (K == 7)
    ndt_associate_kernel<7><<<grd, kThreads, 0, (cudaStream_t)stream>>>(xyz, mask, T, n, origin, res, grid, G,
                                                                         keys, vmask, V, idx, found);
  else
    ndt_associate_kernel<1><<<grd, kThreads, 0, (cudaStream_t)stream>>>(xyz, mask, T, n, origin, res, grid, G,
                                                                         keys, vmask, V, idx, found);
  return (int)cudaGetLastError();
}

// g (B, 6), H (B, 6, 6), score (B,) as out (B, 43), in one launch. nblk
// must be the blocks per problem at n x K pairs (blocks_for, which the
// wrapper computes itself); partial is scratch of B * nblk * kDerivRow
// floats, 16-byte aligned, and
// tickets B int32 counters, all 0 (each launch leaves them so). rows is the
// target's (V, 12) float32 [mean | icov] table.
int hgs_ndt_derivatives(const float* xyz, const unsigned char* mask, const float* T, int batch, int n, int K,
                        const int* idx, const unsigned char* found, const float* rows, float d1, float d2, int nblk,
                        float* partial, int* tickets, float* out, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || K <= 0 || K > kMaxK || nblk != blocks_for(n * K))
    return (int)cudaErrorInvalidValue;
  ndt_derivatives_kernel<<<dim3(nblk, batch), kThreads, 0, (cudaStream_t)stream>>>(
      xyz, mask, T, n, K, idx, found, reinterpret_cast<const float4*>(rows), d1, d2, partial, tickets, out);
  return (int)cudaGetLastError();
}

// Scores of L <= kMaxTrials trial poses T (B, L, 4, 4) under one
// association -> out (B, L), in one launch; partial is scratch of
// B * nblk * kScoreRow floats, 16-byte aligned, tickets as for the
// derivatives.
int hgs_ndt_score(const float* xyz, const unsigned char* mask, const float* T, int batch, int L, int n, int K,
                  const int* idx, const unsigned char* found, const float* rows, float d1, float d2, int nblk,
                  float* partial, int* tickets, float* out, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || L <= 0 || L > kMaxTrials || K <= 0 || K > kMaxK ||
      nblk != blocks_for(n * K))
    return (int)cudaErrorInvalidValue;
  ndt_score_kernel<<<dim3(nblk, batch), kThreads, 0, (cudaStream_t)stream>>>(
      xyz, mask, T, L, n, K, idx, found, reinterpret_cast<const float4*>(rows), d1, d2, partial, tickets, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
