// GICP association and linearization for Hopper (sm_90a), fp32 on CUDA cores.
// Plain C interface, loaded with ctypes by
// hdl_graph_slam_tpu_torch/kernels/__init__.py; the wrappers, the prepared
// call the LM loop launches through and the plain PyTorch twins live in
// hdl_graph_slam_tpu_torch/registration/gicp.py.
//
// The JAX package runs these steps of its GICP LM loop as XLA programs
// (hdl_graph_slam_tpu/registration/gicp.py); there is no Pallas kernel to
// port. One kernel, gicp_step_kernel<kForm>, replaces them in four forms,
// each one launch:
//
// kAssociate: gicp.py:116 _associate after its 1-NN search, and vgicp.py:112
//   _associate after its voxel lookup. Per (problem b, source row i): the
//   gate (GICP: src.mask & tgt.mask[idx] & (d2 < max_corr_dist^2) from nn1's
//   (idx, d2); VGICP: the lookup's found flag), M = inv3x3(C_tgt[idx] +
//   R C_src R^T) by the adjugate with |det| clamped at 1e-20 (gicp.py:86
//   _inv3x3), M times the gate as 0.0 / 1.0, written as the (B, n, 3, 3) Mw
//   the LM carries, and the valid rows of each problem counted. Every
//   product and sum is an IEEE __fmul_rn / __fadd_rn (never contracted into
//   an FMA) in the order of the plain twin's elementwise ops, and 1 / det is
//   the correctly rounded __frcp_rn, so Mw is the plain twin's bits.
// kLinearize: gicp.py:131 _linearize_at (vgicp.py:124, the voxel means as
//   the target points) under carried correspondences: per row, at its pose
//   T: p = T a, e = x_tgt[idx] - p, Me = M e, and with S = hat(p) and
//   J = [-I | S] (never formed)
//     b += J^T M e = [-Me, S^T Me],   cost += e.Me,
//     H += J^T M J = [[M, -M S], [S M, -S M S]]   (upper triangle),
//   28 sums a row, every product and sum an explicit fmaf or IEEE op, so
//   each form compiles the row to the same roundings.
// kFused: kAssociate then kLinearize at the same T in one pass: the row's
//   M stays in registers for its sums after it is written as Mw (the trials
//   need it); Mw is never read back. H, b, cost, Mw and the count are the
//   two-launch sequence's bits: the same row routine, the same rows a
//   thread, the same reduction.
// kCost: gicp.py:147 _cost_at (vgicp.py:138), the LM trial: the cost's sum
//   alone through the same tree, so it has the full form's bits.
//
// Bound. At the main path's shape (8192 rows, ~6400 valid) the association
// must read each row's source covariance, gate inputs and index (~50 B),
// each named target covariance (36 B) and write its Mw (36 B): ~1.0 MB,
// 0.3 us at 3.35 TB/s; the linearization reads each row's point, index and
// Mw and the target point it names (~64 B): ~0.5 MB, 0.16 us, and does
// ~130 fp32 operations a row (~1 MFLOP, 0.016 us); the fused form reads the
// association's inputs and the points (~1.1 MB, 0.33 us). All are bound by
// latency, not bytes: the launch, the gather behind each index, and the
// sum across blocks. What the design does about it:
//
// - Fill the card. Blocks of 128 threads, a row a thread (layout_for):
//   64 blocks at 8192 rows, 256 at the loop's B = 8 x 4096, each on its
//   own SM where the card has them free.
// - The cross-block sum. A block sums its rows in a fixed order (a warp by
//   recursive halving, the warps in order) into a shared partial row,
//   writes it to global scratch in float64 and draws a ticket from the
//   problem's int32 counter; the last block sets the counter back to 0
//   (csrc/ndt.cu's pattern) and sums the rows in float64 in a fixed order,
//   its warps splitting them (sum_rows: one round of loads in flight). The
//   valid count rides in the same rows. A cluster of 8 blocks of 512
//   threads, 2 rows a thread, summing through distributed shared memory
//   into rank 0 (no ticket), and the 128-thread blocks in clusters of 8
//   were measured against this layout on an H100 and were slower at both
//   shapes (PERF.md section 6): 8 SMs a problem are too few for the scattered
//   target gathers, and a cluster launch costs more than the ticket saves.
// - Coalesced row records. A block's rows are one contiguous span: it
//   moves the span's covariances or Mw rows (36 B a row) and points (12 B)
//   between global and shared memory as 16-byte vectors, every load in
//   flight before the first store, and each thread reads its row from
//   shared memory (strides of 9 and 3 floats: no bank conflicts). Index,
//   gate and target gathers are issued before the span lands.
//
// Every form takes a leading batch B of problems sharing one target (the
// loop detector's candidates; odometry has B = 1) in blockIdx.y. The layout
// depends only on n, each sum's order is fixed by it, and the finish's
// order does not depend on which block came last: two runs on one card
// agree bit for bit, and row b of a batch has the bits of the batch of one.
// No float atomics, no host read, no allocation: a CUDA graph can capture
// every form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 28;  // sums of a row: b (6), H upper triangle (21), cost (1)
constexpr int kCostSlot = 27;
constexpr int kCountSlot = 28;  // the valid count's slot in a block's row
constexpr int kRow = 32;  // doubles per block row in global scratch
constexpr int kOut = 43;  // b (6), H (36), cost (1)
constexpr int kThreads = 128;  // threads a block, a row each
constexpr int kWarps = kThreads / 32;
constexpr int kRecord = 48;  // shared bytes a row: 9 + 3 floats
constexpr unsigned kFull = 0xffffffffu;

enum Form : int { kAssociate = 0, kFused = 1, kLinearize = 2, kCost = 3 };

}  // namespace

// One launch; every pointer is device memory. Mirrored field for field by
// registration/gicp.py's GicpArgs (ctypes).
struct GicpArgs {
  const float* T;                // (B, 4, 4) poses
  const float* xyz;              // (B, n, 3) source points (every form but kAssociate)
  const float* covs;             // (B, n, 3, 3) source covariances (kAssociate, kFused)
  const int* idx;                // (B, n) target rows
  const float* d2;               // (B, n) GICP gate's squared distances, or null
  const unsigned char* smask;    // (B, n) GICP gate's source mask
  const unsigned char* tmask;    // (M,) GICP gate's target mask
  const unsigned char* found;    // (B, n) VGICP gate, or null
  const float* tgt_covs;         // (M, 3, 3) (kAssociate, kFused)
  const float* tgt_xyz;          // (M, 3) target points (every form but kAssociate)
  float* Mw;                     // (B, n, 3, 3): written by kAssociate / kFused, read by the others
  int* num;                      // (B,) valid counts (kAssociate, kFused)
  float* out;                    // (B, 43) b, H, cost (kFused, kLinearize); (B,) cost (kCost)
  int* tickets;                  // (B,) int32, 0 on entry and left 0
  double* partial;               // (B, blocks, 32) block rows when a problem spans blocks
  float max_d2;
  int batch, n, form;
  int blocks, span;              // blocks a problem, rows a block (layout_for)
};

namespace {

// The layout over n rows: (blocks, span). The rows are cut into equal
// spans of at most kThreads rows, each a multiple of 4 rows (16-byte
// aligned records).
struct Layout {
  int blocks, span;
};
Layout layout_for(int n) {
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  const int span = ((n + blocks - 1) / blocks + 3) / 4 * 4;
  return {blocks, span > 0 ? span : 4};
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

// Mw of one row: inv3x3(Ct + R C R^T) times the gate vf, R the rotation of
// T (row-major 3 x 4), in the plain twin's order (RC = R C, then A = Ct +
// (RC) R^T, each a left-to-right sum of three products; the adjugate over
// the clamped determinant).
__device__ __forceinline__ void mahalanobis(const float (&T)[12], const float* C, const float (&Ct)[9], float vf,
                                            float (&mw)[9]) {
  float RC[3][3], A[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      RC[r][c] = __fadd_rn(mul_add(T[4 * r], C[c], T[4 * r + 1], C[3 + c]), __fmul_rn(T[4 * r + 2], C[6 + c]));
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      A[r][c] = __fadd_rn(Ct[3 * r + c], __fadd_rn(mul_add(RC[r][0], T[4 * c], RC[r][1], T[4 * c + 1]),
                                                   __fmul_rn(RC[r][2], T[4 * c + 2])));
  const float a = A[0][0], bb = A[0][1], c = A[0][2], d = A[1][0], e = A[1][1], f = A[1][2];
  const float g = A[2][0], h = A[2][1], k = A[2][2];
  const float cA = mul_sub(e, k, f, h), cB = -mul_sub(d, k, f, g), cC = mul_sub(d, h, e, g);
  const float det = __fadd_rn(mul_add(a, cA, bb, cB), __fmul_rn(c, cC));
  const float inv_det = __frcp_rn(fabsf(det) < 1e-20f ? 1e-20f : det);
  const float adj[9] = {cA, -mul_sub(bb, k, c, h), mul_sub(bb, f, c, e),
                        cB, mul_sub(a, k, c, g), -mul_sub(a, f, c, d),
                        cC, -mul_sub(a, h, bb, g), mul_sub(a, e, bb, d)};
#pragma unroll
  for (int q = 0; q < 9; ++q) mw[q] = __fmul_rn(__fmul_rn(adj[q], inv_det), vf);
}

// -- linearization ----------------------------------------------------------------

// One row's terms at the pose T (row-major 3 x 4) added to acc: the cost
// into acc[kCostSlot], and unless kCostOnly b into acc[0..6) and the upper
// triangle of H into acc[6..27). Every product is an fmaf or stands alone,
// so no form can contract it differently.
template <bool kCostOnly>
__device__ __forceinline__ void add_terms(const float (&T)[12], const float (&M)[9], float x, float y, float z,
                                          const float (&q)[3], float (&acc)[kRow]) {
  float p[3], ev[3], Me[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = fmaf(T[4 * r], x, fmaf(T[4 * r + 1], y, fmaf(T[4 * r + 2], z, T[4 * r + 3])));
    ev[r] = q[r] - p[r];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) Me[r] = fmaf(M[3 * r], ev[0], fmaf(M[3 * r + 1], ev[1], __fmul_rn(M[3 * r + 2], ev[2])));
  acc[kCostSlot] += fmaf(ev[0], Me[0], fmaf(ev[1], Me[1], __fmul_rn(ev[2], Me[2])));
  if constexpr (!kCostOnly) {
    // b = [-Me, S^T Me] = [-Me, Me x p]
    acc[0] -= Me[0];
    acc[1] -= Me[1];
    acc[2] -= Me[2];
    acc[3] += fmaf(Me[1], p[2], -__fmul_rn(Me[2], p[1]));
    acc[4] += fmaf(Me[2], p[0], -__fmul_rn(Me[0], p[2]));
    acc[5] += fmaf(Me[0], p[1], -__fmul_rn(Me[1], p[0]));
    // S = hat(p): S v = p x v
    const float S[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
    float MS[3][3];  // M S
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        MS[r][c] = fmaf(M[3 * r], S[0][c], fmaf(M[3 * r + 1], S[1][c], __fmul_rn(M[3 * r + 2], S[2][c])));
    float H[6][6];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        H[r][c] = M[3 * r + c];
        H[r][3 + c] = -MS[r][c];
        // S^T M S = -S (M S)
        H[3 + r][3 + c] = -fmaf(S[r][0], MS[0][c], fmaf(S[r][1], MS[1][c], __fmul_rn(S[r][2], MS[2][c])));
      }
    int k = 6;
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = r; c < 6; ++c) acc[k++] += H[r][c];
  }
}

// -- the block's span through shared memory ------------------------------------------

// count floats from g to s (shared, 16-byte aligned), kV 16-byte vectors a
// thread at most: every load issued before the first store. A misaligned g
// (a batch of n not a multiple of 4) takes scalar loads.
template <int kV>
__device__ __forceinline__ void stage_in(float* __restrict__ s, const float* __restrict__ g, int count) {
  const int t = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int nv = count >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* s4 = reinterpret_cast<float4*>(s);
    float4 v[kV];
#pragma unroll
    for (int u = 0; u < kV; ++u)
      if (t + u * kThreads < nv) v[u] = __ldg(g4 + t + u * kThreads);
#pragma unroll
    for (int u = 0; u < kV; ++u)
      if (t + u * kThreads < nv) s4[t + u * kThreads] = v[u];
    if (t < count - 4 * nv) s[4 * nv + t] = __ldg(g + 4 * nv + t);
  } else {
    for (int i = t; i < count; i += kThreads) s[i] = __ldg(g + i);
  }
}

// count floats from s (shared) to g, as 16-byte vectors where g is aligned
template <int kV>
__device__ __forceinline__ void stage_out(float* __restrict__ g, const float* __restrict__ s, int count) {
  const int t = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int nv = count >> 2;
    float4* g4 = reinterpret_cast<float4*>(g);
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int u = 0; u < kV; ++u)
      if (t + u * kThreads < nv) g4[t + u * kThreads] = s4[t + u * kThreads];
    if (t < count - 4 * nv) g[4 * nv + t] = s[4 * nv + t];
  } else {
    for (int i = t; i < count; i += kThreads) g[i] = s[i];
  }
}

// -- reductions ---------------------------------------------------------------------

// One level of the warp's recursive halving: a lane hands the partner H
// lanes away the half of its first 2H values it gives up and adds the
// partner's copy of the half it keeps into v[0..H). After the levels
// H = 16, ..., 1, lane l holds the warp's sum of value l.
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

// Whether this block is the last of `count` to finish its problem: every
// thread fences its writes, then thread 0 draws a ticket from the
// problem's counter. The last ticket resets the counter to 0 for the next
// launch; kernels on one stream do not overlap, so every launch finds 0.
__device__ __forceinline__ bool last_of(int* __restrict__ ticket, int count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == count - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  return last;
}

// The problem's P block rows (row p at rows + p * kRow, written by other
// blocks of this launch: read past L1) summed in float64 into fin[0..kRow),
// in an order that does not depend on which block came last: warp w adds
// rows w, w + kWarps, ... in turn, lane l their slot l, 16 rows in flight a
// lane; then the warps in order.
__device__ __forceinline__ void sum_rows(const double* __restrict__ rows, int P, double* __restrict__ fin) {
  __shared__ double s[kWarps][kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double y = 0.0;
  for (int p0 = warp; p0 < P; p0 += 16 * kWarps) {
    double v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int p = p0 + u * kWarps;
      v[u] = p < P ? __ldcg(rows + (size_t)p * kRow + lane) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) y += v[u];
  }
  s[warp][lane] = y;
  __syncthreads();
  if ((int)threadIdx.x < kRow) {
    double z = s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) z += s[w][threadIdx.x];
    fin[threadIdx.x] = z;
  }
}

// -- the kernel ---------------------------------------------------------------------

template <int kForm>
__global__ void __launch_bounds__(kThreads) gicp_step_kernel(const GicpArgs a) {
  constexpr bool kAssoc = kForm == kAssociate || kForm == kFused;  // computes M, writes Mw, counts
  constexpr bool kSums = kForm != kAssociate;                        // adds row terms
  constexpr bool kCostOnly = kForm == kCost;
  __shared__ float4 smem4[kRecord * kThreads / 16];
  float* s9 = reinterpret_cast<float*>(smem4);  // span x 9: covariances in, Mw out; or Mw in
  float* s3 = s9 + 9 * a.span;                   // span x 3: points (36 span bytes in: aligned)
  __shared__ float sT[16];
  __shared__ float s_warp[kWarps][kRow];
  __shared__ int s_wcount[kWarps];
  __shared__ float part[kRow];  // the block's sums
  __shared__ int part_n;        // the block's valid rows
  __shared__ double fin[kRow];  // the problem's sums and count, finished

  const int b = blockIdx.y, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * a.span;
  const int cnt = max(0, min(a.span, a.n - r0));
  const size_t row0 = (size_t)b * a.n + r0;
  const bool has_row = t < cnt;

  // 1. the span's records, and this thread's index, gate and target rows
  stage_in<3>(s9, (kAssoc ? a.covs : a.Mw) + 9 * row0, 9 * cnt);
  if constexpr (kSums) stage_in<1>(s3, a.xyz + 3 * row0, 3 * cnt);
  if (t < 16) sT[t] = __ldg(a.T + 16 * b + t);
  const int j = has_row ? __ldg(a.idx + row0 + t) : 0;
  bool valid = false;
  if (has_row && kAssoc)
    valid = a.found != nullptr ? __ldg(a.found + row0 + t) != 0
                               : (__ldg(a.smask + row0 + t) != 0 && __ldg(a.d2 + row0 + t) < a.max_d2);
  float Ct[9], q[3];
  if (has_row) {
    if constexpr (kAssoc) {
#pragma unroll
      for (int e = 0; e < 9; ++e) Ct[e] = __ldg(a.tgt_covs + 9 * (size_t)j + e);
      if (a.found == nullptr) valid = valid && __ldg(a.tmask + j) != 0;
    }
    if constexpr (kSums) {
#pragma unroll
      for (int e = 0; e < 3; ++e) q[e] = __ldg(a.tgt_xyz + 3 * (size_t)j + e);
    }
  }
  __syncthreads();

  // 2. the row: Mw and the count, the terms
  float P[12];  // T's first three rows
#pragma unroll
  for (int e = 0; e < 12; ++e) P[e] = sT[e];
  float acc[kRow];
#pragma unroll
  for (int e = 0; e < kRow; ++e) acc[e] = 0.0f;
  const int nvalid = has_row && valid ? 1 : 0;
  if (has_row) {
    float M[9];
    if constexpr (kAssoc) {
      mahalanobis(P, s9 + 9 * t, Ct, valid ? 1.0f : 0.0f, M);
#pragma unroll
      for (int e = 0; e < 9; ++e) s9[9 * t + e] = M[e];  // over this row's covariance, read above
    } else {
#pragma unroll
      for (int e = 0; e < 9; ++e) M[e] = s9[9 * t + e];
    }
    if constexpr (kSums) add_terms<kCostOnly>(P, M, s3[3 * t], s3[3 * t + 1], s3[3 * t + 2], q, acc);
  }
  if constexpr (kAssoc) {
    __syncthreads();
    stage_out<3>(a.Mw + 9 * row0, s9, 9 * cnt);
  }

  // 3. the block's partial row: each warp by recursive halving (the cost
  // alone by the same tree as a butterfly: float addition commutes, so
  // every lane holds the halving's bits), the warps in order
  if constexpr (kSums) {
    if constexpr (kCostOnly) {
      float c = acc[kCostSlot];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
      if (lane == kCostSlot) s_warp[warp][lane] = c;
    } else {
      halve<kRow / 2>(acc, lane);
      s_warp[warp][lane] = acc[0];
    }
  }
  if constexpr (kAssoc) {
    const int c = __reduce_add_sync(kFull, nvalid);
    if (lane == 0) s_wcount[warp] = c;
  }
  __syncthreads();
  if (kSums && (kCostOnly ? t == kCostSlot : t < kWidth)) {
    float x = s_warp[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += s_warp[w][t];
    part[t] = x;
  }
  if (kAssoc && t == kCountSlot) {
    int c = s_wcount[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) c += s_wcount[w];
    part_n = c;
  }
  // the slots this form finishes: the sums it adds, and the count
  const bool mine = (kSums && (kCostOnly ? t == kCostSlot : t < kWidth)) || (kAssoc && t == kCountSlot);
  double y = 0.0;
  if (mine) y = t == kCountSlot ? (double)part_n : (double)part[t];

  // 4. a problem of one block finishes here; else the blocks' rows meet at
  // the last ticket (sum_rows)
  if (a.blocks > 1) {
    double* rows = a.partial + (size_t)b * a.blocks * kRow;
    if (mine) rows[(size_t)blockIdx.x * kRow + t] = y;
    if (!last_of(a.tickets + b, a.blocks)) return;
    sum_rows(rows, a.blocks, fin);
  } else if (mine) {
    fin[t] = y;
  }
  __syncthreads();
  if constexpr (kAssoc) {
    if (t == 0) a.num[b] = (int)fin[kCountSlot];
  }
  if constexpr (kCostOnly) {
    if (t == 0) a.out[b] = (float)fin[kCostSlot];
  } else if constexpr (kSums) {
    float* o = a.out + (size_t)b * kOut;
    if (t < 6) {
      o[t] = (float)fin[t];
    } else if (t < 42) {
      const int rr = (t - 6) / 6, cc = (t - 6) % 6;
      const int lo = rr < cc ? rr : cc, hi = rr < cc ? cc : rr;
      // index of (lo, hi) in the row-major upper triangle
      o[t] = (float)fin[6 + lo * 6 - lo * (lo - 1) / 2 + (hi - lo)];
    } else if (t == 42) {
      o[t] = (float)fin[kCostSlot];
    }
  }
}

// -- launch -------------------------------------------------------------------------

template <int kForm>
void launch(const GicpArgs& a, cudaStream_t st) {
  gicp_step_kernel<kForm><<<dim3(a.blocks, a.batch), kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// One launch of the form a->form over B = a->batch problems of n rows
// against one target (its blocks and span must be layout_for's: the
// wrapper computes them itself); returns the launch's cudaError (0 =
// launched). tickets holds B int32, all 0 (each launch leaves them so);
// partial holds B x blocks x 32 doubles where a problem spans more than
// one block.
int hgs_gicp_step(const GicpArgs* a, void* stream) {
  if (a == nullptr || a->n <= 0 || a->batch <= 0 || a->batch > 65535 || a->form < kAssociate || a->form > kCost)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout_for(a->n);
  if (a->blocks != l.blocks || a->span != l.span) return (int)cudaErrorInvalidValue;
  const bool assoc = a->form == kAssociate || a->form == kFused;
  if (a->T == nullptr || a->idx == nullptr || a->Mw == nullptr || a->tickets == nullptr ||
      (l.blocks > 1 && a->partial == nullptr) ||
      (assoc && (a->covs == nullptr || a->tgt_covs == nullptr || a->num == nullptr ||
                 (a->found == nullptr && (a->d2 == nullptr || a->smask == nullptr || a->tmask == nullptr)))) ||
      (a->form != kAssociate && (a->xyz == nullptr || a->tgt_xyz == nullptr || a->out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a->form) {
    case kAssociate: launch<kAssociate>(*a, st); break;
    case kFused: launch<kFused>(*a, st); break;
    case kLinearize: launch<kLinearize>(*a, st); break;
    default: launch<kCost>(*a, st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
