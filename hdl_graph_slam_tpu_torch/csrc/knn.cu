// Exact brute-force nearest-neighbour kernels for Hopper (sm_90a), fp32 on
// CUDA cores. Plain C interface, loaded with ctypes by
// hdl_graph_slam_tpu_torch/kernels/__init__.py; the wrappers and their plain
// PyTorch twins live in hdl_graph_slam_tpu_torch/ops/knn.py.
//
// nn1_kernel replaces the TPU kernel hdl_graph_slam_tpu/ops/pallas_nn.py
// (nn1_pallas, body _nn_kernel) and its XLA twin ops/knn.py nn1: for each
// query the lowest-index target minimising d = |t|^2 - 2 q.t (coordinates
// centred on the bounding box of the valid targets, |x| < 1e5 on every axis),
// then the exact squared distance of the winner from the uncentred
// coordinates.
//
// knn_select_kernel replaces the XLA lowering of ops/knn.py knn_approx
// (lax.approx_min_k) as GICP preprocessing calls it: the exact k nearest
// targets of each query, ordered by (d, index), with the distance d + |q|^2
// of the centred coordinates. It is instantiated for k = 20 (GICP's
// covariances), 10 (the floor detector's normals), 21 (the statistical
// outlier filter's mean_k + 1) and 8 (NDT's KDTREE mode: the 8 nearest cell
// means of each point, registration/ndt.py _gather_cells_kdtree, knn_approx
// at k = 8 in the JAX package); ops/knn.py::knn adds the exact rescore of
// the XLA ops/knn.py knn (top_k) on top of it.
//
// radius_count_kernel replaces the XLA ops/knn.py radius_count
// (hdl_graph_slam_tpu/ops/knn.py:180, called by ops/filters.py:68-74): for
// each query the number of targets with squared distance strictly below
// r^2, the query itself included when it is a target. The distance is the
// exact difference form fmaf(dx, dx, fmaf(dy, dy, dz * dz)) on uncentred
// coordinates, not the expanded |q|^2 - 2 q.t + |t|^2 of the XLA op, so the
// two can differ only for pairs within rounding of r^2. Its section below
// says what bounds it and what its design does about that.
//
// Bound (nn1, knn_select). At the main path's N = M = 8192 both kernels do N*M = 67 M pairs of
// 3 FMAs plus a compare and move only (N + M) * 12 bytes in and N * (8 or 8k)
// bytes out: the work is fp32 operations, about 8 us at the H100's
// 67 TFLOP/s. The N x M distance field is never written to memory.
//
// Residency (nn1, knn_select). 1024-thread blocks, one per SM (32 resident warps), in a
// persistent grid of at most one block per SM. Each block stages the whole
// target cloud once, as centred float4(x, y, z, |t|^2), in dynamic shared
// memory (128 KB at M = 8192). Every thread loads its rows into registers,
// where they are reduced for the valid-target bbox on the way (REDUX per
// warp, shared-memory atomics across warps) and then written centred, once:
// a cp.async copy would only add a shared-memory round trip, since the
// centring needs every row in registers anyway. The block then walks its
// tasks with no __syncthreads in the scan. A cloud larger than one stage
// (8 rows per thread, or less where shared memory runs out) is scanned in
// stages, one barrier pair each.
//
// nn1: a block task is 64 queries, two per lane; warp w scans the w-th
// contiguous slice of the targets, all 32 lanes reading the same float4 (a
// shared-memory broadcast) for both queries. The slice goes in blocks of 4
// rows: three FMNMX fold a block, one compare and two selects keep the best
// block, and the winning block is searched again for its first row at that
// distance. That cuts the compare-and-select work, which runs on the
// half-rate ALU pipe, from 3 to 1.5 instructions per pair beside the 3 FFMA.
// The 32 partial (d, index) winners of a query are merged through shared
// memory under the lexicographic order, which keeps the lowest-index tie
// rule exact. What bounds it: instruction issue in the scan (about 4.5
// instructions per pair), then the staging.
//
// knn_select: the warp-wide selection of Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs" (FAISS's WarpSelect), with a
// shared-memory warp queue. A warp owns 2 consecutive queries (each float4
// load feeds both distance chains) and its lanes scan 32 consecutive targets
// per step. Per query the warp keeps the 32 best (d, index) so far sorted
// across its lanes, one entry per lane; the K-th entry is the warp-uniform
// threshold, so the common case is one FFMA chain and one compare per pair
// and one vote per two steps. Passing candidates are appended to a 32-entry
// per-query buffer in shared memory; when it would overflow (and at the end)
// the warp sorts the buffer with a 32-lane bitonic network over shuffles,
// merges it into the list (reverse, lexicographic min, bitonic merge) and
// refreshes the threshold.
//
// Scan order. Each query group's scan runs from kSelBack rows before the
// target row of its own index to the end, then wraps around to row 0. The
// result does not depend on the order, only the time does: when the caller
// passes a cloud as its own query in a spatially coherent row order, as
// GICP preprocessing passes the prefilter's voxel-key output, the true
// neighbours come first and few candidates pass (ops/knn.py::knn_select
// states this; on the course frame an ascending scan took 7x as long on an
// H100).
//
// Ties. A row passes when (d, j) is lexicographically below the K-th entry
// (thd, thi); the scan folds that into one float compare per pair, d < lim.
// Before the wrap every row scanned has a higher index than every entry, so
// lim = thd. After it every row has j < wrap, so j < thi exactly when
// thi >= wrap, and then lim = nextafter(thd), i.e. d <= thd. A plain d <=
// thd everywhere would also be exact, but padded rows are exact duplicates
// and would all pass it for a padded query (2.5x the time on the course
// frame on an H100).
//
// What bounds it: shared-memory bandwidth in the scan (32 distinct float4
// per warp step, 8 bytes per pair), and the merges, whose shuffles queue
// behind those loads; the warps with the most merges finish last.
//
// Batches. Both kernels take a batch of independent problems in the grid's y
// dimension: block (x, b) works on query set b against target set b (q and t
// offset by b * n and b * m rows), stages that target and centres it on its
// own bounding box. gridDim.x shrinks so that gridDim.x * B stays near the
// persistent grid's size (at B = 8 x 4096 rows, 16 blocks per cloud). The
// unbatched entry points launch the same kernels with gridDim.y = 1. The
// batch is for sets whose targets differ (the keyframe-pair fitness scores,
// the loop candidates' own covariances); callers with one shared target
// flatten their queries into one unbatched call instead.
//
// Distances are fp32 FMA chains, never TF32.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cmath>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr float kValidAbs = 1.0e5f;    // |coordinate| bound of a valid target
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;         // threads per block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;      // staged rows a thread holds while the centre is reduced

constexpr int kNnQ = 2;                // nn1: queries per lane
constexpr int kNnChunk = 32 * kNnQ;    // nn1: queries per block task
constexpr int kNnScratch = kWarps * kNnChunk * (int)sizeof(float2);  // partial winners

constexpr int kSelQ = 2;               // knn_select: queries per warp
constexpr int kSelBack = 64;           // knn_select: rows scanned before the group's own row
constexpr int kSelScratch = kWarps * kSelQ * 32 * (int)sizeof(float2);  // candidate buffers

__device__ __forceinline__ bool lex_less(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// -- staging ----------------------------------------------------------------
//
// Thread x holds staged rows x, x + blockDim.x, ... (up to kRowsPerThread) in
// registers, loaded from global memory: the rows must pass through registers
// to be centred anyway, so they are reduced for the bbox on the way and
// written to shared memory once, centred. The bbox is reduced per warp with
// REDUX on order-preserving integers, then across warps with shared-memory
// atomics: two barriers, no serial warp.

__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b < 0 ? b ^ 0x7fffffff : b;
}

__device__ __forceinline__ float unordered(int o) { return __int_as_float(o < 0 ? o ^ 0x7fffffff : o); }

__device__ __forceinline__ void load_rows(const float* __restrict__ t, int base, int rows,
                                          float (&v)[kRowsPerThread][3]) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.x + i * blockDim.x;
    if (r < rows) {
      const float* p = t + 3 * (size_t)(base + r);
      v[i][0] = __ldg(p);
      v[i][1] = __ldg(p + 1);
      v[i][2] = __ldg(p + 2);
    }
  }
}

// Centred float4(x, y, z, |t|^2) rows into shared memory, then a barrier.
__device__ __forceinline__ void store_rows(float4* cloud, int rows, const float (&v)[kRowsPerThread][3],
                                           float cx, float cy, float cz) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.x + i * blockDim.x;
    if (r < rows) {
      const float x = v[i][0] - cx, y = v[i][1] - cy, z = v[i][2] - cz;
      cloud[r] = make_float4(x, y, z, x * x + y * y + z * z);
    }
  }
  __syncthreads();
}

// Stage 0 (the whole cloud when it fits) and the centre of the valid
// targets' bounding box, as ops/knn.py computes it: lo = min(where(valid,
// t, 1e5)), hi = max(where(valid, t, -1e5)), centre = hi >= lo ? 0.5 (lo +
// hi) : 0 per axis; rows past the stage are read for the bbox only.
__device__ void stage_first(const float* __restrict__ t, int m, int stage_rows, float4* cloud, int* s_bb,
                            float (&c)[3]) {
  if (threadIdx.x < 6) s_bb[threadIdx.x] = ordered(threadIdx.x < 3 ? kValidAbs : -kValidAbs);
  const int rows = min(m, stage_rows);
  float v[kRowsPerThread][3];
  load_rows(t, 0, rows, v);
  float lo[3] = {kValidAbs, kValidAbs, kValidAbs};
  float hi[3] = {-kValidAbs, -kValidAbs, -kValidAbs};
  auto add = [&](float x, float y, float z) {
    if (fabsf(x) < kValidAbs && fabsf(y) < kValidAbs && fabsf(z) < kValidAbs) {
      lo[0] = fminf(lo[0], x); lo[1] = fminf(lo[1], y); lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x); hi[1] = fmaxf(hi[1], y); hi[2] = fmaxf(hi[2], z);
    }
  };
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    if (threadIdx.x + i * blockDim.x < rows) add(v[i][0], v[i][1], v[i][2]);
  for (int r = rows + threadIdx.x; r < m; r += blockDim.x) add(t[3 * r], t[3 * r + 1], t[3 * r + 2]);
  int olo[3], ohi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    olo[a] = __reduce_min_sync(kFull, ordered(lo[a]));
    ohi[a] = __reduce_max_sync(kFull, ordered(hi[a]));
  }
  __syncthreads();  // s_bb initialised
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) { atomicMin(s_bb + a, olo[a]); atomicMax(s_bb + 3 + a, ohi[a]); }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float l = unordered(s_bb[a]), h = unordered(s_bb[3 + a]);
    c[a] = h >= l ? 0.5f * (l + h) : 0.0f;
  }
  store_rows(cloud, rows, v, c[0], c[1], c[2]);
}

// A later stage: every warp has finished with the previous one first.
__device__ void stage_next(const float* __restrict__ t, int base, int rows, float4* cloud, const float (&c)[3]) {
  float v[kRowsPerThread][3];
  load_rows(t, base, rows, v);
  __syncthreads();
  store_rows(cloud, rows, v, c[0], c[1], c[2]);
}

// -- nn1 ----------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
nn1_kernel(const float* __restrict__ q, int n, const float* __restrict__ t, int m, int stage_rows,
           int* __restrict__ idx_out, float* __restrict__ dist2_out) {
  extern __shared__ float4 smem[];
  __shared__ int s_bb[6];
  float4* cloud = smem;
  float2* part = reinterpret_cast<float2*>(smem + stage_rows);  // [kWarps][kNnChunk]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  q += 3 * (size_t)blockIdx.y * n;  // this block's problem of the batch
  t += 3 * (size_t)blockIdx.y * m;
  idx_out += (size_t)blockIdx.y * n;
  dist2_out += (size_t)blockIdx.y * n;

  float c[3];
  stage_first(t, m, stage_rows, cloud, s_bb, c);
  const float cx = c[0], cy = c[1], cz = c[2];
  const int nstages = (m + stage_rows - 1) / stage_rows;
  int loaded = 0;

  const int chunks = (n + kNnChunk - 1) / kNnChunk;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    float ax[kNnQ], ay[kNnQ], az[kNnQ], bd[kNnQ];
    int bi[kNnQ];
#pragma unroll
    for (int r = 0; r < kNnQ; ++r) {
      const int qr = min(chunk * kNnChunk + lane + 32 * r, n - 1);
      // -2 (q - c): d = |t|^2 - 2 q.t is then three FMAs on a staged row
      ax[r] = -2.0f * (q[3 * qr] - cx);
      ay[r] = -2.0f * (q[3 * qr + 1] - cy);
      az[r] = -2.0f * (q[3 * qr + 2] - cz);
      bd[r] = INFINITY;
      bi[r] = INT_MAX;
    }
    for (int st = 0; st < nstages; ++st) {
      const int base = st * stage_rows, rows = min(stage_rows, m - base);
      if (loaded != st) {
        stage_next(t, base, rows, cloud, c);
        loaded = st;
      }
      // this warp's slice, in blocks of 4 rows: a block's minimum replaces
      // the best only when strictly smaller, so the earliest block wins
      // ties; the winning block is searched again below for its first row
      // at that distance (the same FMA chains give the same distances).
      const int per = (rows + kWarps - 1) / kWarps;
      const int lo = min(rows, warp * per), hi = min(rows, lo + per);
      float sd[kNnQ];
      int sb[kNnQ];
#pragma unroll
      for (int r = 0; r < kNnQ; ++r) { sd[r] = bd[r]; sb[r] = -1; }
      int j = lo;
#pragma unroll 2
      for (; j + 4 <= hi; j += 4) {
        const float4 p0 = cloud[j], p1 = cloud[j + 1], p2 = cloud[j + 2], p3 = cloud[j + 3];
#pragma unroll
        for (int r = 0; r < kNnQ; ++r) {
          const float d0 = fmaf(ax[r], p0.x, fmaf(ay[r], p0.y, fmaf(az[r], p0.z, p0.w)));
          const float d1 = fmaf(ax[r], p1.x, fmaf(ay[r], p1.y, fmaf(az[r], p1.z, p1.w)));
          const float d2 = fmaf(ax[r], p2.x, fmaf(ay[r], p2.y, fmaf(az[r], p2.z, p2.w)));
          const float d3 = fmaf(ax[r], p3.x, fmaf(ay[r], p3.y, fmaf(az[r], p3.z, p3.w)));
          const float mn = fminf(fminf(d0, d1), fminf(d2, d3));
          if (mn < sd[r]) { sd[r] = mn; sb[r] = j; }
        }
      }
      for (; j < hi; ++j) {  // the slice's last rows, one at a time
        const float4 p = cloud[j];
#pragma unroll
        for (int r = 0; r < kNnQ; ++r) {
          const float d = fmaf(ax[r], p.x, fmaf(ay[r], p.y, fmaf(az[r], p.z, p.w)));
          if (d < sd[r]) { sd[r] = d; sb[r] = j; }
        }
      }
#pragma unroll
      for (int r = 0; r < kNnQ; ++r) {
        if (sb[r] < 0) continue;
        for (int k = sb[r]; k < min(sb[r] + 4, hi); ++k) {
          const float4 p = cloud[k];
          if (fmaf(ax[r], p.x, fmaf(ay[r], p.y, fmaf(az[r], p.z, p.w))) == sd[r]) {
            bd[r] = sd[r];
            bi[r] = base + k;
            break;
          }
        }
      }
    }
    // merge the kWarps partial winners of each query: 16 consecutive
    // threads per query, two partials each, then a 16-lane shuffle tree
#pragma unroll
    for (int r = 0; r < kNnQ; ++r)
      part[warp * kNnChunk + lane + 32 * r] = make_float2(bd[r], __int_as_float(bi[r]));
    __syncthreads();
    constexpr int kSubs = kThreads / kNnChunk;
    const int ql = threadIdx.x / kSubs, sub = threadIdx.x % kSubs;
    float d = INFINITY;
    int i = INT_MAX;
    for (int w = sub; w < kWarps; w += kSubs) {
      const float2 v = part[w * kNnChunk + ql];
      if (lex_less(v.x, __float_as_int(v.y), d, i)) { d = v.x; i = __float_as_int(v.y); }
    }
    for (int s = kSubs / 2; s > 0; s >>= 1) {
      const float od = __shfl_down_sync(kFull, d, s, kSubs);
      const int oi = __shfl_down_sync(kFull, i, s, kSubs);
      if (lex_less(od, oi, d, i)) { d = od; i = oi; }
    }
    const int qi = chunk * kNnChunk + ql;
    if (sub == 0 && qi < n) {
      if (i == INT_MAX) i = 0;  // no finite distance (non-finite input)
      const float dx = q[3 * qi] - t[3 * i], dy = q[3 * qi + 1] - t[3 * i + 1], dz = q[3 * qi + 2] - t[3 * i + 2];
      idx_out[qi] = i;
      dist2_out[qi] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    }
    __syncthreads();  // part is rewritten by the next task
  }
}

// -- knn_select -----------------------------------------------------------------

// One query's warp-wide selection state.
struct Sel {
  float ax, ay, az;  // -2 q_c
  float ld;          // this lane's entry of the sorted list of the 32 best
  int li;
  float lim;         // candidates with d < lim go to the buffer
  int cnt;           // buffered candidates (warp-uniform)
};

// Compare-exchange with the lane `lane ^ stride` under (d, index) order.
__device__ __forceinline__ void cmpx(float& d, int& i, int stride, bool keep_min) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (lex_less(od, oi, d, i) == keep_min) { d = od; i = oi; }
}

// Bitonic sort of one (d, index) per lane, ascending across the lanes.
__device__ __forceinline__ void sort32(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      cmpx(d, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  }
}

// Sort a bitonic sequence across the lanes, ascending.
__device__ __forceinline__ void merge32(float& d, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) cmpx(d, i, stride, (lane & stride) == 0);
}

// Refresh the filter from the list's K-th entry (thd, thi): the test
// (d, j) < (thd, thi) as one compare d < lim (Ties, above).
template <int K>
__device__ __forceinline__ void sel_refresh(Sel& s, bool run2, int wrap) {
  const float thd = __shfl_sync(kFull, s.ld, K - 1);
  const int thi = __shfl_sync(kFull, s.li, K - 1);
  s.lim = run2 && thi >= wrap ? nextafterf(thd, INFINITY) : thd;
}

// Merge the buffered candidates into the sorted list.
template <int K>
__device__ __forceinline__ void sel_merge(Sel& s, const float2* b, int lane, bool run2, int wrap) {
  __syncwarp();
  float cd = INFINITY;
  int ci = INT_MAX;
  if (lane < s.cnt) {
    const float2 v = b[lane];
    cd = v.x;
    ci = __float_as_int(v.y);
  }
  __syncwarp();
  sort32(cd, ci, lane);
  // list ascending, candidates reversed: the lane-wise minimum is a bitonic
  // sequence holding the 32 smallest of both
  const float rd = __shfl_sync(kFull, cd, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (lex_less(rd, ri, s.ld, s.li)) { s.ld = rd; s.li = ri; }
  merge32(s.ld, s.li, lane);
  s.cnt = 0;
  sel_refresh<K>(s, run2, wrap);
}

// Append this lane's candidate (d, j) if it passes; `mask` is the warp's
// ballot of d < s.lim.
template <int K>
__device__ __forceinline__ void sel_push(Sel& s, float2* b, float d, int j, unsigned mask, int lane,
                                         unsigned lt_mask, bool run2, int wrap) {
  if (s.cnt + __popc(mask) > 32) {
    sel_merge<K>(s, b, lane, run2, wrap);
    mask = __ballot_sync(kFull, d < s.lim);
  }
  if (d < s.lim) b[s.cnt + __popc(mask & lt_mask)] = make_float2(d, __int_as_float(j));
  s.cnt += __popc(mask);
}

// Distances of this lane's row p to the group's queries; true if any passes.
__device__ __forceinline__ bool sel_dist(const Sel (&S)[kSelQ], float4 p, float (&d)[kSelQ]) {
  bool pass = false;
#pragma unroll
  for (int r = 0; r < kSelQ; ++r) {
    d[r] = fmaf(S[r].ax, p.x, fmaf(S[r].ay, p.y, fmaf(S[r].az, p.z, p.w)));
    pass |= d[r] < S[r].lim;
  }
  return pass;
}

// Buffer the passing candidates of one step (row j of this lane).
template <int K>
__device__ __forceinline__ void sel_step_push(Sel (&S)[kSelQ], float2* buf, const float (&d)[kSelQ],
                                              int j, int lane, unsigned lt_mask, bool run2, int wrap) {
#pragma unroll
  for (int r = 0; r < kSelQ; ++r) {
    const unsigned mask = __ballot_sync(kFull, d[r] < S[r].lim);
    if (mask) sel_push<K>(S[r], buf + 32 * r, d[r], j, mask, lane, lt_mask, run2, wrap);
  }
}

// Scan staged rows [lo, hi) in 32-row steps, lane l taking row s0 + l. Two
// steps go to one vote (the common case: nothing passes); the last step of
// the range may be partial.
template <int K>
__device__ __forceinline__ void sel_run(Sel (&S)[kSelQ], float2* buf, const float4* cloud,
                                        int lo, int hi, int base, int lane,
                                        unsigned lt_mask, bool run2, int wrap) {
#pragma unroll
  for (int r = 0; r < kSelQ; ++r) sel_refresh<K>(S[r], run2, wrap);
  int s0 = lo;
  for (; s0 + 64 <= hi; s0 += 64) {
    float d0[kSelQ], d1[kSelQ];
    bool pass = sel_dist(S, cloud[s0 + lane], d0);
    pass |= sel_dist(S, cloud[s0 + 32 + lane], d1);
    if (__any_sync(kFull, pass)) {
      sel_step_push<K>(S, buf, d0, base + s0 + lane, lane, lt_mask, run2, wrap);
      sel_step_push<K>(S, buf, d1, base + s0 + 32 + lane, lane, lt_mask, run2, wrap);
    }
  }
  for (; s0 < hi; s0 += 32) {
    const int j = s0 + lane;
    float d[kSelQ];
    sel_dist(S, cloud[min(j, hi - 1)], d);
    if (j >= hi) {
#pragma unroll
      for (int r = 0; r < kSelQ; ++r) d[r] = INFINITY;
    }
    sel_step_push<K>(S, buf, d, base + j, lane, lt_mask, run2, wrap);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
knn_select_kernel(const float* __restrict__ q, int n, const float* __restrict__ t, int m, int stage_rows,
                  int* __restrict__ idx_out, float* __restrict__ dist_out) {
  static_assert(K >= 1 && K <= 32, "the warp list holds 32 entries");
  extern __shared__ float4 smem[];
  __shared__ int s_bb[6];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  q += 3 * (size_t)blockIdx.y * n;  // this block's problem of the batch
  t += 3 * (size_t)blockIdx.y * m;
  idx_out += (size_t)blockIdx.y * n * K;
  dist_out += (size_t)blockIdx.y * n * K;
  float4* cloud = smem;
  float2* buf = reinterpret_cast<float2*>(smem + stage_rows) + warp * (kSelQ * 32);  // [kSelQ][32]

  float c[3];
  stage_first(t, m, stage_rows, cloud, s_bb, c);
  const int nstages = (m + stage_rows - 1) / stage_rows;
  int loaded = 0;

  const int groups = (n + kSelQ - 1) / kSelQ;
  for (int first = blockIdx.x * kWarps; first < groups; first += gridDim.x * kWarps) {
    const int group = first + warp;
    const bool active = group < groups;
    const int q0 = group * kSelQ;
    Sel S[kSelQ];
#pragma unroll
    for (int r = 0; r < kSelQ; ++r) {
      const int qr = min(q0 + r, n - 1);
      S[r].ax = -2.0f * (q[3 * qr] - c[0]);
      S[r].ay = -2.0f * (q[3 * qr + 1] - c[1]);
      S[r].az = -2.0f * (q[3 * qr + 2] - c[2]);
      S[r].ld = INFINITY; S[r].li = INT_MAX;
      S[r].lim = INFINITY; S[r].cnt = 0;
    }
    for (int st = 0; st < nstages; ++st) {
      const int base = st * stage_rows, rows = min(stage_rows, m - base);
      if (loaded != st) {
        stage_next(t, base, rows, cloud, c);
        loaded = st;
      }
      if (!active) continue;
      // start a little before the group's own row (rounded down to a step), then wrap
      const int rel = q0 - base - kSelBack;
      const int start = (rel > 0 && rel < rows) ? (rel & ~31) : 0;
      const int wrap = base + start;
      sel_run<K>(S, buf, cloud, start, rows, base, lane, lt_mask, false, wrap);
      if (start > 0) sel_run<K>(S, buf, cloud, 0, start, base, lane, lt_mask, true, wrap);
    }
    if (!active) continue;
#pragma unroll
    for (int r = 0; r < kSelQ; ++r) {
      if (S[r].cnt > 0) sel_merge<K>(S[r], buf + 32 * r, lane, false, 0);
      const int qi = q0 + r;
      if (qi < n && lane < K) {
        const float qn = 0.25f * (S[r].ax * S[r].ax + S[r].ay * S[r].ay + S[r].az * S[r].az);  // |q_c|^2
        idx_out[(size_t)qi * K + lane] = S[r].li;
        dist_out[(size_t)qi * K + lane] = S[r].ld + qn;
      }
    }
  }
}

// -- radius_count ---------------------------------------------------------------
//
// What bounds it. Not the pairs: at the radius filter's 4096 rows (3572
// valid, r = 0.8 m) the 12.8 M valid pairs are 1.9 us of fp32 work at 67
// TFLOP/s, and an 0.8 m neighbourhood holds ~5 targets of a query, so nearly
// all of that work is on pairs that cannot count; at 16384 rows 40% of the
// rows are padding. Run on nn1's skeleton (one 1024-thread block per SM, the
// whole cloud staged per block), the staging and the barriers set the time,
// not the pairs. When only the pairs that can count are tested, what is left
// is latency (the launch, a few dependent L2 round trips) and the L2
// requests of the tile bounds, which every query tile reads for every
// target tile.
//
// The design:
// - Tiles of 32 rows, one a lane. A tile's rows fall in three classes:
//   valid (|x| < 1e5 on every axis, as nn1's centring), other (not valid,
//   not NaN: the PAD_COORD padding) and NaN rows, which never count and are
//   never counted, since every compare with NaN is false. A tile's boxes are
//   the bounding box and count of its valid rows and, apart, of its other
//   rows; the other rows are "one point" when that box is a point.
// - Phase 1: each block's warp 0 (and others when there are more target
//   tiles than blocks) writes a target tile's boxes to the table, kRcBox
//   floats a tile stored component by component (a warp then reads 32
//   consecutive tiles' component in one 128-byte line), then stamps the tile
//   with the launch's stamp (a release store). A reader waits for the stamp
//   (an acquire load) a bounded time, enough for blocks that start together,
//   and past it computes the tile's boxes from its rows itself: no wait is
//   unbounded, so the launch needs no grid barrier and no block need be
//   resident. A launch with `own` set takes that path on every tile (the
//   check that it counts as the table does: chip_smoke.py check_radius).
//   The stamp is an argument of the launch, so a launch must not be
//   captured in a CUDA graph: a replay would find its stamp already on the
//   tiles, from the replay before, and read boxes of another target
//   (ops/knn.py refuses a launch under capture).
// - Phase 2: a block owns a query tile at a time; its warps read the target
//   tiles' boxes 32 consecutive tiles a warp. A (query class, target class)
//   pair of boxes is skipped when the fp32 lower bound of its distance, the
//   per-axis gap max(0, qlo - thi, tlo - qhi) through the pair test's FMA
//   chain, is >= r^2. Rounding is monotone and each gap is at most every |dx|
//   of the two boxes, so the bound is at most every computed d^2 of their
//   rows, and a skipped pair of boxes holds no counted pair.
// - A target tile whose valid rows no query reaches and whose other rows are
//   one point (the padding) costs each lane one test against that point,
//   times their count, and one test for all such tiles of a warp's 32 when
//   they share the point: padded queries keep the count of the padded
//   targets.
// - Any other tile not skipped goes to the block's list in shared memory.
//   The block then reads the rows of kRcStage listed tiles at once (one row
//   a thread and step, coalesced: one L2 round trip, not one a tile) into
//   shared memory, and the warps take the staged tiles in turn (the tiles
//   near a query tile, adjacent in the voxel-key order, spread over the
//   warps), each counted against the warp's 32 queries by broadcast reads.
//   A warp counts the tiles that overflow the list (more than kRcList full
//   tiles, at m > 32768 rows) itself, one at a time.
// - The warps' counts of a query are summed in warp order in shared memory
//   and warp 0 writes them: each output row is written once, by its owner
//   (no memset). Every pair that is tested takes the same arithmetic as
//   before, and integer counts do not depend on which warp adds them, so the
//   counts are the earlier kernel's bit for bit.
// With a stats pointer the kernel also counts the tile pairs it tested in
// full and against one point (ops/knn.py radius_count_tiles), and the lanes
// whose wait for a tile's stamp ran out, so that they computed the tile's
// boxes themselves (the program's tracer reads it).

constexpr int kRcThreads = 256;            // radius_count: threads per block
constexpr int kRcWarps = kRcThreads / 32;
constexpr int kRcTile = 32;                // rows per tile, one a lane
constexpr int kRcBox = 14;                 // table floats per tile
constexpr int kRcList = 1024;              // full tiles of a query tile dealt through shared memory
constexpr int kRcStage = 32;               // listed tiles the block stages in shared memory at once
constexpr long long kRcWaitCycles = 20000; // how long a lane waits for a tile's stamp (~10 us)

// the table's components: valid rows' lo, hi; other rows' lo, hi; their counts
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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Write tile j's boxes to the table of `stride` tiles, then stamp it: lane
// 0 writes every component, then the stamp with release semantics.
__device__ __forceinline__ void store_boxes(float* __restrict__ boxes, unsigned* __restrict__ stamps, int stride,
                                            int j, const TileBoxes& b, unsigned stamp, int lane) {
  if (lane != 0) return;
  const float v[kRcBox] = {b.v.lo[0], b.v.lo[1], b.v.lo[2], b.v.hi[0], b.v.hi[1], b.v.hi[2],
                           b.o.lo[0], b.o.lo[1], b.o.lo[2], b.o.hi[0], b.o.hi[1], b.o.hi[2],
                           __int_as_float(b.v.n), __int_as_float(b.o.n)};
#pragma unroll
  for (int c = 0; c < kRcBox; ++c) boxes[(size_t)c * stride + j] = v[c];
  st_release(stamps + j, stamp);
}

// Tile j's boxes computed by this lane alone from the tile's rows, with the
// same exact minima and maxima as tile_boxes (ordered integers): the
// fallback for a tile whose stamp does not come (out of line: it is rare,
// and inline it would cost the common path registers).
__device__ __noinline__ TileBoxes lane_boxes(const float* __restrict__ t, int m, int j) {
  TileBoxes b;
  int vlo[3], vhi[3], olo[3], ohi[3];  // ordered coordinates
  b.v.n = b.o.n = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    vlo[a] = olo[a] = INT_MAX;
    vhi[a] = ohi[a] = INT_MIN;
  }
  for (int r = j * kRcTile; r < min(m, (j + 1) * kRcTile); ++r) {
    const float* p = t + 3 * (size_t)r;
    const float v[3] = {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
    if (fabsf(v[0]) < kValidAbs && fabsf(v[1]) < kValidAbs && fabsf(v[2]) < kValidAbs) {
      ++b.v.n;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        vlo[a] = min(vlo[a], ordered(v[a]));
        vhi[a] = max(vhi[a], ordered(v[a]));
      }
    } else if (v[0] == v[0] && v[1] == v[1] && v[2] == v[2]) {
      ++b.o.n;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        olo[a] = min(olo[a], ordered(v[a]));
        ohi[a] = max(ohi[a], ordered(v[a]));
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.v.lo[a] = b.v.n > 0 ? unordered(vlo[a]) : INFINITY;
    b.v.hi[a] = b.v.n > 0 ? unordered(vhi[a]) : -INFINITY;
    b.o.lo[a] = b.o.n > 0 ? unordered(olo[a]) : INFINITY;
    b.o.hi[a] = b.o.n > 0 ? unordered(ohi[a]) : -INFINITY;
  }
  return b;
}

// Tile j's boxes: from the table once its stamp is this launch's (written
// by another block of this launch: read past L1). The lane waits for the
// stamp up to kRcWaitCycles, the time blocks that start together take to
// write the table, then computes the boxes itself (lane_boxes): no wait is
// unbounded, so no block depends on another being resident. With `own` it
// computes them itself at once.
// `expired` counts the waits that ran out.
__device__ __forceinline__ TileBoxes load_boxes(const float* __restrict__ boxes, const unsigned* __restrict__ stamps,
                                                int stride, int j, unsigned stamp, const float* __restrict__ t,
                                                int m, bool own, int& expired) {
  if (own) return lane_boxes(t, m, j);
  bool ready = ld_acquire(stamps + j) == stamp;
  if (!ready) {
    const long long t0 = clock64();
    do {
      __nanosleep(100);
      ready = ld_acquire(stamps + j) == stamp;
    } while (!ready && clock64() - t0 < kRcWaitCycles);
    if (!ready) {
      ++expired;
      return lane_boxes(t, m, j);
    }
  }
  const float* p = boxes + j;
  TileBoxes b;
  b.v.n = __float_as_int(__ldcg(p + (size_t)kNv * stride));
  b.o.n = __float_as_int(__ldcg(p + (size_t)kNo * stride));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.v.lo[a] = b.v.n > 0 ? __ldcg(p + (size_t)(kVlo + a) * stride) : INFINITY;
    b.v.hi[a] = b.v.n > 0 ? __ldcg(p + (size_t)(kVhi + a) * stride) : -INFINITY;
    b.o.lo[a] = b.o.n > 0 ? __ldcg(p + (size_t)(kOlo + a) * stride) : INFINITY;
    b.o.hi[a] = b.o.n > 0 ? __ldcg(p + (size_t)(kOhi + a) * stride) : -INFINITY;
  }
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

__global__ void __launch_bounds__(kRcThreads)
radius_count_kernel(const float* __restrict__ q, int n, const float* __restrict__ t, int m, float r2,
                    float* __restrict__ boxes, unsigned* __restrict__ stamps, unsigned stamp, int own,
                    int* __restrict__ stats, int* __restrict__ out) {
  __shared__ float4 s_stage[kRcStage * kRcTile];  // staged rows of listed target tiles
  __shared__ int s_cnt[kRcWarps][kRcTile];        // the warps' counts of the block's query tile
  __shared__ int s_list[kRcList];                 // the query tile's full target tiles
  __shared__ int s_nlist;
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
  float4 qnext = query((int)blockIdx.x);

  // phase 1: the target tiles' boxes, tile j by block j % gridDim.x
  for (int j = blockIdx.x + gridDim.x * warp; j < ttiles; j += gridDim.x * kRcWarps) {
    const int r = j * kRcTile + lane;
    const float4 p = tile_row(t, m, r);
    store_boxes(boxes, stamps, ttiles, j, tile_boxes(r < m, p.x, p.y, p.z), stamp, lane);
  }

  // phase 2: the query tiles
  int nfull = 0, npoint = 0, nexpired = 0;
  for (int qt = blockIdx.x; qt < qtiles; qt += gridDim.x) {
    const int qi = qt * kRcTile + lane;
    const bool qin = qi < n;
    const float qx = qnext.x, qy = qnext.y, qz = qnext.z;
    if (qt + (int)gridDim.x < qtiles) qnext = query(qt + (int)gridDim.x);
    const TileBoxes qb = tile_boxes(qin, qx, qy, qz);
    if (threadIdx.x == 0) s_nlist = 0;
    __syncthreads();  // also: the previous query tile is done with s_list and s_cnt
    int cnt = 0;
    for (int first = warp * kRcTile; first < ttiles; first += kRcThreads) {
      const int j = first + lane;  // this lane's target tile
      bool full = false, point = false;
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      int pn = 0;
      if (j < ttiles) {
        const TileBoxes tb = load_boxes(boxes, stamps, ttiles, j, stamp, t, m, own != 0, nexpired);
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
      // the other tiles not skipped go to the block's list; past its end, this warp counts them
      const unsigned mf = __ballot_sync(kFull, full);
      nfull += __popc(mf);
      if (mf == 0) continue;
      int base = 0;
      if (lane == 0) base = atomicAdd(&s_nlist, __popc(mf));
      base = __shfl_sync(kFull, base, 0) + __popc(mf & lt_mask);
      if (full && base < kRcList) s_list[base] = j;
      // (its own 32 rows of the stage: the block stages only after the loop)
      float4* slot = s_stage + warp * kRcTile;
      for (unsigned own = __ballot_sync(kFull, full && base >= kRcList); own != 0; own &= own - 1) {
        slot[lane] = tile_row(t, m, (first + __ffs(own) - 1) * kRcTile + lane);
        __syncwarp();
        cnt += count_tile(slot, qx, qy, qz, r2);
        __syncwarp();
      }
    }
    __syncthreads();
    // the listed tiles, kRcStage at a time: the block reads their rows at
    // once (one row a thread and step, coalesced), then warp w counts the
    // staged tiles w, w + kRcWarps, ...
    const int listed = min(s_nlist, kRcList);
    for (int c0 = 0; c0 < listed; c0 += kRcStage) {
      const int rows = min(kRcStage, listed - c0) * kRcTile;
#pragma unroll
      for (int i = 0; i < kRcStage * kRcTile / kRcThreads; ++i) {
        const int e = threadIdx.x + i * kRcThreads;
        if (e < rows) s_stage[e] = tile_row(t, m, s_list[c0 + e / kRcTile] * kRcTile + e % kRcTile);
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
      out[qi] = total;
    }
  }
  if (stats != nullptr) {
    const int expired = __reduce_add_sync(kFull, nexpired);
    if (lane == 0) {
      atomicAdd(stats, nfull);
      atomicAdd(stats + 1, npoint);
      atomicAdd(stats + 2, expired);
    }
  }
}

// -- launch plans -------------------------------------------------------------

struct Plan {
  int threads, stage_rows, smem, blocks_per_sm, grid, regs, static_smem;
};

// What the runtime reports for a kernel on a device does not change, so each
// (device, kernel, staged rows) is planned once and a launch only looks its
// plan up. The kernel is its function pointer, so each instantiation of
// knn_select_kernel (each K) has plans of its own. The lock covers callers
// on several host threads.
std::mutex g_plans_mu;
std::map<std::tuple<int, const void*, int>, std::pair<Plan, int>> g_plans;  // -> (plan, SMs)

// Launch plan of `fn` on the current device for m targets and `work` block
// tasks per problem of a batch of `batch`: the stage is the whole cloud when
// it fits the block's shared memory beside `scratch` bytes (and
// kRowsPerThread rows per thread), else the largest number of rows that
// does; the grid is persistent, at most the SMs times the resident blocks per
// SM over all problems (gridDim.x = that over the batch, at least 1).
cudaError_t make_plan(const void* fn, int threads, int scratch, int m, int work, int batch, Plan* p) {
  int dev;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const int rows = m < kRowsPerThread * threads ? m : kRowsPerThread * threads;  // a stage holds no more
  std::lock_guard<std::mutex> lock(g_plans_mu);
  auto it = g_plans.find(std::make_tuple(dev, fn, rows));
  if (it == g_plans.end()) {
    int sms, optin;
    cudaFuncAttributes a;
    Plan q;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return e;
    if ((e = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return e;
    const int dyn_max = optin - (int)a.sharedSizeBytes;
    const int cap = (dyn_max - scratch) / (int)sizeof(float4);
    if (cap < 32) return cudaErrorInvalidConfiguration;
    q.threads = threads;
    q.stage_rows = rows < cap ? rows : cap;
    q.smem = q.stage_rows * (int)sizeof(float4) + scratch;
    // the largest the device allows, the same value on every call
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_max)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q.blocks_per_sm, fn, threads, q.smem)) != cudaSuccess)
      return e;
    if (q.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    q.grid = 0;
    q.regs = a.numRegs;
    q.static_smem = (int)a.sharedSizeBytes;
    it = g_plans.emplace(std::make_tuple(dev, fn, rows), std::make_pair(q, sms)).first;
  }
  *p = it->second.first;
  int slots = it->second.second * p->blocks_per_sm / batch;
  if (slots < 1) slots = 1;
  p->grid = work < slots ? work : slots;
  return cudaSuccess;
}

cudaError_t plan_nn1(int n, int m, int batch, Plan* p) {
  return make_plan((const void*)nn1_kernel, kThreads, kNnScratch, m, (n + kNnChunk - 1) / kNnChunk, batch, p);
}

// The instantiation of knn_select_kernel for k, or null for a k it is not
// built for.
const void* knn_select_fn(int k) {
  switch (k) {
    case 8: return (const void*)knn_select_kernel<8>;
    case 10: return (const void*)knn_select_kernel<10>;
    case 20: return (const void*)knn_select_kernel<20>;
    case 21: return (const void*)knn_select_kernel<21>;
    default: return nullptr;
  }
}

cudaError_t plan_knn_select(const void* fn, int n, int m, int batch, Plan* p) {
  const int groups = (n + kSelQ - 1) / kSelQ;
  return make_plan(fn, kThreads, kSelScratch, m, (groups + kWarps - 1) / kWarps, batch, p);
}

// radius_count's launch: kRcThreads threads, no dynamic shared memory; the
// grid is a block per query tile (or per kRcWarps target tiles, when there
// are more of those), at most the blocks the device holds at once (a block
// takes the next query tiles in turn).
cudaError_t plan_radius_count(int n, int m, Plan* p) {
  int dev;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const void* fn = (const void*)radius_count_kernel;
  std::lock_guard<std::mutex> lock(g_plans_mu);
  auto it = g_plans.find(std::make_tuple(dev, fn, 0));
  if (it == g_plans.end()) {
    int sms;
    cudaFuncAttributes a;
    Plan q{};
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    if ((e = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q.blocks_per_sm, fn, kRcThreads, 0)) != cudaSuccess)
      return e;
    if (q.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    q.threads = kRcThreads;
    q.regs = a.numRegs;
    q.static_smem = (int)a.sharedSizeBytes;
    it = g_plans.emplace(std::make_tuple(dev, fn, 0), std::make_pair(q, sms)).first;
  }
  *p = it->second.first;
  const int qtiles = (n + kRcTile - 1) / kRcTile, ttiles = (m + kRcTile - 1) / kRcTile;
  const int want = qtiles > (ttiles + kRcWarps - 1) / kRcWarps ? qtiles : (ttiles + kRcWarps - 1) / kRcWarps;
  const int slots = it->second.second * p->blocks_per_sm;
  p->grid = want < slots ? want : slots;
  return cudaSuccess;
}

constexpr int kMaxBatch = 65535;  // gridDim.y

// A failed runtime call leaves its error as the last error; clear it so the
// next launch's check does not report it again.
int failed(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// B problems of knn_select at k (one of 8, 10, 20, 21), m >= k.
int launch_knn_select(const float* q, int batch, int n, const float* t, int m, int k, int* idx, float* dist,
                      void* stream) {
  const void* fn = knn_select_fn(k);
  if (fn == nullptr || n <= 0 || m < k || batch <= 0 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan_knn_select(fn, n, m, batch, &p);
  if (e != cudaSuccess) return failed(e);
  int stage_rows = p.stage_rows;
  void* args[] = {&q, &n, &t, &m, &stage_rows, &idx, &dist};
  e = cudaLaunchKernel(fn, dim3(p.grid, batch), dim3(p.threads), args, p.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return failed(e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after the launch (0 = launched).
int hgs_nn1(const float* q, int n, const float* t, int m, int* idx, float* dist2, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan_nn1(n, m, 1, &p);
  if (e != cudaSuccess) return failed(e);
  nn1_kernel<<<p.grid, p.threads, p.smem, (cudaStream_t)stream>>>(q, n, t, m, p.stage_rows, idx, dist2);
  return (int)cudaGetLastError();
}

// B problems: q (B, n, 3) against t (B, m, 3) -> idx, dist2 (B, n).
int hgs_nn1_batched(const float* q, int batch, int n, const float* t, int m, int* idx, float* dist2,
                    void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan_nn1(n, m, batch, &p);
  if (e != cudaSuccess) return failed(e);
  nn1_kernel<<<dim3(p.grid, batch), p.threads, p.smem, (cudaStream_t)stream>>>(q, n, t, m, p.stage_rows, idx,
                                                                               dist2);
  return (int)cudaGetLastError();
}

// k is one of 8, 10, 20, 21; m >= k.
int hgs_knn_select(const float* q, int n, const float* t, int m, int k, int* idx, float* dist, void* stream) {
  return launch_knn_select(q, 1, n, t, m, k, idx, dist, stream);
}

// B problems: q (B, n, 3) against t (B, m, 3) -> idx, dist (B, n, k).
int hgs_knn_select_batched(const float* q, int batch, int n, const float* t, int m, int k, int* idx, float* dist,
                           void* stream) {
  return launch_knn_select(q, batch, n, t, m, k, idx, dist, stream);
}

// out[i] = #{j : |q_i - t_j|^2 < r2}, q (n, 3) and t (m, 3), in one
// launch. With T = ceil(m / 32) target tiles, boxes is scratch of
// kRcBox * T floats and stamps T uint32 that hold 0 or an earlier launch's
// stamp; stamp is this launch's, above every stamp in stamps (each launch
// leaves its stamp on every tile). own != 0 has every lane compute its
// tiles' boxes from their rows (the fallback path, for checks). stats is
// null, or three int32 that get the tile pairs tested in full and against
// one point and the lanes whose stamp wait ran out added.
int hgs_radius_count(const float* q, int n, const float* t, int m, float r2, float* boxes, unsigned* stamps,
                     unsigned stamp, int own, int* stats, int* out, void* stream) {
  if (n <= 0 || m <= 0 || stamp == 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan_radius_count(n, m, &p);
  if (e != cudaSuccess) return failed(e);
  radius_count_kernel<<<p.grid, p.threads, 0, (cudaStream_t)stream>>>(q, n, t, m, r2, boxes, stamps, stamp, own,
                                                                      stats, out);
  return (int)cudaGetLastError();
}

// radius_count's launch at (n, m) on the current device: out = [resident
// blocks per SM, threads per block, grid blocks, registers per thread,
// static shared memory bytes, query tiles, target tiles, box table floats].
int hgs_radius_count_launch_info(int n, int m, int* out) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan_radius_count(n, m, &p);
  if (e != cudaSuccess) return failed(e);
  const int ttiles = (m + kRcTile - 1) / kRcTile;
  const int v[8] = {p.blocks_per_sm, p.threads, p.grid, p.regs, p.static_smem, (n + kRcTile - 1) / kRcTile,
                    ttiles, ttiles * kRcBox};
  for (int j = 0; j < 8; ++j) out[j] = v[j];
  return 0;
}

// The launch plan of kernel `which` (0 = nn1, 1 = knn_select at k) at (n,
// m) and a batch of `batch` problems on
// the current device: out = [resident blocks per SM, threads per block,
// dynamic shared memory bytes, grid blocks per problem, registers per
// thread, staged rows, static shared memory bytes]. Returns a cudaError_t
// (0 = ok).
int hgs_knn_launch_info_batched(int which, int batch, int n, int m, int k, int* out) {
  if (n <= 0 || m <= 0 || which < 0 || which > 1 || batch <= 0 || batch > kMaxBatch)
    return (int)cudaErrorInvalidValue;
  if (which == 1 && knn_select_fn(k) == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = which == 0 ? plan_nn1(n, m, batch, &p) : plan_knn_select(knn_select_fn(k), n, m, batch, &p);
  if (e != cudaSuccess) return failed(e);
  const int v[7] = {p.blocks_per_sm, p.threads, p.smem, p.grid, p.regs, p.stage_rows, p.static_smem};
  for (int j = 0; j < 7; ++j) out[j] = v[j];
  return 0;
}

}  // extern "C"
