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
//
// ndt_derivatives_kernel: ndt.py:155 score_derivatives over :91
//   _gather_mean_icov. Per source point p = T x and each found cell k of
//   its association, the kernel reads the cell's (12,) [mean | icov] row
//   itself, forms q = p - mu, a = B q, u = max(q.a, 0) and
//   E = d1 exp(-d2/2 u), and accumulates the point's moments
//   sum E, a~ = sum E a, A~ = sum E a a^T, B~ = sum E B. With
//   M = -d2 A~ + B~ and Hp = hat(p) the point adds (unscaled by -d2)
//     g  += [a~, p x a~]
//     Hvv += M,  Hvw += -M Hp + hat(a~)/2,
//     Hww += -Hp M Hp + (a~ p^T + p a~^T)/2 - (a~.p) I,
//   which is ndt.py's block algebra :200-233 with its -d2 Agg Hp - B~ Hp
//   terms folded into M. Per thread those 6 + 21 (the upper triangle) + 1
//   (score) sums, then a fixed-order block reduction into per-block
//   partials, and ndt_finish_kernel sums the partials in block order (in
//   float64) and writes g = -d2 g, the symmetric H = -d2 H and the score.
//
// ndt_score_kernel: ndt.py:137 _score under the line search's vmap (:399):
//   L trial poses against one association, the trial in blockIdx.y, the
//   sum over points and found cells of E reduced like the derivatives.
//
// Every kernel takes a leading batch B of problems sharing one target (the
// loop detector's candidates; odometry has B = 1) in the last grid
// dimension; the unbatched wrappers are B = 1 of the same launch.
//
// Determinism: no float atomics. Each block writes its own partial row;
// the grid size is a function of N only, and the finish kernel sums the
// partials of a row in block order, so two runs on one card agree bit for
// bit.
//
// Bound. At the bench's N = 8192 and K = 7 the derivatives read 98 KB of
// points, 57 KB of association (int32 rows + flags) and at most the V
// valid cells' 48-byte rows (~60 KB at 2 m cells) and do ~50 fp32
// operations per found pair plus ~200 per point: ~5 MFLOP against
// ~0.2 MB, under 1 us either way. What bounds this simple form is latency:
// the gathers of cell rows by index, one thread per point, 128 threads a
// block, and the two launches. Staging cell rows in shared memory and
// fusing the finish into the last block are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block of the three reductions
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // partial rows per problem, at most
constexpr int kMaxK = 8;  // DIRECT7 = 7, KDTREE = 8 (ndt.py _KDTREE_MAX_CELLS)
constexpr int kLocalBits = 10;
constexpr int kLocalRange = 1 << kLocalBits;
constexpr int kLocalInvalid = 0x7fffffff;
constexpr int kDerivWidth = 28;  // g (6), H upper triangle (21), score (1)
constexpr int kDerivOut = 43;  // g (6), H (36), score (1)
constexpr unsigned kFull = 0xffffffffu;

// voxel.py neighbor_offsets: DIRECT1 is the first row, DIRECT7 all seven
__constant__ int c_offsets[7][3] = {{0, 0, 0}, {1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                                    {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};

// The blocks per problem for n points: one point per thread up to
// kMaxBlocks blocks, then a grid-stride loop.
int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
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

// Sum `width` values per thread over the block in a fixed order (warp
// shuffles, then the warps in order) and write them to out[0..width).
template <int W>
__device__ __forceinline__ void block_sum(float (&v)[W], float* __restrict__ out) {
  __shared__ float s[kWarps][W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    float x = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
    if (lane == 0) s[warp][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < W) {
    float x = s[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += s[w][threadIdx.x];
    out[threadIdx.x] = x;
  }
}

// -- association --------------------------------------------------------------

__global__ void __launch_bounds__(256)
ndt_associate_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                     const float* __restrict__ T, int n, int K, const int* __restrict__ origin, float res,
                     const int* __restrict__ grid, int G, const int* __restrict__ keys,
                     const unsigned char* __restrict__ vmask, int V, int* __restrict__ idx_out,
                     unsigned char* __restrict__ found_out) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = (size_t)b * n + i;
  float p[3];
  transform(T + 16 * b, xyz[3 * row], xyz[3 * row + 1], xyz[3 * row + 2], p);
  const bool valid = mask[row] != 0;
  int c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) c[a] = (int)floorf(p[a] / res) - origin[a];
  const int lim = G > 0 ? (G < kLocalRange ? G : kLocalRange) : kLocalRange;
  for (int k = 0; k < K; ++k) {
    const int r0 = c[0] + c_offsets[k][0], r1 = c[1] + c_offsets[k][1], r2 = c[2] + c_offsets[k][2];
    const bool in = valid && r0 >= 0 && r0 < lim && r1 >= 0 && r1 < lim && r2 >= 0 && r2 < lim;
    int id;
    bool f;
    if (G > 0) {  // voxel.py lookup_dense: an out-of-grid query reads cell 0
      const int v = __ldg(grid + (in ? (r0 * G + r1) * G + r2 : 0));
      f = in && v >= 0;
      id = v > 0 ? v : 0;
    } else {  // voxel.py lookup_voxels: lower bound in the sorted keys
      const int key = in ? (r0 << (2 * kLocalBits)) | (r1 << kLocalBits) | r2 : kLocalInvalid;
      int lo = 0, hi = V;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(keys + mid) < key) lo = mid + 1; else hi = mid;
      }
      id = lo < V - 1 ? lo : V - 1;
      f = in && __ldg(keys + id) == key && vmask[id] != 0;
    }
    idx_out[row * K + k] = id;
    found_out[row * K + k] = f;
  }
}

// -- derivatives ----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ndt_derivatives_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                       const float* __restrict__ T, int n, int K, const int* __restrict__ idx,
                       const unsigned char* __restrict__ found, const float4* __restrict__ rows, float d1,
                       float d2, float* __restrict__ partial) {
  const int b = blockIdx.y;
  const float* Tb = T + 16 * b;
  float acc[kDerivWidth];
#pragma unroll
  for (int j = 0; j < kDerivWidth; ++j) acc[j] = 0.0f;
  const float hd2 = -0.5f * d2;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const size_t row = (size_t)b * n + i;
    if (!mask[row]) continue;
    float p[3];
    transform(Tb, xyz[3 * row], xyz[3 * row + 1], xyz[3 * row + 2], p);
    float sE = 0.0f, ea[3] = {0.0f, 0.0f, 0.0f}, A[6] = {0, 0, 0, 0, 0, 0}, Bs[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < K; ++k) {
      if (!found[row * K + k]) continue;
      float mu[3], B[9];
      load_row(rows, idx[row * K + k], mu, B);
      const float q0 = p[0] - mu[0], q1 = p[1] - mu[1], q2 = p[2] - mu[2];
      const float a0 = fmaf(B[0], q0, fmaf(B[1], q1, B[2] * q2));
      const float a1 = fmaf(B[3], q0, fmaf(B[4], q1, B[5] * q2));
      const float a2 = fmaf(B[6], q0, fmaf(B[7], q1, B[8] * q2));
      const float u = fmaxf(fmaf(q0, a0, fmaf(q1, a1, q2 * a2)), 0.0f);
      const float E = d1 * expf(hd2 * u);
      sE += E;
      const float e0 = E * a0, e1 = E * a1, e2 = E * a2;
      ea[0] += e0; ea[1] += e1; ea[2] += e2;
      A[0] = fmaf(e0, a0, A[0]); A[1] = fmaf(e0, a1, A[1]); A[2] = fmaf(e0, a2, A[2]);
      A[3] = fmaf(e1, a1, A[3]); A[4] = fmaf(e1, a2, A[4]); A[5] = fmaf(e2, a2, A[5]);
#pragma unroll
      for (int j = 0; j < 9; ++j) Bs[j] = fmaf(E, B[j], Bs[j]);
    }
    // M = -d2 A~ + B~ (symmetric; B~ is the sum of symmetric icovs)
    float M[3][3];
    M[0][0] = fmaf(-d2, A[0], Bs[0]); M[1][1] = fmaf(-d2, A[3], Bs[4]); M[2][2] = fmaf(-d2, A[5], Bs[8]);
    M[0][1] = M[1][0] = fmaf(-d2, A[1], Bs[1]);
    M[0][2] = M[2][0] = fmaf(-d2, A[2], Bs[2]);
    M[1][2] = M[2][1] = fmaf(-d2, A[4], Bs[5]);
    // Hp = hat(p): Hp v = p x v
    const float Hp[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
    float MH[3][3];  // M Hp
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) MH[r][c] = M[r][0] * Hp[0][c] + M[r][1] * Hp[1][c] + M[r][2] * Hp[2][c];
    const float he[3][3] = {{0.0f, -ea[2], ea[1]}, {ea[2], 0.0f, -ea[0]}, {-ea[1], ea[0], 0.0f}};
    const float adp = ea[0] * p[0] + ea[1] * p[1] + ea[2] * p[2];
    // gradient (unscaled): [a~, p x a~]
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
        // -Hp M Hp + (a~ p^T + p a~^T)/2 - (a~.p) I
        const float HMH = Hp[r][0] * MH[0][c] + Hp[r][1] * MH[1][c] + Hp[r][2] * MH[2][c];
        Hrow[3 + r][3 + c] = -HMH + 0.5f * (ea[r] * p[c] + p[r] * ea[c]) - (r == c ? adp : 0.0f);
      }
    int j = 6;
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = r; c < 6; ++c) acc[j++] += Hrow[r][c];
    acc[27] += sE;
  }
  block_sum<kDerivWidth>(acc, partial + ((size_t)b * gridDim.x + blockIdx.x) * kDerivWidth);
}

// -- trial scores -----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ndt_score_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
                 const float* __restrict__ T, int n, int K, const int* __restrict__ idx,
                 const unsigned char* __restrict__ found, const float4* __restrict__ rows, float d1, float d2,
                 float* __restrict__ partial) {
  const int l = blockIdx.y, L = gridDim.y, b = blockIdx.z;
  const float* Tl = T + 16 * ((size_t)b * L + l);
  const float hd2 = -0.5f * d2;
  float acc[1] = {0.0f};
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const size_t row = (size_t)b * n + i;
    if (!mask[row]) continue;
    float p[3];
    transform(Tl, xyz[3 * row], xyz[3 * row + 1], xyz[3 * row + 2], p);
    for (int k = 0; k < K; ++k) {
      if (!found[row * K + k]) continue;
      float mu[3], B[9];
      load_row(rows, idx[row * K + k], mu, B);
      const float q0 = p[0] - mu[0], q1 = p[1] - mu[1], q2 = p[2] - mu[2];
      const float a0 = fmaf(B[0], q0, fmaf(B[1], q1, B[2] * q2));
      const float a1 = fmaf(B[3], q0, fmaf(B[4], q1, B[5] * q2));
      const float a2 = fmaf(B[6], q0, fmaf(B[7], q1, B[8] * q2));
      const float u = fmaxf(fmaf(q0, a0, fmaf(q1, a1, q2 * a2)), 0.0f);
      acc[0] += d1 * expf(hd2 * u);
    }
  }
  block_sum<1>(acc, partial + ((size_t)b * L + l) * gridDim.x + blockIdx.x);
}

// -- second pass ------------------------------------------------------------------

// Row r of `partial` (nblk x width) summed over its blocks in order, in
// float64. width == kDerivWidth writes the derivatives' (43,) layout
// [g (6) | H (36, symmetric) | score] scaled as ndt.py does (g and H by
// -d2); width == 1 writes the sum.
__global__ void ndt_finish_kernel(const float* __restrict__ partial, int nblk, int width, float scale,
                                  float* __restrict__ out) {
  __shared__ double s[kDerivWidth];
  const int r = blockIdx.x, j = threadIdx.x;
  const float* pr = partial + (size_t)r * nblk * width;
  if (j < width) {
    double x = 0.0;
    for (int blk = 0; blk < nblk; ++blk) x += (double)pr[(size_t)blk * width + j];
    s[j] = x;
  }
  __syncthreads();
  if (width == 1) {
    if (j == 0) out[r] = (float)s[0];
    return;
  }
  float* o = out + (size_t)r * kDerivOut;
  if (j < 6) {
    o[j] = (float)(scale * s[j]);
  } else if (j < 42) {
    const int e = j - 6, rr = e / 6, cc = e % 6;
    const int lo = rr < cc ? rr : cc, hi = rr < cc ? cc : rr;
    // index of (lo, hi) in the row-major upper triangle
    const int t = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
    o[j] = (float)(scale * s[6 + t]);
  } else if (j == 42) {
    o[j] = (float)s[27];
  }
}

// A failed runtime call leaves its error as the last error; clear it so the
// next launch's check does not report it again.
int failed(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launches (0 = launched).

// B problems of n points against one target: xyz (B, n, 3), mask (B, n)
// uint8, T (B, 4, 4), K = 1 or 7 -> idx (B, n, K) int32, found (B, n, K)
// uint8. G > 0 reads the dense grid (G^3,); G == 0 searches keys (V,) with
// vmask (V,).
int hgs_ndt_associate(const float* xyz, const unsigned char* mask, const float* T, int batch, int n, int K,
                      const int* origin, float res, const int* grid, int G, const int* keys,
                      const unsigned char* vmask, int V, int* idx, unsigned char* found, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || (K != 1 && K != 7) || G < 0 || (G == 0 && V <= 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grd((n + 255) / 256, batch);
  ndt_associate_kernel<<<grd, 256, 0, (cudaStream_t)stream>>>(xyz, mask, T, n, K, origin, res, grid, G, keys,
                                                              vmask, V, idx, found);
  return (int)cudaGetLastError();
}

// The blocks per problem the reductions use at n points (the partial rows
// of the scratch the wrapper allocates).
int hgs_ndt_blocks(int n) { return blocks_for(n); }

// g (B, 6), H (B, 6, 6), score (B,) as out (B, 43); partial is scratch of
// B * hgs_ndt_blocks(n) * 28 floats. rows is the target's (V, 12) float32
// [mean | icov] table.
int hgs_ndt_derivatives(const float* xyz, const unsigned char* mask, const float* T, int batch, int n, int K,
                        const int* idx, const unsigned char* found, const float* rows, float d1, float d2,
                        float* partial, float* out, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const int nblk = blocks_for(n);
  ndt_derivatives_kernel<<<dim3(nblk, batch), kThreads, 0, (cudaStream_t)stream>>>(
      xyz, mask, T, n, K, idx, found, reinterpret_cast<const float4*>(rows), d1, d2, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return failed(e);
  ndt_finish_kernel<<<batch, 64, 0, (cudaStream_t)stream>>>(partial, nblk, kDerivWidth, -d2, out);
  return (int)cudaGetLastError();
}

// Scores of L trial poses T (B, L, 4, 4) under one association -> out
// (B, L); partial is scratch of B * L * hgs_ndt_blocks(n) floats.
int hgs_ndt_score(const float* xyz, const unsigned char* mask, const float* T, int batch, int L, int n, int K,
                  const int* idx, const unsigned char* found, const float* rows, float d1, float d2,
                  float* partial, float* out, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || L <= 0 || L > 65535 || K <= 0 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int nblk = blocks_for(n);
  ndt_score_kernel<<<dim3(nblk, L, batch), kThreads, 0, (cudaStream_t)stream>>>(
      xyz, mask, T, n, K, idx, found, reinterpret_cast<const float4*>(rows), d1, d2, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return failed(e);
  ndt_finish_kernel<<<batch * L, 64, 0, (cudaStream_t)stream>>>(partial, nblk, 1, 1.0f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
