// Batched SPD solve for Hopper (sm_90a):
//   x[g] = a[g]^-1 b[g]   for a (G, M, M), b (G, M, K), x (G, M, K),
// float32, row-major and contiguous.
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/spd_solve.py
// (_gj_solve_impl / _gj_kernel: Gauss-Jordan with the batch on the 128
// lanes, M padded to 8, one-hot iota row selects). Both kernels here run the
// same Gauss-Jordan elimination without pivoting: A is SPD and diagonally
// dominant in the Qeq solve (erf-screened Coulomb plus a positive hardness
// diagonal, identity rows for padding atoms). Step k updates every entry
// (i, j) of [A | B]:
//   row k:      s[k][j] = s[k][j] * (1 / s[k][k])
//   row i != k: s[i][j] = s[i][j] - s[i][k] * (s[k][j] * (1 / s[k][k]))
// with round-to-nearest products and differences (no fused multiply-add),
// which is the arithmetic of the plain PyTorch version, so that the kernels
// and it agree to the last bit.
//
// M <= 32 (spd_solve_warp_kernel): one warp a system, kSpdWarps systems a
// block, no block barrier. Lane j holds column j of [A | B] in registers, a
// register a row (32 of them for every M, the rows past M zero). Step k
// finds the pivot row in register 0: s[k][k] is lane k's register 0, and
// the multipliers s[i][k] are lane k's registers, read by shuffle. Each lane
// updates its column and moves every register down by one, the pivot row's
// new value into the last: row k + 1 is in register 0 at the next step, and
// after the M steps row i is in register 32 - M + i. Columns past the first
// 32 (M + K > 32) are taken by further passes of the warp, which replay the
// M steps with the reciprocals and multipliers that the first pass kept in
// shared memory (one __syncwarp between).
//
// M > 32 (spd_solve_gj_kernel<R>): one thread block a system, [A | B] in
// shared memory column-major, s[j * P + i] with the column length P = M | 1
// (odd, so that the transposing load is free of bank conflicts). Warp w owns
// the columns j = w (mod warps), so the warps stay balanced as the columns
// past the pivot shrink; lane l owns the rows i = l (mod 32), R = ceil(M /
// 32) of them, an instance for each R from 2 to 8. The steps go in blocks of
// kSpdSteps (3): every thread runs a block's steps on the pivot rows' own
// 3 x 3 corner (reciprocals, the pivot rows' corner entries, the corner
// rows' multipliers) and on its own rows' 3 corner entries (their
// multipliers of each step). The pivot row entries of each column past the
// block's pivots are formed lane-parallel, a column a lane, and handed out
// by shuffle; each such column is then loaded once, goes through the 3 steps
// in registers and is stored once, and the pivot rows' values are stored
// last. So 3 steps move each live entry through shared memory once, with no
// integer division and one block barrier. Each entry goes through the plain
// version's operations in its order, so the blocked steps give its bits.
//
// Bound: the call must read a (G*M*M*4 bytes) and b (G*M*K*4) and write x
// (G*M*K*4); at the Qeq serving shape (G=513, M=20, K=2) that is 0.98 MB,
// about 0.29 us at 3.35 TB/s, and some 5 MFLOP, far below the card's float32
// rate. The warp kernel is instead bound by latency: M dependent steps, each
// waiting on a shuffle, the reciprocal and two rounded operations. The block
// kernel at large M by the instruction rate: two rounded operations an entry
// and step (no fused multiply-add), and its shared-memory traffic (a load and a
// store of each live entry every 3 steps); at small M by the latency of its
// M / 3 block steps (3 dependent reciprocals each, then the loads).
//
// Limit: the block kernel's shared memory, 4 * P * (M + K) bytes, must fit
// the 227 KB a block can use on sm_90; the Python wrapper's gate
// (4 * (M * (M + K) + M + (M + K)) bytes, at least that: M <= 239 for K = 2)
// is tested before it launches, for both kernels.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kSpdWarps = 4;  // systems of a block in the warp kernel
constexpr int kWarpM = 32;    // the warp kernel's largest M
constexpr int kSpdSteps = 3;        // steps the block kernel takes at once
constexpr int kSpdBlockWarps = 15;  // the block kernel's most warps (odd)
constexpr int kSpdColsPerWarp = 24;  // columns of [A | B] a block kernel warp owns at first
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kSpdWarps * 32) spd_solve_warp_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ x, int G,
    int M, int K) {
  // the first pass's step k: 1 / s[k][k] in [k][0], the multiplier of
  // register r in [k][r], for the passes over columns past 32
  __shared__ float kept[kSpdWarps][kWarpM][kWarpM];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kSpdWarps + warp;
  if (g >= G) return;
  const int W = M + K;
  const float* ag = a + g * M * M;
  const float* bg = b + g * M * K;
  float* xg = x + g * M * K;
  float(*kw)[kWarpM] = kept[warp];
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int col = c0 + lane;
    float s[kWarpM];
#pragma unroll
    for (int r = 0; r < kWarpM; ++r) {
      s[r] = 0.0f;
      if (r < M && col < W)
        s[r] = col < M ? __ldg(ag + r * M + col) : __ldg(bg + r * K + col - M);
    }
    for (int k = 0; k < M; ++k) {
      float inv, mult[kWarpM];
      if (c0 == 0) {
        inv = 1.0f / __shfl_sync(kFull, s[0], k);
#pragma unroll
        for (int r = 1; r < kWarpM; ++r) mult[r] = __shfl_sync(kFull, s[r], k);
        if (W > 32 && lane == 0) {
          kw[k][0] = inv;
#pragma unroll
          for (int r = 1; r < kWarpM; ++r) kw[k][r] = mult[r];
        }
      } else {
        inv = kw[k][0];
#pragma unroll
        for (int r = 1; r < kWarpM; ++r) mult[r] = kw[k][r];
      }
      const float rk = __fmul_rn(s[0], inv);
#pragma unroll
      for (int r = 1; r < kWarpM; ++r) s[r - 1] = __fsub_rn(s[r], __fmul_rn(mult[r], rk));
      s[kWarpM - 1] = rk;
    }
    if (c0 == 0) __syncwarp();  // the kept steps, before a later pass reads them
#pragma unroll
    for (int r = 0; r < kWarpM; ++r)
      if (r >= kWarpM - M && col >= M && col < W) xg[(r - (kWarpM - M)) * K + col - M] = s[r];
  }
}

// The block kernel: see the header. Steps k .. k + ns - 1 (ns = kSpdSteps,
// fewer at the end) are one block step. Every thread first runs them on the
// pivot rows' own ns x ns corner (X), which gives each step's reciprocal
// inv[t], its pivot row's corner entries R[t][c] (c > t) and the multipliers
// of the corner rows, cm[a][t] (a != t); then the multipliers of its own
// rows, m[t][r], by running the steps on the row's ns corner entries. A
// column j >= k + ns needs each step's pivot row entry rk[t], formed the
// same way from its pivot rows' entries: each lane forms them for one of its
// warp's columns and hands them to the others by shuffle while the warp
// takes each column's entries through the ns steps in registers, one load
// and one store an entry. A tail block (ns < kSpdSteps) runs with +0 in the
// missing steps' multipliers and pivot row entries, whose products, +0,
// leave every value's bits as they are.
template <int kR>
__global__ void __launch_bounds__(kSpdBlockWarps * 32) spd_solve_gj_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ x, int M,
    int K) {
  constexpr int S = kSpdSteps;
  extern __shared__ float s[];  // [A | B] column-major: s[j * P + i]
  const int W = M + K, P = M | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t g = blockIdx.x;
  const float* ag = a + g * M * M;
  const float* bg = b + g * M * K;
  const bool last_row = lane + 32 * (kR - 1) < M;  // this lane's row in the last 32
  // row i of A (coalesced, R loads a lane in flight) into entry i of each
  // column, and B
  for (int i = warp; i < M; i += nw) {
    float v[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      v[r] = r < kR - 1 || last_row ? __ldg(ag + i * M + lane + 32 * r) : 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (r < kR - 1 || last_row) s[(lane + 32 * r) * P + i] = v[r];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    for (int c = 0; c < K; ++c) s[(M + c) * P + i] = __ldg(bg + i * K + c);
  __syncthreads();
  int j0 = warp;  // the warp's first column past the block step's pivots
  for (int k = 0; k < M; k += S) {
    const int ns = min(S, M - k);
    while (j0 < k + ns) j0 += nw;
    // the corner, identity past ns
    float X[S][S], inv[S], R[S][S], cm[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c)
        X[r][c] = r < ns && c < ns ? s[(k + c) * P + k + r] : (r == c ? 1.0f : 0.0f);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      inv[t] = 1.0f / X[t][t];
#pragma unroll
      for (int c = t + 1; c < S; ++c) R[t][c] = __fmul_rn(X[t][c], inv[t]);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        if (r == t) continue;
        cm[r][t] = X[r][t];
#pragma unroll
        for (int c = t + 1; c < S; ++c) X[r][c] = __fsub_rn(X[r][c], __fmul_rn(X[r][t], R[t][c]));
      }
#pragma unroll
      for (int c = t + 1; c < S; ++c) X[t][c] = R[t][c];
    }
    // this lane's rows' multipliers of each step
    float m[S][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float e[S];
#pragma unroll
      for (int c = 0; c < S; ++c)
        e[c] = c < ns && (r < kR - 1 || last_row) ? s[(k + c) * P + lane + 32 * r] : 0.0f;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        m[t][r] = t < ns ? e[t] : 0.0f;
#pragma unroll
        for (int c = t + 1; c < S; ++c) e[c] = __fsub_rn(e[c], __fmul_rn(m[t][r], R[t][c]));
      }
    }
    // the warp's columns past the pivots, 32 at a time: lane l first forms
    // each step's pivot row entry rk[t] of column jb + l nw from its pivot
    // rows' entries, and those rows' values after the block step, f[t]
    for (int jb = j0; jb < W; jb += 32 * nw) {
      const int jl = jb + lane * nw;
      float rk[S], f[S];
      {
        float q[S];
#pragma unroll
        for (int t = 0; t < S; ++t) q[t] = jl < W && t < ns ? s[jl * P + k + t] : 0.0f;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          rk[t] = t < ns ? __fmul_rn(q[t], inv[t]) : 0.0f;
#pragma unroll
          for (int r = t + 1; r < S; ++r) q[r] = __fsub_rn(q[r], __fmul_rn(cm[r][t], rk[t]));
        }
#pragma unroll
        for (int t = 0; t < S; ++t) {
          f[t] = rk[t];
#pragma unroll
          for (int u = t + 1; u < S; ++u)
            if (u < ns) f[t] = __fsub_rn(f[t], __fmul_rn(cm[t][u], rk[u]));
        }
      }
      __syncwarp();  // the pivot rows read before any lane writes them
      // then every column of the chunk: each lane's rows through the steps
      // (the pivot rows too, overwritten below)
      const int nc = min(32, (W - jb + nw - 1) / nw);
      for (int c = 0; c < nc; ++c) {
        float* col = s + (jb + c * nw) * P;
        float rkc[S];
#pragma unroll
        for (int t = 0; t < S; ++t) rkc[t] = __shfl_sync(kFull, rk[t], c);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < kR - 1 || last_row) {
            float e = col[lane + 32 * r];
#pragma unroll
            for (int t = 0; t < S; ++t) e = __fsub_rn(e, __fmul_rn(m[t][r], rkc[t]));
            col[lane + 32 * r] = e;
          }
        }
      }
      __syncwarp();  // the lanes' stores before the pivot rows' values
      if (jl < W) {
#pragma unroll
        for (int t = 0; t < S; ++t)
          if (t < ns) s[jl * P + k + t] = f[t];
      }
    }
    __syncthreads();
  }
  float* xg = x + g * M * K;
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    for (int c = 0; c < K; ++c) xg[i * K + c] = s[(M + c) * P + i];
}

// one launch of the block kernel's instance for R rows a lane
template <int kR>
int launch_gj(const float* a, const float* b, float* x, int G, int M, int K, cudaStream_t s) {
  const int W = M + K;
  const int smem = static_cast<int>(sizeof(float) * (M | 1) * W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_gj_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // an odd count, so that a warp's 32 columns jb + l * warps lie in 32 banks
  const int warps = std::min(kSpdBlockWarps, (W + kSpdColsPerWarp - 1) / kSpdColsPerWarp) | 1;
  spd_solve_gj_kernel<kR><<<G, warps * 32, smem, s>>>(a, b, x, M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success): the
// warp kernel for M <= 32, the block kernel above.
extern "C" int gcnn_spd_solve_f32(const float* a, const float* b, float* x,
                                  int G, int M, int K, void* stream) {
  if (G <= 0 || M <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kWarpM) {
    const int grid = (G + kSpdWarps - 1) / kSpdWarps;
    spd_solve_warp_kernel<<<grid, kSpdWarps * 32, 0, s>>>(a, b, x, G, M, K);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((M + 31) / 32) {  // the block kernel's rows a lane
    case 2: return launch_gj<2>(a, b, x, G, M, K, s);
    case 3: return launch_gj<3>(a, b, x, G, M, K, s);
    case 4: return launch_gj<4>(a, b, x, G, M, K, s);
    case 5: return launch_gj<5>(a, b, x, G, M, K, s);
    case 6: return launch_gj<6>(a, b, x, G, M, K, s);
    case 7: return launch_gj<7>(a, b, x, G, M, K, s);
    case 8: return launch_gj<8>(a, b, x, G, M, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);  // M > 256: past any gate
  }
}
