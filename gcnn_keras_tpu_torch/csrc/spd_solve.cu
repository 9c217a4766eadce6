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
// M > 32 (spd_solve_gj_kernel): one thread block a system, [A | B] (M x
// (M+K) floats) in shared memory. Step k stashes column k and row k, then
// every thread updates its entries (i, j) of the columns j > k (the columns
// j <= k are never read again), with two block barriers a step.
//
// Bound: the call must read a (G*M*M*4 bytes) and b (G*M*K*4) and write x
// (G*M*K*4); at the Qeq serving shape (G=513, M=20, K=2) that is 0.98 MB,
// about 0.29 us at 3.35 TB/s, and some 5 MFLOP, far below the card's float32
// rate. Both kernels are instead bound by latency: M dependent steps. In the
// warp kernel a step waits on a shuffle, the reciprocal and two rounded
// operations; in the block kernel on two block barriers.
//
// Limit: the block kernel's shared memory, 4 * (M*(M+K) + M + (M+K)) bytes,
// must fit the 227 KB a block can use on sm_90 (M <= 239 for K = 2); the
// Python wrapper makes that shape test before it launches, for both kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSpdWarps = 4;  // systems of a block in the warp kernel
constexpr int kWarpM = 32;    // the warp kernel's largest M
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

__global__ void spd_solve_gj_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    float* __restrict__ x, int M, int K) {
  extern __shared__ float smem[];
  const int W = M + K;
  float* s = smem;          // M x W: [A | B]
  float* col = s + M * W;   // column k of step k
  float* row = col + M;     // row k of step k
  const size_t g = blockIdx.x;
  const float* ag = a + g * M * M;
  const float* bg = b + g * M * K;

  for (int t = threadIdx.x; t < M * W; t += blockDim.x) {
    const int i = t / W, j = t - i * W;
    s[t] = j < M ? ag[i * M + j] : bg[i * K + (j - M)];
  }
  __syncthreads();

  for (int k = 0; k < M; ++k) {
    for (int t = threadIdx.x; t < M + W; t += blockDim.x) {
      if (t < M) col[t] = s[t * W + k];
      else row[t - M] = s[k * W + (t - M)];
    }
    __syncthreads();
    const float inv = 1.0f / row[k];
    const int w = W - k - 1;  // active columns k+1 .. W-1
    for (int t = threadIdx.x; t < M * w; t += blockDim.x) {
      const int i = t / w, j = k + 1 + (t - i * w);
      const float rk = __fmul_rn(row[j], inv);
      s[i * W + j] = i == k ? rk : __fsub_rn(s[i * W + j], __fmul_rn(col[i], rk));
    }
    __syncthreads();
  }

  float* xg = x + g * M * K;
  for (int t = threadIdx.x; t < M * K; t += blockDim.x) {
    const int i = t / K, c = t - i * K;
    xg[t] = s[i * W + M + c];
  }
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
  const int W = M + K;
  const size_t smem = sizeof(float) * (static_cast<size_t>(M) * W + M + W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_solve_gj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((M * W + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  spd_solve_gj_kernel<<<G, threads, smem, s>>>(a, b, x, M, K);
  return static_cast<int>(cudaGetLastError());
}
