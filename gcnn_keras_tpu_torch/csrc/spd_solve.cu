// Batched SPD solve for Hopper (sm_90a):
//   x[g] = a[g]^-1 b[g]   for a (G, M, M), b (G, M, K), x (G, M, K),
// float32, row-major and contiguous.
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/spd_solve.py
// (_gj_solve_impl / _gj_kernel: Gauss-Jordan with the batch on the 128
// lanes, M padded to 8, one-hot iota row selects). Here each system is one
// thread block that holds [A | B] (M x (M+K) floats) in shared memory and
// runs the same Gauss-Jordan elimination without pivoting: A is SPD and
// diagonally dominant in the Qeq solve (erf-screened Coulomb plus a positive
// hardness diagonal, identity rows for padding atoms).
//
// Step k stashes column k and row k, then every thread updates its entries
// (i, j) of the columns j > k (the columns j <= k are never read again):
//   row k:      s[k][j] = s[k][j] * (1 / s[k][k])
//   row i != k: s[i][j] = s[i][j] - s[i][k] * (s[k][j] * (1 / s[k][k]))
// with round-to-nearest products and differences (no fused multiply-add),
// which is the arithmetic of the plain PyTorch version, so that the two
// agree to the last bit.
//
// Bound: the call must read a (G*M*M*4 bytes) and b (G*M*K*4) and write x
// (G*M*K*4); at the Qeq serving shape (G=513, M=20, K=2) that is 0.98 MB,
// about 0.29 us at 3.35 TB/s, and some 5 MFLOP, far below the card's float32
// rate. The kernel is instead bound by latency: M dependent steps, each with
// two block barriers. One block per system puts G blocks in flight.
//
// Limit: the block's shared memory, 4 * (M*(M+K) + M + (M+K)) bytes, must fit
// the 227 KB a block can use on sm_90 (M <= 239 for K = 2); the Python
// wrapper makes that shape test before it launches.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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

// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int gcnn_spd_solve_f32(const float* a, const float* b, float* x,
                                  int G, int M, int K, void* stream) {
  if (G <= 0 || M <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
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
  spd_solve_gj_kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, x, M, K);
  return static_cast<int>(cudaGetLastError());
}
