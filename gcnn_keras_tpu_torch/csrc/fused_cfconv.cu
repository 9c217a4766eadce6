// Fused SchNet continuous-filter convolution for Hopper (sm_90a):
//   out[r, u] = sum_{e : recv[e] == r} xj[e, u] * f[e, u],
//   f[e] = ssp(basis[e] @ W1 + b1) @ W2 + b2,   ssp(z) = softplus(z) - log 2,
// for ascending int32 receivers, float32 basis (E, B), xj (E, U), W1 (B, U),
// W2 (U, U), b1 and b2 (U,), all row-major; out (N, U). Rows without edges
// get 0; padding edges sum onto their (dead) receiver, as on the unfused path.
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/fused_cfconv.py
// (_fused_cfconv_impl): the accuracy mode of the MD path, whose filter
// matmuls run in float32 (Precision.HIGHEST). Here every product is a
// float32 FMA on the CUDA cores; nothing goes through TF32 or the tensor
// cores. softplus is computed stably, max(z, 0) + log1p(exp(-|z|)), as
// ops/activ.py does.
//
// Bound: the filter MLP is 2*E*(B*U + U*U) float32 operations, plus 2*E*U
// for the biases and 2*E*U for the message sum: at the SchNet serving shapes
// (E 54784, B 20, U 128) 2.11 GFLOP, about 31 us at 67 TFLOP/s. The bytes
// (basis, xj and receivers read once, out written once, the weights once:
// 36.9 MB) take 11.0 us at 3.35 TB/s, so it is bound by operations. The
// (E, U) filter and messages never reach memory.
//
// Layout (CSR, as csrc/segment_sum.cu): a block owns kRows receiver rows and
// their contiguous edge range, found by a binary search. W1, W2, b1 and b2
// sit in shared memory (W2 is 64 KB at U 128, so the block takes dynamic
// shared memory above 48 KB), staged with kStage loads in flight per thread
// so that the 74 KB arrive in a few L2 round trips. Edges go in chunks of
// kEdges: the chunk's basis rows are staged in shared memory and thread u
// loads column u of the chunk's xj rows into registers (all loads of a
// chunk in flight at once); thread k computes hidden unit k of every edge of
// the chunk into shared memory, then thread u computes column u of the
// chunk's filter rows (each W2 value read once per chunk, the hidden rows
// read as float4 broadcasts) and adds xj[e, u] * f[e, u] to its row's sum
// in edge order. Each output row is written once; no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // receiver rows per block
constexpr int kEdges = 16;  // edges per chunk
constexpr int kStage = 16;  // loads in flight per thread while staging weights
constexpr float kLog2 = 0.6931471805599453f;

__device__ __forceinline__ int lower_bound(const int* __restrict__ ids, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float ssp(float z) {
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z))) - kLog2;
}

// dst[i] = src[i] for i < n by the block's threads, kStage loads in flight
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n,
                                      int tid, int nthreads) {
  for (int base = tid; base < n; base += kStage * nthreads) {
    float v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = base + q * nthreads;
      v[q] = i < n ? __ldg(src + i) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = base + q * nthreads;
      if (i < n) dst[i] = v[q];
    }
  }
}

__host__ __device__ __forceinline__ int hidden_stride(int U) {
  return (U + 3) & ~3;  // rows of the hidden buffer stay 16-byte aligned
}

__global__ void fused_cfconv_kernel(const float* __restrict__ basis,
                                    const float* __restrict__ xj,
                                    const int* __restrict__ recv,
                                    const float* __restrict__ w1,
                                    const float* __restrict__ b1,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ b2,
                                    float* __restrict__ out, int E, int B,
                                    int U, int num_nodes) {
  extern __shared__ float4 smem4[];
  const int uh = hidden_stride(U);
  float* s_h = reinterpret_cast<float*>(smem4);  // [kEdges][uh]
  float* s_w2 = s_h + kEdges * uh;               // [U][U]
  float* s_w1 = s_w2 + U * U;                    // [B][U]
  float* s_b1 = s_w1 + B * U;                    // [U]
  float* s_b2 = s_b1 + U;                        // [U]
  float* s_basis = s_b2 + U;                     // [kEdges][B]
  int* s_recv = reinterpret_cast<int*>(s_basis + kEdges * B);  // [kEdges]
  int* s_range = s_recv + kEdges;                               // [2]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, num_nodes);
  if (tid == 0) {
    s_range[0] = lower_bound(recv, E, r0);
    s_range[1] = lower_bound(recv, E, r1);
  }
  stage(s_w2, w2, U * U, tid, nthreads);
  stage(s_w1, w1, B * U, tid, nthreads);
  stage(s_b1, b1, U, tid, nthreads);
  stage(s_b2, b2, U, tid, nthreads);
  // the padding columns [U, uh) of the hidden rows stay 0
  for (int i = tid; i < kEdges * uh; i += nthreads) s_h[i] = 0.0f;
  __syncthreads();
  const int e0 = s_range[0], e1 = s_range[1];

  const int u = tid;  // this thread's hidden unit and output column
  float acc = 0.0f;
  int cur = r0;       // the row whose sum acc holds
  for (int c = e0; c < e1; c += kEdges) {
    const int n = min(kEdges, e1 - c);
    for (int i = tid; i < n * B; i += nthreads)
      s_basis[i] = __ldg(basis + static_cast<long long>(c) * B + i);
    if (tid < n) s_recv[tid] = __ldg(recv + c + tid);
    float x[kEdges];
#pragma unroll
    for (int j = 0; j < kEdges; ++j)
      x[j] = (u < U && j < n) ? __ldg(xj + static_cast<long long>(c + j) * U + u) : 0.0f;
    __syncthreads();
    if (u < U) {
      for (int j = 0; j < n; ++j) {
        float z = s_b1[u];
        for (int b = 0; b < B; ++b) z = fmaf(s_basis[j * B + b], s_w1[b * U + u], z);
        s_h[j * uh + u] = ssp(z);
      }
    }
    __syncthreads();
    if (u < U) {
      // rows j >= n of s_h hold an earlier chunk's values; their f[j] is
      // never used
      float f[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) f[j] = s_b2[u];
      for (int k = 0; k < U; k += 4) {
        const float w0 = s_w2[k * U + u];
        const float wa = k + 1 < U ? s_w2[(k + 1) * U + u] : 0.0f;
        const float wb = k + 2 < U ? s_w2[(k + 2) * U + u] : 0.0f;
        const float wc = k + 3 < U ? s_w2[(k + 3) * U + u] : 0.0f;
#pragma unroll
        for (int j = 0; j < kEdges; ++j) {
          const float4 h = *reinterpret_cast<const float4*>(s_h + j * uh + k);
          f[j] = fmaf(h.x, w0, f[j]);
          f[j] = fmaf(h.y, wa, f[j]);
          f[j] = fmaf(h.z, wb, f[j]);
          f[j] = fmaf(h.w, wc, f[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        if (j < n) {
          const int r = s_recv[j];
          for (; cur < r; ++cur) {
            out[static_cast<long long>(cur) * U + u] = acc;
            acc = 0.0f;
          }
          acc = fmaf(x[j], f[j], acc);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites s_basis, s_recv and s_h
  }
  if (u < U) {
    for (; cur < r1; ++cur) {
      out[static_cast<long long>(cur) * U + u] = acc;
      acc = 0.0f;
    }
  }
}

}  // namespace

// Dynamic shared memory of one block for (B, U), in bytes.
extern "C" long long gcnn_fused_cfconv_smem_bytes(int B, int U) {
  const long long floats = static_cast<long long>(kEdges) * hidden_stride(U) +
                           static_cast<long long>(U) * U +
                           static_cast<long long>(B) * U + 2LL * U +
                           static_cast<long long>(kEdges) * B;
  return 4 * (floats + kEdges + 2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gcnn_fused_cfconv_f32(const float* basis, const float* xj,
                                     const int* recv, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, float* out, int E, int B,
                                     int U, int num_nodes, void* stream) {
  if (num_nodes <= 0 || U <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = gcnn_fused_cfconv_smem_bytes(B, U);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((U + 31) / 32) * 32;
  const int blocks = (num_nodes + kRows - 1) / kRows;
  fused_cfconv_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      basis, xj, recv, w1, b1, w2, b2, out, E, B, U, num_nodes);
  return static_cast<int>(cudaGetLastError());
}
