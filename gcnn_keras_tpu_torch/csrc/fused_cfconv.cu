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
// Both kernels (CSR, as csrc/segment_sum.cu): a block owns a run of
// receiver rows and their contiguous edge range, found by a binary search,
// with W1 and W2 in shared memory. Each output row is written once, in edge
// order; no atomics.
//
// fused_cfconv_kernel (U <= kTiledUnits): 256 threads, two blocks a SM
// (__launch_bounds__(256, 2)), each over max(16, N / (2 SMs)) rows so that W1
// and W2 are staged about twice per SM per call. Units are padded to up = U
// rounded up to 32 (padded weights are 0). Edges go in chunks of 32: the
// chunk's basis rows are staged; warp w takes edges 4 w .. 4 w + 3 and lane
// l the units 4 l .. 4 l + 3; z = basis W1 + b1 (b1 and b2 in the lane's
// registers) gives h = ssp(z) in a shared row that only the warp reads; F =
// h W2 + b2 runs as 4 x 4 register tiles (edges x units) fed by float4
// shared loads (W2 row-major, rows padded to up: read only by rows, so no
// swizzle), 8 loads per 64 FMA; the xj rows are loaded as float4 by the
// lane that owns the units, and m = xj F goes to a shared row. After a
// barrier, threads u < U add the chunk's m rows in edge order onto the
// rows. Shared memory at U 128, B 20: 111240 bytes (W2 64 KB, W1 10 KB, the
// chunk's h and m rows 32 KB, its basis rows 2.5 KB, receivers). Registers
// (ptxas, sm_90a): 123 a thread, no spills. On an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 11, L2-cold): 0.151 ms at the SchNet serving
// shape (4.8x its bound; plain version 0.273, the wide kernel's layout
// 0.330), 0.0292 ms at the MD step's (N 128, E 128; 0.059 before). Measured
// against it in one call (probe_kernel_variants.py): rows for one block a
// SM 0.186 ms, the product loop unrolled by four 0.151, by one 0.160. A
// block taking a slice of W2's columns where the rows give fewer blocks
// than SMs (the MD shape: 8 blocks) is not tried.
//
// fused_cfconv_wide_kernel (U above kTiledUnits, up to the shared-memory
// gate, U 222 at B 20): thread u owns unit u over 16-edge chunks of blocks
// of kRows rows; W1, W2, b1 and b2 in shared memory, staged with kStage
// loads in flight per thread; thread k computes hidden unit k of every edge
// of the chunk into shared memory, then thread u column u of the chunk's
// filter rows (each W2 value read once per chunk, the hidden rows read as
// float4 broadcasts) and adds xj[e, u] * f[e, u] to its row's sum.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kRows = 16;        // receiver rows per block of the wide kernel
constexpr int kEdges = 16;       // edges per chunk of the wide kernel
constexpr int kThreads = 256;    // threads of a block of the tiled kernel
constexpr int kEdgesTile = 32;   // edges per chunk of the tiled kernel
constexpr int kMinRows = 16;     // fewest receiver rows per block of the tiled kernel
constexpr int kTiledUnits = 128; // U up to which the tiled kernel runs
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

__global__ void fused_cfconv_wide_kernel(const float* __restrict__ basis,
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


// ----------------------------------------------------------- the tiled kernel

__host__ __device__ __forceinline__ int units_padded(int U) { return (U + 31) & ~31; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// a += s * w, each component
__device__ __forceinline__ void fma4(float4& a, float s, float4 w) {
  a.x = fmaf(s, w.x, a.x);
  a.y = fmaf(s, w.y, a.y);
  a.z = fmaf(s, w.z, a.z);
  a.w = fmaf(s, w.w, a.w);
}

// row[u .. u + 3] with 0 at U and beyond; one float4 load where vec (U a
// multiple of 4 and the row 16-byte aligned)
__device__ __forceinline__ float4 load_units(const float* __restrict__ row, int u, int U,
                                             bool vec) {
  if (u >= U) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + u));
  return make_float4(__ldg(row + u), u + 1 < U ? __ldg(row + u + 1) : 0.0f,
                     u + 2 < U ? __ldg(row + u + 2) : 0.0f,
                     u + 3 < U ? __ldg(row + u + 3) : 0.0f);
}

// dst[k * up + u] = src[k * U + u] for k < rows, u < U; 0 for U <= u < up
__device__ __forceinline__ void stage_padded(float* __restrict__ dst,
                                             const float* __restrict__ src, int rows, int U,
                                             int up) {
  const int n = rows * up, tid = threadIdx.x, nthreads = blockDim.x;
  for (int base = tid; base < n; base += kStage * nthreads) {
    float v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = base + q * nthreads, k = i / up, u = i - k * up;
      v[q] = i < n && u < U ? __ldg(src + k * U + u) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = base + q * nthreads;
      if (i < n) dst[i] = v[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    fused_cfconv_kernel(const float* __restrict__ basis, const float* __restrict__ xj,
                        const int* __restrict__ recv, const float* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ w2,
                        const float* __restrict__ b2, float* __restrict__ out, int E, int B,
                        int U, int num_nodes, int rows, int vec) {
  constexpr int KE = kEdgesTile, NW = kThreads / 32, EW = KE / NW;
  extern __shared__ float4 smem4[];
  const int up = units_padded(U);
  float* s_w2 = reinterpret_cast<float*>(smem4);  // [up][up]
  float* s_w1 = s_w2 + up * up;                   // [B][up]
  float* s_h = s_w1 + B * up;                     // [KE][up]
  float* s_m = s_h + KE * up;                     // [KE][up]
  float* s_b = s_m + KE * up;                     // [KE][B]
  int* s_recv = reinterpret_cast<int*>(s_b + KE * B);  // [KE]
  int* s_range = s_recv + KE;                          // [2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, num_nodes);
  if (tid == 0) s_range[0] = lower_bound(recv, E, r0);
  if (tid == 32) s_range[1] = lower_bound(recv, E, r1);
  stage_padded(s_w2, w2, U, U, up);
  // W2's padded rows are read by the product: zero them
  for (int i = U * up + tid; i < up * up; i += kThreads) s_w2[i] = 0.0f;
  stage_padded(s_w1, w1, B, U, up);
  // rows of a chunk that hold no edge are read: keep them finite
  for (int i = tid; i < 2 * KE * up + KE * B; i += kThreads) s_h[i] = 0.0f;
  __syncthreads();
  const int e0 = s_range[0], e1 = s_range[1];

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int u = 4 * lane;               // this lane's units u .. u + 3
  const bool gok = u < up;              // which are not all padding
  const float4 b1v = load_units(b1, u, U, false), b2v = load_units(b2, u, U, false);
  float acc = 0.0f;                     // threads tid < U: unit tid of row cur
  int cur = r0;
  for (int c = e0; c < e1; c += KE) {
    const int n = min(KE, e1 - c);
    for (int i = tid; i < n * B; i += kThreads)
      s_b[i] = __ldg(basis + static_cast<long long>(c) * B + i);
    if (tid < n) s_recv[tid] = __ldg(recv + c + tid);
    __syncthreads();
    if (warp * EW < n) {  // this warp's slots hold edges
      float4 xv[EW];
      if (gok) {
        float4 z[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          const int e = warp * EW + ei;
          xv[ei] = e < n ? load_units(xj + static_cast<long long>(c + e) * U, u, U, vec)
                         : zero4;
          z[ei] = b1v;
        }
        for (int k = 0; k < B; ++k) {
          const float4 w = ld4(s_w1 + k * up + u);
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) fma4(z[ei], s_b[(warp * EW + ei) * B + k], w);
        }
#pragma unroll
        for (int ei = 0; ei < EW; ++ei)
          st4(s_h + (warp * EW + ei) * up + u,
              make_float4(ssp(z[ei].x), ssp(z[ei].y), ssp(z[ei].z), ssp(z[ei].w)));
      }
      __syncwarp();  // the warp reads back only its own h rows
      if (gok) {
        float4 f[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) f[ei] = b2v;
#pragma unroll 2
        for (int t = 0; t < up; t += 4) {
          float4 h4[EW];
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) h4[ei] = ld4(s_h + (warp * EW + ei) * up + t);
          const float4 wa = ld4(s_w2 + t * up + u);
          const float4 wb = ld4(s_w2 + (t + 1) * up + u);
          const float4 wc = ld4(s_w2 + (t + 2) * up + u);
          const float4 wd = ld4(s_w2 + (t + 3) * up + u);
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            fma4(f[ei], h4[ei].x, wa);
            fma4(f[ei], h4[ei].y, wb);
            fma4(f[ei], h4[ei].z, wc);
            fma4(f[ei], h4[ei].w, wd);
          }
        }
#pragma unroll
        for (int ei = 0; ei < EW; ++ei)
          st4(s_m + (warp * EW + ei) * up + u,
              make_float4(xv[ei].x * f[ei].x, xv[ei].y * f[ei].y, xv[ei].z * f[ei].z,
                          xv[ei].w * f[ei].w));
      }
    }
    __syncthreads();
    if (tid < U) {
      for (int e = 0; e < n; ++e) {
        const int r = s_recv[e];
        for (; cur < r; ++cur) {
          out[static_cast<long long>(cur) * U + tid] = acc;
          acc = 0.0f;
        }
        acc += s_m[e * up + tid];
      }
    }
    __syncthreads();  // the next chunk overwrites s_b, s_recv and s_m
  }
  if (tid < U) {
    for (; cur < r1; ++cur) {
      out[static_cast<long long>(cur) * U + tid] = acc;
      acc = 0.0f;
    }
  }
}

}  // namespace

// Dynamic shared memory of one block of the kernel that (B, U) takes, in bytes.
extern "C" long long gcnn_fused_cfconv_smem_bytes(int B, int U) {
  const long long b = B, u = U;
  if (U <= kTiledUnits) {
    // W2 and W1 padded to up units, the chunk's h and m rows, its basis rows;
    // KE receivers and the edge range
    const long long e = kEdgesTile, p = units_padded(U);
    return 4 * (p * p + b * p + 2 * e * p + e * b) + 4 * (e + 2);
  }
  const long long e = kEdges;
  const long long floats = e * hidden_stride(U) + u * u + b * u + 2 * u + e * b;
  return 4 * (floats + e + 2);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gcnn_fused_cfconv_f32(const float* basis, const float* xj,
                                     const int* recv, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, float* out, int E, int B,
                                     int U, int num_nodes, void* stream) {
  if (num_nodes <= 0 || U <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = gcnn_fused_cfconv_smem_bytes(B, U);
  const auto s = static_cast<cudaStream_t>(stream);
  if (U > kTiledUnits) {
    cudaError_t err = cudaFuncSetAttribute(fused_cfconv_wide_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = ((U + 31) / 32) * 32;
    fused_cfconv_wide_kernel<<<(num_nodes + kRows - 1) / kRows, threads, smem, s>>>(
        basis, xj, recv, w1, b1, w2, b2, out, E, B, U, num_nodes);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_cfconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)  // room for two blocks a SM
    err = cudaFuncSetAttribute(fused_cfconv_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int rows = std::max(kMinRows, (num_nodes + 2 * sms - 1) / (2 * sms));
  // float4 loads of xj rows where they are 16-byte aligned
  const int vec = U % 4 == 0 && reinterpret_cast<std::uintptr_t>(xj) % 16 == 0;
  fused_cfconv_kernel<<<(num_nodes + rows - 1) / rows, kThreads, smem, s>>>(
      basis, xj, recv, w1, b1, w2, b2, out, E, B, U, num_nodes, rows, vec);
  return static_cast<int>(cudaGetLastError());
}
