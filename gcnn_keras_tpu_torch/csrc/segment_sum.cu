// Sorted segment-sum for Hopper (sm_90a):
//   out[r, f] = sum_{e : ids[e] == r} values[e, f]
// for ascending int32 ids, float32 values (E, F) row-major, out (N, F).
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/segment_sum.py
// (_sorted_segment_sum_pallas / _v2 / _v3: one-hot matmuls on the MXU over
// receiver-sorted edge chunks). Here the sortedness is used directly: each
// output row owns the contiguous edge range [lower_bound(r), lower_bound(r+1)),
// found by a binary search over ids, and is summed in a float32 register in
// edge order: deterministic, no atomics, no one-hot work.
//
// Bound: the call must read values (E*F*4 bytes) and ids (E*4) once and write
// out (N*F*4) once; it does E*F adds, far below the card's float32 rate, so it
// is bound by memory bytes. At E=54784, F=128, N=8192: 28.0 + 0.2 + 4.2 MB,
// about 9.7 us at 3.35 TB/s. Calls with F=3 are bound by launch latency.
//
// Layout: a block is a tile of ROWS output rows x TF feature columns
// (TF*ROWS = 256 threads). threadIdx.x walks neighbouring features, so the
// loads of one edge row by a warp coalesce. One thread per row finds the
// edge range and shares it through shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ ids, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void sorted_segment_sum_kernel(const float* __restrict__ values,
                                          const int* __restrict__ ids,
                                          float* __restrict__ out, int E, int F,
                                          int num_segments) {
  extern __shared__ int bounds[];  // [2 * blockDim.y]: begin, end per row
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (threadIdx.x == 0) {
    int begin = 0, end = 0;
    if (row < num_segments) {
      begin = lower_bound(ids, E, row);
      end = lower_bound(ids, E, row + 1);
    }
    bounds[2 * threadIdx.y] = begin;
    bounds[2 * threadIdx.y + 1] = end;
  }
  __syncthreads();
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= num_segments || f >= F) return;
  const int begin = bounds[2 * threadIdx.y];
  const int end = bounds[2 * threadIdx.y + 1];
  float acc = 0.0f;
  const float* p = values + static_cast<long long>(begin) * F + f;
  for (int e = begin; e < end; ++e, p += F) acc += __ldg(p);
  out[static_cast<long long>(row) * F + f] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gcnn_sorted_segment_sum_f32(const float* values, const int* ids,
                                           float* out, int E, int F,
                                           int num_segments, void* stream) {
  if (num_segments <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  // feature tile: the smallest of 32, 64, 128 that covers F (128 for wider)
  int tf = 32;
  while (tf < F && tf < 128) tf *= 2;
  const int rows = kThreads / tf;
  dim3 block(tf, rows);
  dim3 grid((num_segments + rows - 1) / rows, (F + tf - 1) / tf);
  sorted_segment_sum_kernel<<<grid, block, 2 * rows * sizeof(int),
                              static_cast<cudaStream_t>(stream)>>>(
      values, ids, out, E, F, num_segments);
  return static_cast<int>(cudaGetLastError());
}
