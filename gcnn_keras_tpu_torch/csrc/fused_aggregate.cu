// Fused gather-multiply-segment-sum for Hopper (sm_90a):
//   out[r, f] = sum_{e : recv[e] == r} x[send[e], f] * filt[e, f]
// for ascending int32 receivers, int32 senders, float32 x (N_x, F) and
// filt (E, F) row-major, out (N, F). Rows without edges get 0; padding edges
// (sender == receiver == the dead last node) sum onto that node, as on the
// unfused path.
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/fused_aggregate.py
// (_fused_gather_mul_segsum), which the gms primitive of ops/pallas/bilinear.py
// binds. The TPU has no gather, so that kernel DMAs a window of max_nodes
// rows of x around each 128-row block and gathers with a one-hot matmul. A
// Hopper thread gathers its x row directly (through L2), so there is no
// window and no max_nodes bound here. The layout is that of
// csrc/segment_sum.cu: each output row owns the contiguous edge range
// [lower_bound(r), lower_bound(r + 1)), found by a binary search, and is
// summed in a float32 register in edge order (float32 FMA): deterministic,
// no atomics. The (E, F) gathered rows and products never reach memory.
//
// Bound: the call must read filt (E*F*4 bytes), x (N_x*F*4), senders and
// receivers (E*8) once and write out (N*F*4) once; its E*F FMAs are far below
// the card's float32 rate, so it is bound by memory bytes. At the SchNet
// serving shapes (N 8192, E 54784, F 128): 28.0 + 4.2 + 0.4 + 4.2 MB, about
// 11.0 us at 3.35 TB/s.
//
// Block: ROWS output rows x TF feature columns (TF * ROWS = 256 threads);
// threadIdx.x walks neighbouring features, so a warp's loads of one filter
// row and of one gathered x row coalesce.

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

__global__ void gms_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ filt,
                               const int* __restrict__ send,
                               const int* __restrict__ recv,
                               float* __restrict__ out, int E, int F,
                               int num_segments) {
  extern __shared__ int bounds[];  // [2 * blockDim.y]: begin, end per row
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (threadIdx.x == 0) {
    int begin = 0, end = 0;
    if (row < num_segments) {
      begin = lower_bound(recv, E, row);
      end = lower_bound(recv, E, row + 1);
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
  const float* p = filt + static_cast<long long>(begin) * F + f;
  for (int e = begin; e < end; ++e, p += F) {
    const long long s = __ldg(send + e);
    acc = fmaf(__ldg(x + s * F + f), __ldg(p), acc);
  }
  out[static_cast<long long>(row) * F + f] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gcnn_gather_mul_segsum_f32(const float* x, const float* filt,
                                          const int* send, const int* recv,
                                          float* out, int E, int F,
                                          int num_segments, void* stream) {
  if (num_segments <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  // feature tile: the smallest of 32, 64, 128 that covers F (128 for wider)
  int tf = 32;
  while (tf < F && tf < 128) tf *= 2;
  const int rows = kThreads / tf;
  dim3 block(tf, rows);
  dim3 grid((num_segments + rows - 1) / rows, (F + tf - 1) / tf);
  gms_fwd_kernel<<<grid, block, 2 * rows * sizeof(int),
                   static_cast<cudaStream_t>(stream)>>>(
      x, filt, send, recv, out, E, F, num_segments);
  return static_cast<int>(cudaGetLastError());
}
