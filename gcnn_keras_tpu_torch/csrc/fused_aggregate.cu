// Fused gather-multiply-segment-sum for Hopper (sm_90a):
//   out[r, f] = sum_{e : recv[e] == r} x[send[e], f] * filt[e, f]
// for ascending int32 receivers, int32 senders, float32 x (N_x, F) and
// filt (E, F) row-major, out (N, F). Rows without edges get 0; padding edges
// (sender == receiver == the dead last node) sum onto that node, as on the
// unfused path. Sums are float32 FMA, deterministic, with no atomics. Each
// row is summed in edge order, except the one row of a block that runs past
// its staged window (below): that row's staged edges are summed in edge
// order, its tail in rounds shared by the block's thread groups, and the
// groups' partial sums are added in group order. The (E, F) gathered rows
// and products never reach memory.
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/fused_aggregate.py
// (_fused_gather_mul_segsum), which the gms primitive of ops/pallas/bilinear.py
// binds. The TPU has no gather, so that kernel DMAs a window of max_nodes
// rows of x around each 128-row block and gathers with a one-hot matmul. A
// Hopper thread gathers its x row directly (through L2), so there is no
// window and no max_nodes bound here.
//
// Bound: the call must read filt (E*F*4 bytes), x (N_x*F*4), senders and
// receivers (E*8) once and write out (N*F*4) once; its E*F FMAs are far below
// the card's float32 rate, so it is bound by memory bytes. At the SchNet
// serving shapes (N 8192, E 54784, F 128): 28.0 + 4.2 + 0.4 + 4.2 MB, about
// 11.0 us at 3.35 TB/s. At the MD step's (N 128, E 128) it is a launch and a
// few dependent trips to memory.
//
// The layout is the sorted segment-sum's (csrc/segment_sum.cu), with the
// senders and the x gather added; this file keeps its own copy of the
// helpers, so that the build's hash of the source covers them:
// - Rows owned by edge ranges, without a search. Block b reads the receiver
//   ids of its edge range [eb0, eb1) (and one before, and kAhead after) and
//   the senders of its staged window into shared memory in one round of
//   independent loads. It owns the rows whose first edge lies in its range,
//   and the rows without edges before them (for the last block every row to
//   N - 1). A scan of the range lists the owned rows' first edges; every warp
//   zeroes its share of the rows without edges; each row with edges is summed
//   by one slot of threads. The last owned row may run past eb1: its end is
//   the first id above it among the kAhead ids read ahead (or, for a longer
//   row, found by a warp 32 ids at a time).
// - filt staged. The block copies the filt rows of its range and of up to
//   two mean rows after it (its columns of them) into shared memory with
//   coalesced loads, 32 floats or 8 float4s in flight a thread, before the
//   first barrier.
// - The row sum reads the senders from shared memory and issues kInFlight
//   independent gathers of x[send] before their FMAs, so no dependent chain
//   reaches device memory (x, 4.2 MB at the serving shape, stays in L2).
//   Only the last owned row can run past the staged window (the dead node's
//   padding edges: 88 at the serving shape, 52 of the MD step's 128; a
//   receiver with more neighbours than the window, about 54 edges at the
//   serving shape). The block's thread groups share its tail, kInFlight
//   edges a round (senders and filt, then the gathers), and its threads add
//   the groups' sums to the staged part in group order: deterministic, though
//   not edge order for that row.
// - One layout, its width chosen by F in the launcher: `lanes` threads a row
//   (the least power of two up to 32 that covers F), each with
//   - float4 columns where F is a multiple of 4 (16-byte aligned x and filt):
//     up to 32 lanes (128 columns) per row, a second grid dimension beyond;
//   - one scalar column otherwise.
//   F <= 8, which no path of the port gives, takes 1 to 8 lanes a row: #1's
//   thread-per-row layout is left out until such a path exists.
// - Blocks of 256 threads; a block's edge range holds about 3/4 of its row
//   slots' worth of mean rows, so that its rows mostly fit one pass.
// What was measured on an NVIDIA H100 80GB HBM3 at 700 W, L2-cold
// (probe_kernel_variants.py, each design in turns with the kernel it
// replaced, a search per row and a dependent chain send[e] -> x[s]; serving
// shape, then the MD step's):
// - owned rows in chunks of row slots, the segment-sum's block sizes (64
//   threads at the MD shape): 0.047 and 0.037 ms against 0.054 and 0.016;
// - rows without edges zeroed by every warp, outside the chunks: 0.038 and
//   0.019; blocks of 256 threads at the MD shape too: 0.038 and 0.0157
//   against 0.053 and 0.0155;
// - the last row's tail shared by the block (this kernel): 0.0340 and 0.0112
//   against 0.0533 and 0.0156 (L2-warm 0.0266 and 0.0104 against 0.0436 and
//   0.0101).
// Registers (ptxas, sm_90a): gms_cols_kernel 56 (float4) and 64, no spills;
// 8384 bytes of static shared memory a block and the staged window.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;     // threads of a block
constexpr int kMaxEdges = 1024;   // edges of a block's range, at most
constexpr int kAhead = 32;        // ids read past the range, for its last row's end
constexpr int kStaged = 8192;     // filt values a block stages in shared memory, at most
constexpr int kInFlight = 8;      // edges whose loads a thread issues together
constexpr int kStage = 8;         // ids a thread loads together into shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPastEnd = 0x7fffffff;  // the id read past the last edge

struct alignas(16) Shared {
  int ids[kMaxEdges + 1 + kAhead];  // ids[eb0 - 1 + k]; -1 before edge 0; then the
                                    // partial sums of a row's tail (gms_cols_kernel)
  int first[kMaxEdges + 1];         // each owned row's first edge (offset from eb0), then its end
  int warp_count[kThreads / 32];    // a scan's count of rows a warp
};
static_assert(kMaxEdges + 1 + kAhead >= 4 * kThreads, "ids hold a tail's partial sums");

// s_vals[w * C + c] = values[(eb0 + w) * F + col0 + c] for w < W (0 past edge
// E), c < C; V = 4 copies float4s (C a multiple of 4, rows 16-byte aligned).
// 32 / V loads in flight per thread before their stores.
template <int V>
__device__ __forceinline__ void stage_values(const float* __restrict__ values, int E, int F,
                                             int eb0, int W, int col0, int C, float* s_vals) {
  using T = typename std::conditional<V == 4, float4, float>::type;
  constexpr int kDepth = 32 / V;
  const int cv = C / V, n = W * cv;
  for (int i0 = threadIdx.x; i0 < n; i0 += kDepth * blockDim.x) {
    T v[kDepth];
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const int i = i0 + q * blockDim.x, w = i / cv, c = i - w * cv;
      if (i < n && eb0 + w < E)
        v[q] = __ldg(reinterpret_cast<const T*>(values + static_cast<long long>(eb0 + w) * F
                                                + col0) + c);
      else
        v[q] = T{};
    }
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      const int i = i0 + q * blockDim.x;
      if (i < n) reinterpret_cast<T*>(s_vals)[i] = v[q];
    }
  }
}

// s_send[w] = send[eb0 + w] for w < W (0 past edge E), kStage loads in
// flight per thread
__device__ __forceinline__ void stage_senders(const int* __restrict__ send, int E, int eb0,
                                              int W, int* s_send) {
  for (int w0 = threadIdx.x; w0 < W; w0 += kStage * blockDim.x) {
    int v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int w = w0 + q * blockDim.x;
      v[q] = w < W && eb0 + w < E ? __ldg(send + eb0 + w) : 0;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int w = w0 + q * blockDim.x;
      if (w < W) s_send[w] = v[q];
    }
  }
}

// The rows that block blockIdx.x owns, for its edge range [eb0, eb1) =
// [blockIdx.x * EB, + EB): before the first barrier it calls stage(eb0);
// then, for each owned row without edges, zero(row, lane) by one warp; then,
// for the m-th owned row with edges, row_sum(eb0,
// row, start, end) by the threads of slot m % slots (the caller's `slot`),
// its edges [start, end). Contains barriers: called by the whole block.
template <typename Stage, typename Zero, typename RowSum>
__device__ __forceinline__ void owned_rows(const int* __restrict__ ids, int E, int N, int EB,
                                           int slot, int slots, Shared& sh, Stage stage,
                                           Zero zero, RowSum row_sum) {
  const int eb0 = blockIdx.x * EB, eb1 = min(eb0 + EB, E), n = eb1 - eb0;
  const bool last = eb1 == E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  stage(eb0);
  for (int k0 = threadIdx.x; k0 < n + 1 + kAhead; k0 += kStage * blockDim.x) {
    int v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int e = eb0 - 1 + k0 + q * blockDim.x;
      v[q] = e < 0 ? -1 : e < E ? __ldg(ids + e) : kPastEnd;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int k = k0 + q * blockDim.x;
      if (k < n + 1 + kAhead) sh.ids[k] = v[q];
    }
  }
  __syncthreads();
  const int rlo = max(sh.ids[0] + 1, 0);
  const int rhi = last ? N - 1 : min(sh.ids[n], N - 1);
  if (rlo > rhi) return;  // the range lies inside one row, owned by an earlier block
  // first[m]: edge eb0 + k starts the m-th owned row with edges where
  // ids[k + 1] != ids[k] (a scan of the range, blockDim.x edges a round)
  int count = 0;
  for (int k0 = 0; k0 < n; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const bool starts = k < n && sh.ids[k + 1] != sh.ids[k];
    const unsigned b = __ballot_sync(kFull, starts);
    if (lane == 0) sh.warp_count[warp] = __popc(b);
    __syncthreads();
    int pos = count + __popc(b & ((1u << lane) - 1));
    for (int w = 0; w < nw; ++w) {
      const int c = sh.warp_count[w];
      if (w < warp) pos += c;
      count += c;
    }
    if (starts) sh.first[pos] = k;
    __syncthreads();  // the next round rewrites warp_count
  }
  // The last owned row ends at eb1, or runs past it: then its end is the
  // first edge after eb1 with a larger id, found by warp 0
  if (warp == 0) {
    int end = eb1;
    if (!last && sh.ids[n] == rhi && sh.ids[n + 1] == rhi) {
      unsigned hit = __ballot_sync(kFull, sh.ids[n + 1 + lane] > rhi);
      int e = eb1;
      while (hit == 0) {
        e = e == eb1 ? eb1 + kAhead : e + 32;
        hit = __ballot_sync(kFull, e + lane >= E || __ldg(ids + e + lane) > rhi);
      }
      end = e + __ffs(hit) - 1;
    }
    if (lane == 0) sh.first[count] = end - eb0;
  }
  // Owned rows without edges, ids[k] < row < ids[k + 1] for k <= n (k = n:
  // after the last edge, in the last block): every warp finds each run, and
  // warp w zeroes its rows w, w + nw, ...
  for (int k0 = 0; k0 <= n; k0 += 32) {
    const int k = k0 + lane;
    const int lo = k <= n ? max(sh.ids[k] + 1, rlo) : 0;
    const int hi = k <= n ? min(sh.ids[k + 1], rhi + 1) : 0;
    unsigned runs = __ballot_sync(kFull, lo < hi);
    while (runs) {
      const int b = __ffs(runs) - 1;
      runs &= runs - 1;
      const int end = __shfl_sync(kFull, hi, b);
      for (int r = __shfl_sync(kFull, lo, b) + warp; r < end; r += nw) zero(r, lane);
    }
  }
  __syncthreads();  // first[count] is written
  for (int m = slot; m < count; m += slots)
    row_sum(eb0, sh.ids[sh.first[m] + 1], eb0 + sh.first[m], eb0 + sh.first[m + 1]);
}

// a += v * w, each component
__device__ __forceinline__ void fma4(float4& a, const float4& v, const float4& w) {
  a.x = fmaf(v.x, w.x, a.x);
  a.y = fmaf(v.y, w.y, a.y);
  a.z = fmaf(v.z, w.z, a.z);
  a.w = fmaf(v.w, w.w, a.w);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// `lanes` threads per row (a power of two up to 32, so a row lies in one
// warp), each owning V neighbouring columns (V = 4: one float4), columns
// col0 = blockIdx.y * lanes * V onwards; blockDim.x / lanes row slots; the
// block's W staged edges (their C columns of filt, and their senders) in
// shared memory.
template <int V>
__global__ void gms_cols_kernel(const float* __restrict__ x, const float* __restrict__ filt,
                                const int* __restrict__ send, const int* __restrict__ recv,
                                float* __restrict__ out, int E, int F, int N, int EB, int W,
                                int lanes) {
  using T = typename std::conditional<V == 4, float4, float>::type;
  __shared__ Shared sh;
  extern __shared__ float4 smem4[];
  float* s_vals = reinterpret_cast<float*>(smem4);  // [W][C]
  const int col0 = blockIdx.y * lanes * V, C = min(F - col0, lanes * V);
  int* s_send = reinterpret_cast<int*>(s_vals + W * C);  // [W]
  const int c = (threadIdx.x % lanes) * V;  // this thread's columns col0 + c ..
  const T zero{};
  __shared__ int s_tail[3];  // the row that runs past the window, its tail's edges
  T head{};                  // that row's threads: the sum of its staged edges
  bool mine = false;         // whether this thread's row is that row
  owned_rows(
      recv, E, N, EB, threadIdx.x / lanes, blockDim.x / lanes, sh,
      [&](int eb0) {
        stage_values<V>(filt, E, F, eb0, W, col0, C, s_vals);
        stage_senders(send, E, eb0, W, s_send);
        if (threadIdx.x == 0) s_tail[0] = -1;
      },
      [&](int row, int lane) {
        for (int j = lane * V; j < C; j += 32 * V)
          *reinterpret_cast<T*>(out + static_cast<long long>(row) * F + col0 + j) = zero;
      },
      [&](int eb0, int row, int start, int end) {
        const int staged = min(end, eb0 + W);
        T acc{};
        for (int e = start; e < staged && c < C; e += kInFlight) {
          T v[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q)
            v[q] = e + q < staged
                       ? __ldg(reinterpret_cast<const T*>(
                             x + static_cast<long long>(s_send[e + q - eb0]) * F + col0 + c))
                       : zero;
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            if (e + q >= staged) continue;
            const T w = *reinterpret_cast<const T*>(s_vals + (e + q - eb0) * C + c);
            if constexpr (V == 4) fma4(acc, v[q], w); else acc = fmaf(v[q], w, acc);
          }
        }
        if (staged < end) {  // the last row, past the window: its tail below
          head = acc;
          mine = true;
          if (c == 0) {
            s_tail[0] = row;
            s_tail[1] = staged;
            s_tail[2] = end;
          }
        } else if (c < C) {
          *reinterpret_cast<T*>(out + static_cast<long long>(row) * F + col0 + c) = acc;
        }
      });
  __syncthreads();  // the row sums are done (sh is free) and s_tail is written
  const int row = s_tail[0];
  if (row < 0) return;
  // The tail of the row that runs past the window: group g of `lanes`
  // threads sums the kInFlight-edge rounds g, g + groups, ... (senders and
  // filt, then the gathers), then the row's threads add the groups' sums to
  // head in group order.
  const int ts = s_tail[1], te = s_tail[2], g = threadIdx.x / lanes, groups = blockDim.x / lanes;
  T acc{};
  for (int e = ts + g * kInFlight; e < te && c < C; e += groups * kInFlight) {
    int s[kInFlight];
    T w[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const bool in = e + q < te;
      s[q] = in ? __ldg(send + e + q) : 0;
      w[q] = in ? __ldg(reinterpret_cast<const T*>(filt + static_cast<long long>(e + q) * F
                                                   + col0 + c))
                : zero;
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      if (e + q >= te) continue;
      const T v = __ldg(reinterpret_cast<const T*>(x + static_cast<long long>(s[q]) * F + col0
                                                   + c));
      if constexpr (V == 4) fma4(acc, v, w[q]); else acc = fmaf(v, w[q], acc);
    }
  }
  float* part = reinterpret_cast<float*>(sh.ids);  // [groups][C]
  if (c < C) *reinterpret_cast<T*>(part + g * C + c) = acc;
  __syncthreads();
  if (!mine || c >= C) return;
  for (int k = 0; k < groups; ++k) {
    const T p = *reinterpret_cast<const T*>(part + k * C + c);
    if constexpr (V == 4) add4(head, p); else head += p;
  }
  *reinterpret_cast<T*>(out + static_cast<long long>(row) * F + col0 + c) = head;
}

// The block's edge range EB and its staged edges W (EB and up to two rows'
// worth of edges after it, for the row that runs past it) for `slots` rows a
// chunk and C staged columns: EB holds 3/4 of `slots` rows at the mean edges
// per row, so that the rows a block owns mostly fit one chunk; W C values fit
// kStaged.
struct Ranges {
  int EB, W;
};

Ranges ranges_for(int E, int N, int slots, int C) {
  const long long mean = (static_cast<long long>(E) + N - 1) / N;
  const int ahead = static_cast<int>(mean * 2 < kAhead ? mean * 2 : kAhead);
  long long eb = static_cast<long long>(slots) * 3 * E / (4LL * N);
  const long long most = kStaged / C - ahead;
  if (eb > most) eb = most;
  if (eb > kMaxEdges) eb = kMaxEdges;
  if (eb < 1) eb = 1;
  return {static_cast<int>(eb), static_cast<int>(eb) + ahead};
}

int blocks_for(int E, int EB) { return E == 0 ? 1 : (E + EB - 1) / EB; }

// dynamic shared memory of a block: W staged rows of C filt columns, W senders
int smem_for(const Ranges& r, int C) { return r.W * (C + 1) * 4; }

// Opts the kernel in to `bytes` of dynamic shared memory where they exceed
// what a block may take without (48 KB with the static Shared).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes + static_cast<int>(sizeof(Shared)) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gcnn_gather_mul_segsum_f32(const float* x, const float* filt,
                                          const int* send, const int* recv,
                                          float* out, int E, int F,
                                          int num_segments, void* stream) {
  if (num_segments <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = num_segments;
  const int v = F % 4 == 0 && reinterpret_cast<std::uintptr_t>(filt) % 16 == 0
                && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 ? 4 : 1;
  int lanes = 1;
  while (lanes < 32 && lanes * v < F) lanes <<= 1;
  const int c = F < lanes * v ? F : lanes * v;  // staged columns of a block
  const Ranges r = ranges_for(E, n, kThreads / lanes, c);
  const int smem = smem_for(r, c);
  const dim3 grid(blocks_for(E, r.EB), (F + lanes * v - 1) / (lanes * v));
  auto kernel = v == 4 ? gms_cols_kernel<4> : gms_cols_kernel<1>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(x, filt, send, recv, out, E, F, n, r.EB, r.W, lanes);
  return static_cast<int>(cudaGetLastError());
}
