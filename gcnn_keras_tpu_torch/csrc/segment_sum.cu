// Sorted segment-sum for Hopper (sm_90a):
//   out[r, f] = sum_{e : ids[e] == r} values[e, f]
// for ascending int32 ids, float32 values (E, F) row-major, out (N, F).
//
// Replaces the TPU kernel gcnn_keras_tpu/ops/pallas/segment_sum.py
// (_sorted_segment_sum_pallas / _v2 / _v3: one-hot matmuls on the MXU over
// receiver-sorted edge chunks). Here the sortedness is used directly: each
// output row owns the contiguous edge range of its id and is summed in float32
// registers in edge order: deterministic, no atomics, no one-hot work.
//
// What bounds it. The call must read values (E*F*4 bytes) and ids (E*4) once
// and write out (N*F*4) once; its E*F adds are far below the card's float32
// rate. At F = 128 (E 54784, N 8192) that is 28.0 + 0.2 + 4.2 MB, about 9.7 us
// at 3.35 TB/s: bytes. At F = 3 the 0.98 MB take 0.3 us, and the call is bound
// by latency: the launch, then each round of dependent loads (ids, then the
// values they locate) costs a trip to memory.
//
// The design keeps that chain two rounds long, and the rest in shared memory:
// - Rows owned by edge ranges, without a search. Block b reads the ids of its
//   edge range [eb0, eb1) (and one before, and kAhead after) into shared
//   memory in one round of independent loads. It owns the rows whose first
//   edge lies in its range: rows ids[eb0-1]+1 .. ids[eb1-1], and for the last
//   block every row to N - 1, empty rows included. Edge e starts rows
//   ids[e-1]+1 .. ids[e]; one scan of the range writes each owned row's first
//   edge to shared memory. The last owned row may run past eb1: its end is
//   the first id above it among the kAhead ids read ahead (or, for a longer
//   row, found by a warp 32 ids at a time).
// - Values staged. The block copies the values of its range and of up to two
//   mean rows after it (its columns of them) into shared memory with
//   coalesced loads, 32 floats or 8 float4s in flight a thread, before the
//   first barrier; rows sum from there in edge order. A row longer than the
//   staged window reads the rest from device memory, kInFlight edges a round
//   (those past its end read as 0).
// - A layout chosen by F in the launcher:
//   - F <= 8: one thread per row, summing all F columns of each edge (no idle
//     lanes at F = 1..8);
//   - F a multiple of 4 (16-byte aligned values): float4 columns, up to 32
//     lanes (128 columns) per row, a second grid dimension beyond;
//   - any other F: one scalar column per lane, 32 lanes per row.
// - Block sizes. Threads per block is the largest of 256, 128, 64, 32 that
//   leaves a block for at least a quarter of the SMs; a block's edge range
//   holds about 3/4 of its row slots' worth of mean rows, so that its rows
//   mostly fit one pass.
// What was measured on an NVIDIA H100 80GB HBM3 at 700 W, L2-cold:
// - a fixed run of rows per block with two 32-ary searches over all ids
//   (8 dependent loads before the first value in one-warp blocks) was no
//   faster at F = 3 than a search per row: 0.0163 ms against 0.0160
//   (profile_serving_torch.py --kernel);
// - rows owned by edge ranges, values read from device memory per row:
//   0.0183 ms at F = 3, most of it in the row sums (the same);
// - with the values staged, blocks that give every SM two took 0.0137 ms at
//   F = 3 and 0.0108 at the readout; blocks for a quarter of the SMs 0.0094
//   and 0.0087, index_add_ 0.0084 and 0.0101 in the same call; a launch
//   with no edges takes 0.0061 ms, 0.0012 more than the search-per-row
//   kernel's (probe_kernel_variants.py).
//
// Registers (ptxas, sm_90a): 32-64 a thread, no spills; 9.4 KB of static
// shared memory a block and the staged values (at most kStaged floats).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;  // threads, and row slots, of the largest block
constexpr int kMaxEdges = 2048;   // edges of a block's range, at most
constexpr int kAhead = 32;        // ids read past the range, for its last row's end
constexpr int kStaged = 8192;     // values a block stages in shared memory, at most
constexpr int kInFlight = 8;      // edges whose loads a thread issues together
constexpr int kStage = 8;         // ids a thread loads together into shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPastEnd = 0x7fffffff;  // the id read past the last edge

struct Shared {
  int ids[kMaxEdges + 1 + kAhead];  // ids[eb0 - 1 + k]; -1 before edge 0
  int start[kMaxThreads + 1];       // the first edge of each row of a chunk, and its end
};

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

// Calls row_sum(base, cend, start) for each chunk of at most `slots` rows
// [base, cend) that the block owns: row base + k has the edge range
// [start[k], start[k + 1]). The block's edge range is [blockIdx.x * EB, + EB).
// Before the first barrier it calls stage(eb0). Contains barriers: called by
// the whole block.
template <typename Stage, typename RowSum>
__device__ __forceinline__ void owned_rows(const int* __restrict__ ids, int E, int N, int EB,
                                           int slots, Shared& sh, Stage stage,
                                           RowSum row_sum) {
  const int eb0 = blockIdx.x * EB, eb1 = min(eb0 + EB, E), n = eb1 - eb0;
  const bool last = eb1 == E;
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
  // Row rhi runs past eb1: its end is the first edge after eb1 with a larger
  // id, found by warp 0 (thread 0 keeps it)
  const bool runs_on = !last && sh.ids[n] == rhi && sh.ids[n + 1] == rhi;
  int end_of_last = E;
  if (runs_on && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned hit = __ballot_sync(kFull, sh.ids[n + 1 + lane] > rhi);
    int e = eb1;
    while (hit == 0) {
      e = e == eb1 ? eb1 + kAhead : e + 32;
      hit = __ballot_sync(kFull, e + lane >= E || __ldg(ids + e + lane) > rhi);
    }
    end_of_last = e + __ffs(hit) - 1;
  }
  for (int base = rlo; base <= rhi; base += slots) {
    const int cend = min(base + slots, rhi + 1);  // this chunk's rows: [base, cend)
    // edge eb0 + j (j = n: the edge after the range) starts rows prev+1 .. cur
    for (int j = threadIdx.x; j <= n; j += blockDim.x) {
      const int lo = max(sh.ids[j] + 1, base), hi = min(sh.ids[j + 1], cend);
      for (int r = lo; r <= hi; ++r) sh.start[r - base] = eb0 + j;
    }
    if (runs_on && cend == rhi + 1 && threadIdx.x == 0) sh.start[cend - base] = end_of_last;
    __syncthreads();
    row_sum(eb0, base, cend, sh.start);
    __syncthreads();  // the next chunk rewrites start
  }
}

// F <= 8: one thread per row, all F columns; the block's W staged edges in
// shared memory, later edges of a long row from device memory.
template <int F>
__global__ void sorted_segment_sum_rows_kernel(const float* __restrict__ values,
                                               const int* __restrict__ ids,
                                               float* __restrict__ out, int E, int N, int EB,
                                               int W) {
  __shared__ Shared sh;
  extern __shared__ float4 smem4[];
  float* s_vals = reinterpret_cast<float*>(smem4);  // [W][F]
  owned_rows(
      ids, E, N, EB, blockDim.x, sh,
      [&](int eb0) { stage_values<1>(values, E, F, eb0, W, 0, F, s_vals); },
      [&](int eb0, int base, int cend, const int* start) {
        const int slot = threadIdx.x, row = base + slot;
        if (row >= cend) return;
        const int end = start[slot + 1], staged = min(end, eb0 + W);
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
        int e = start[slot];
        for (; e < staged; ++e)
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] += s_vals[(e - eb0) * F + f];
        for (; e < end; e += kInFlight) {
          const float* p = values + static_cast<long long>(e) * F;
          float v[kInFlight * F];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q)
#pragma unroll
            for (int f = 0; f < F; ++f) v[q * F + f] = e + q < end ? __ldg(p + q * F + f) : 0.0f;
#pragma unroll
          for (int q = 0; q < kInFlight; ++q)
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += v[q * F + f];
        }
        float* o = out + static_cast<long long>(row) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) o[f] = acc[f];
      });
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// F > 8: `lanes` threads per row (a power of two up to 32, so a row lies in
// one warp), each owning V neighbouring columns (V = 4: one float4), columns
// col0 = blockIdx.y * lanes * V onwards; blockDim.x / lanes row slots; the
// block's W staged edges (its C columns) in shared memory.
template <int V>
__global__ void sorted_segment_sum_cols_kernel(const float* __restrict__ values,
                                               const int* __restrict__ ids,
                                               float* __restrict__ out, int E, int F, int N,
                                               int EB, int W, int lanes) {
  __shared__ Shared sh;
  extern __shared__ float4 smem4[];
  float* s_vals = reinterpret_cast<float*>(smem4);  // [W][C]
  const int col0 = blockIdx.y * lanes * V, C = min(F - col0, lanes * V);
  owned_rows(
      ids, E, N, EB, blockDim.x / lanes, sh,
      [&](int eb0) { stage_values<V>(values, E, F, eb0, W, col0, C, s_vals); },
      [&](int eb0, int base, int cend, const int* start) {
        const int slot = threadIdx.x / lanes, row = base + slot;
        const int c = (threadIdx.x % lanes) * V;
        if (row >= cend || c >= C) return;
        const int end = start[slot + 1], staged = min(end, eb0 + W);
        int e = start[slot];
        if constexpr (V == 4) {
          const int ld = F / 4;  // float4s per edge row
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (; e < staged; ++e)
            add4(acc, *reinterpret_cast<const float4*>(s_vals + (e - eb0) * C + c));
          for (; e < end; e += kInFlight) {
            const float4* p = reinterpret_cast<const float4*>(
                values + static_cast<long long>(e) * F + col0 + c);
            float4 v[kInFlight];
#pragma unroll
            for (int q = 0; q < kInFlight; ++q)
              v[q] = e + q < end ? __ldg(p + q * ld) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int q = 0; q < kInFlight; ++q) add4(acc, v[q]);
          }
          *reinterpret_cast<float4*>(out + static_cast<long long>(row) * F + col0 + c) = acc;
        } else {
          float acc = 0.0f;
          for (; e < staged; ++e) acc += s_vals[(e - eb0) * C + c];
          for (; e < end; e += kInFlight) {
            const float* p = values + static_cast<long long>(e) * F + col0 + c;
            float v[kInFlight];
#pragma unroll
            for (int q = 0; q < kInFlight; ++q) v[q] = e + q < end ? __ldg(p + q * F) : 0.0f;
#pragma unroll
            for (int q = 0; q < kInFlight; ++q) acc += v[q];
          }
          out[static_cast<long long>(row) * F + col0 + c] = acc;
        }
      });
}

int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// threads per block: the most of 256, 128, 64, 32 that still gives every SM
// two blocks of N rows at `lanes` threads a row
int threads_for(int N, int lanes, int sms) {
  int t = kMaxThreads;
  while (t > 32 && (N + t / lanes - 1) / (t / lanes) < sms / 4) t >>= 1;
  return t;
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

// Opts the kernel in to `bytes` of dynamic shared memory where they exceed
// what a block may take without (48 KB with the static Shared).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes + static_cast<int>(sizeof(Shared)) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int F>
cudaError_t launch_rows(const float* values, const int* ids, float* out, int E, int N, int t,
                        cudaStream_t stream) {
  const Ranges r = ranges_for(E, N, t, F);
  const int smem = r.W * F * 4;
  const cudaError_t err = allow_smem(sorted_segment_sum_rows_kernel<F>, smem);
  if (err != cudaSuccess) return err;
  sorted_segment_sum_rows_kernel<F><<<blocks_for(E, r.EB), t, smem, stream>>>(
      values, ids, out, E, N, r.EB, r.W);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gcnn_sorted_segment_sum_f32(const float* values, const int* ids,
                                           float* out, int E, int F,
                                           int num_segments, void* stream) {
  if (num_segments <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = num_segments, sms = sm_count();
  if (F <= 8) {
    const int t = threads_for(n, 1, sms);
    cudaError_t err;
    switch (F) {
      case 1: err = launch_rows<1>(values, ids, out, E, n, t, s); break;
      case 2: err = launch_rows<2>(values, ids, out, E, n, t, s); break;
      case 3: err = launch_rows<3>(values, ids, out, E, n, t, s); break;
      case 4: err = launch_rows<4>(values, ids, out, E, n, t, s); break;
      case 5: err = launch_rows<5>(values, ids, out, E, n, t, s); break;
      case 6: err = launch_rows<6>(values, ids, out, E, n, t, s); break;
      case 7: err = launch_rows<7>(values, ids, out, E, n, t, s); break;
      default: err = launch_rows<8>(values, ids, out, E, n, t, s); break;
    }
    return static_cast<int>(err);
  }
  const int v = F % 4 == 0 && reinterpret_cast<std::uintptr_t>(values) % 16 == 0 ? 4 : 1;
  int lanes = 1;
  while (lanes < 32 && lanes * v < F) lanes <<= 1;
  const int t = threads_for(n, lanes, sms);
  const int c = F < lanes * v ? F : lanes * v;  // staged columns of a block
  const Ranges r = ranges_for(E, n, t / lanes, c);
  const int smem = r.W * c * 4;
  const dim3 grid(blocks_for(E, r.EB), (F + lanes * v - 1) / (lanes * v));
  auto kernel = v == 4 ? sorted_segment_sum_cols_kernel<4> : sorted_segment_sum_cols_kernel<1>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, t, smem, s>>>(values, ids, out, E, F, n, r.EB, r.W, lanes);
  return static_cast<int>(cudaGetLastError());
}
