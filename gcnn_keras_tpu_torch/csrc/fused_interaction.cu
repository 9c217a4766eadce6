// The fused SchNet interaction chain for Hopper (sm_90a), closed to second
// order: three kernels over receiver-sorted edges e = (i <- j) whose mask is
// set (edges whose mask is 0 contribute nothing):
//
//   v = pos[j] - pos[i],  r = |v| (1e-6, a constant, where |v|^2 <= 1e-12)
//   b_k = exp(gamma (r - s_k)^2),  s_k = offset + k / B * distance_max,
//   g_k = 2 gamma (r - s_k)  (so db_k/dr = b_k g_k)
//   z = b W1 + b1,  h = ssp(z),  sig = sigmoid(z) = ssp'(z)
//   F = h W2 + b2,  m = F * x[j],  y[i] += m
//
// with x (N, U), pos (N, 3), W1 (B, U), W2 (U, U), b1 and b2 (U,), float32,
// row-major (the flax layout: z_u = sum_k b_k W1[k, u]).
//
// Replaces the TPU kernels of gcnn_keras_tpu/ops/pallas/fused_interaction.py:
//   cf_fwd     (_cf_fwd):    y
//   cf_vjp     (_cf_vjp):    ct (N, U) -> with c = ct[i], a = c * x[j]:
//       ct_x[j] += c * F;  gW2 += h (x) a;  gb2 += a;
//       dz = (W2 a) * sig;  gW1 += b (x) dz;  gb1 += dz;
//       rbar = sum_u dz_u (W1^T (b g))_u;  dv = rbar v / r;
//       ct_pos[j] += dv, ct_pos[i] -= dv
//   cf_hesjvp  (_cf_hesjvp): (ct; u = (ux, upos, uW1, ub1, uW2, ub2)) ->
//       du = upos[j] - upos[i],  dr = v.du / r,
//       dz = (b g dr) W1 + b uW1 + ub1,  dh = sig dz,
//       dF = dh W2 + h uW2 + ub2,  Ju[i] += dF x[j] + F ux[j];
//     and the gradient of <c, Ju> along (x, pos, W1, b1, W2, b2), with
//       a = c x[j], q = c ux[j]:  w_x[j] += c dF;  wW2 += dh (x) a + h (x) q;
//       wb2 += q;  abar = W2 a,  hbar = uW2 a + W2 q;  dzbar = abar sig,
//       zbar = hbar sig + abar sig (1 - sig) dz;  wW1 += (b g dr) (x) dzbar
//       + b (x) zbar;  wb1 += zbar;
//       drbar = sum_u dzbar_u (W1^T (b g))_u,
//       rbar = dr sum_u dzbar_u (W1^T (b (g^2 + 2 gamma)))_u
//            + sum_u dzbar_u (uW1^T (b g))_u + sum_u zbar_u (W1^T (b g))_u,
//       wv = rbar v / r + drbar (du - dr v / r) / r;
//       w_pos[j] += wv, w_pos[i] -= wv.
// The TPU kernels take these derivatives from jax.vjp / jax.jvp / jax.grad
// over one closure; here they are written out, each line as in the float64
// mirror of tests/test_torch_fused_interaction.py.
//
// Bound (chip_smoke.py chain_work): float32 operations. Per real edge, cf_fwd
// does 2 (B U + U U) + 4 U (the filter MLP and the message) besides the basis;
// cf_vjp about 3 times that, cf_hesjvp about 8 times (16 U^2 + 16 B U), or 6
// times (12 U^2 + 12 B U) when the weight tangents are absent (a force
// loss's call: 0.189 ms at the schnet_train batch, 0.251 with them). The
// (E, U) filter, its tangents and cotangents never reach memory.
//
// What every kernel shares: a block owns a run of receiver rows and their
// contiguous edge range (binary search), and edges go in chunks. Sums onto
// receivers (y, Ju, the receiver side of the position cotangents) are taken
// in edge order over the block's rows and each row written once, without
// atomics. Sums onto senders (ct_x, w_x, the sender side of the position
// cotangents) are atomicAdds into zeroed outputs, in an order that varies
// from run to run. The weight cotangents are summed per block, then added
// once per block with atomicAdds: cf_vjp and cf_hesjvp run one block per SM
// (their shared memory allows no more), each over N / SMs rows. Runs of
// masked edges (the padding edges at the dead last node) are skipped a
// block-width window at a time. Everything is float32 FMA on the CUDA cores:
// no TF32, no tensor cores.
//
// cf_fwd_kernel (U <= 128) runs on the fused cfconv's tiled layout
// (csrc/fused_cfconv.cu): 256 threads, two blocks a SM (__launch_bounds__(256,
// 2)), each over max(16, N / (2 SMs)) receiver rows, so that W1 and W2 are
// staged about twice per SM per call (the layout it replaced, one block per
// 16 rows, staged them 512 times at N 8192); 32-edge chunks reached through
// next_real, their geometry and basis rows as cf_vjp's; the products in 4 x 4
// register tiles over a row-major W2 with rows padded to 32 units (read only
// by rows: no swizzle). The section above the kernel has its phases. Shared
// memory at U 128, B 20: 113376 bytes (W2 64 KB, W1 10 KB, the chunk's h and
// m rows 32 KB, basis rows and per-edge scalars): two blocks fit the SM's 228
// KB. Registers (ptxas, sm_90a): 119, no spills. On an NVIDIA H100 80GB HBM3
// at 700 W, at the schnet_train batch (chip_smoke.py phase 15, L2-cold):
// 0.164 ms (5.2x its bound), the layout it replaced (now cf_fwd_wide_kernel)
// 0.299 in the same call. Measured against it in turns
// (probe_kernel_variants.py): rows for one block a SM 0.211 ms; each warp
// computing its own edges' geometry and basis rows, two block barriers a
// chunk fewer, 0.165 (no faster); the product loop unrolled by two 0.165,
// by four 0.160 (kept).
//
// cf_fwd_wide_kernel and cf_hesjvp_wide_kernel (U above 128; as the fused
// cfconv's wide kernel): thread u owns unit u; per-edge scalars (r, its
// cotangents) are block sums over the units in a fixed order. W1 and W2 sit in shared
// memory, W2 with its rows padded to U + 1 so that both a column (thread u
// reading W2[t, u]) and a row (thread t reading W2[t, u]) are free of bank
// conflicts; cf_hesjvp_wide_kernel reads uW2 from global memory (L2), by
// columns from uW2 and by rows from its transpose, both coalesced; its
// weight sums sit in shared memory (each thread its own column).
//
// cf_hesjvp_kernel (U <= 128) runs on cf_vjp's layout below: its products
// are F = h W2 and dF = dh W2 (+ h uW2) in one pass over W2, abar = W2 a and
// hbar = W2 q (+ uW2 a) in another, and the W2 sum dh^T a + h^T q in
// registers: 6 U x U products an edge without weight tangents, 8 with. The
// section above the kernel has its phases. Shared memory at U 128, B 20:
// 183008 bytes (W2 64 KB; W1, uW1 and the W1 sum 30 KB; the chunk's h, dh,
// a, q and m rows 80 KB; basis rows and per-edge scalars), one block a SM.
// Registers (ptxas, sm_90a): 255 a thread in both variants, no spills (0
// bytes stack). On an NVIDIA H100 80GB HBM3 at 700 W, at the schnet_train
// batch (chip_smoke.py phase 15, L2-cold): 0.754 ms without weight tangents
// (the training step's call; 4.0x its bound), 1.210 ms with every tangent
// (4.8x); the kernel it replaced (now cf_hesjvp_wide_kernel) took 2.825.
// Product loops unrolled by one instead of two: 241 / 254 registers, 0.760
// and 1.220 ms in the same call (probe_kernel_variants.py).
//
// cf_vjp is bound by its three U x U products per edge (F = h W2, W2 a and
// the W2 sum h^T a: 3 x 16384 FMA at U 128). Its layout keeps them off
// shared memory and barriers: one block of kThreadsVjp = 256 threads (8
// warps) per SM, chunks of 32 edges; warp w takes 4 of them, lane l the
// units 4 l .. 4 l + 3 (and 4 (l + 32) .. for U above 128). Each product
// runs as 4 x 4 register tiles (edges x units) fed by float4 shared loads:
// one load per 8 FMA. W2 sits in shared memory once, its float4 columns
// XOR-swizzled by row (swz), so that the row reads of h W2 and the column
// reads of W2 a are both free of bank conflicts. The W2 sum (16 rows x 4
// units a thread) and the b1 and b2 sums live in registers for the block's
// whole edge range; the W1 sum (B is a runtime size) in shared memory, each
// thread its own entries, updated once per chunk. The r cotangent of an
// edge, a sum over its units, is a warp sum: a warp holds every unit of its
// edges. Barriers: 8 per chunk of 32 edges (three in next_real). Shared
// memory at U 128, B 20: 140000 bytes (W2 64 KB, W1 and its sum 20 KB, the
// chunk's h, a and dz 48 KB, basis rows and per-edge scalars). U in (128,
// 148] takes a second unit group a lane and a 32 x 8 W2 sum a thread.
// Registers (ptxas, sm_90a): 227 a thread at U <= 128, no spills; 255 and a
// 960-byte stack for U above 128. Why 256 threads and not 512 (16 warps,
// 2 x 4 tiles, an 8 x 4 W2 sum, 128 registers and an 8-byte stack): at the
// schnet_train batch on an NVIDIA H100 80GB HBM3 at 700 W, 256 took
// 0.462 ms and 512 0.491 in one call (probe_kernel_variants.py), and 256
// reads W2 from shared memory half as often per edge.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kRowsFwd = 16;   // receiver rows per block of cf_fwd_wide_kernel
constexpr int kMinRows = 16;   // fewest receiver rows per block of the other kernels
constexpr int kEdgesFwd = 16;  // edges per chunk of cf_fwd_wide_kernel
constexpr int kEdges = 8;      // edges per chunk of cf_hesjvp_wide_kernel
constexpr int kStage = 16;     // loads in flight per thread while staging weights
constexpr float kLog2 = 0.6931471805599453f;
constexpr float kEps = 1e-12f;
constexpr float kSqrtEps = 1e-6f;

// per-edge float slots, each as wide as a chunk (kEdges, kEdgesTile); DRBAR and
// RBAR are adjacent so that one block sum fills both
enum Slot { R = 0, V = 1, DU = 4, DR = 7, DRBAR = 8, RBAR = 9, DV = 10, kSlots = 13 };
// per-edge int slots
enum ISlot { RECV = 0, SEND = 1, REAL = 2, LIVE = 3, kISlots = 4 };
constexpr int kMisc = 4;  // ints: the edge range, the first real edge, padding

__device__ __forceinline__ int lower_bound(const int* __restrict__ ids, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// dst[(i / cols) * ld + i % cols] = src[i] for i < rows * cols by the
// block's threads, kStage loads in flight per thread
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld,
                                      const float* __restrict__ src, int rows,
                                      int cols) {
  const int n = rows * cols, tid = threadIdx.x, nthreads = blockDim.x;
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
      if (i < n) dst[(i / cols) * ld + i % cols] = v[q];
    }
  }
}

__device__ __forceinline__ void fill(float* dst, int n, float value) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = value;
}

// h = ssp(z) = softplus(z) - log 2 computed stably, and sig = sigmoid(z)
__device__ __forceinline__ void hidden(float z, float& h, float& sig) {
  const float t = expf(-fabsf(z));
  h = fmaxf(z, 0.0f) + log1pf(t) - kLog2;
  const float inv = 1.0f / (1.0f + t);
  sig = z >= 0.0f ? inv : t * inv;
}

__device__ __forceinline__ float ssp(float z) {
  return fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z))) - kLog2;
}

// the Gaussian centres offset + k / B * distance_max, rounded once from double
__device__ __forceinline__ void fill_shifts(float* s_shift, int B, double dmax,
                                            double offset) {
  for (int k = threadIdx.x; k < B; k += blockDim.x)
    s_shift[k] = static_cast<float>(offset + static_cast<double>(k) / B * dmax);
}

// The first edge in [c, e1) whose mask is set, or e1; every thread returns
// the same. Contains barriers: called by the whole block.
__device__ int next_real(const unsigned char* __restrict__ mask, int c, int e1,
                         int* s_first) {
  for (; c < e1; c += blockDim.x) {
    if (threadIdx.x == 0) *s_first = e1;
    __syncthreads();
    const int e = c + threadIdx.x;
    if (e < e1 && mask[e]) atomicMin(s_first, e);
    __syncthreads();
    const int first = *s_first;
    __syncthreads();  // read before thread 0 resets it
    if (first < e1) return first;
  }
  return e1;
}

// b[j * B + k] = exp(gamma (r_j - s_k)^2) for the chunk's n edges
__device__ __forceinline__ void basis(float* s_b, const float* s_r, const float* s_shift,
                                      int n, int B, float gamma) {
  for (int i = threadIdx.x; i < n * B; i += blockDim.x) {
    const int j = i / B, k = i - j * B;
    const float diff = s_r[j] - s_shift[k];
    s_b[i] = expf(gamma * diff * diff);
  }
}

// out[v] = the sum over the block's threads of p[v], in a fixed order; the
// caller synchronises before reading out
template <int NV>
__device__ __forceinline__ void block_sum(float (&p)[NV], float* s_red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float s = p[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s_red[warp * NV + v] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += s_red[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// Geometry of the chunk's edges c .. c + n - 1, by thread j < n: receiver,
// sender, mask, whether r is live (a real edge with |v|^2 > 1e-12), r, v and,
// given upos, du and dr = v.du / r (0 where r is held).
__device__ __forceinline__ void edge_geometry(
    const float* __restrict__ pos, const float* __restrict__ upos,
    const int* __restrict__ send, const int* __restrict__ recv,
    const unsigned char* __restrict__ mask, int c, int n, float* s_ef, int* s_ei) {
  const int j = threadIdx.x;
  if (j >= n) return;
  const int e = c + j;
  const int si = __ldg(send + e), ri = __ldg(recv + e);
  const int real = mask[e] != 0;
  float v[3], du[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = real ? __ldg(pos + 3 * si + q) - __ldg(pos + 3 * ri + q) : 0.0f;
    if (upos != nullptr && real) du[q] = __ldg(upos + 3 * si + q) - __ldg(upos + 3 * ri + q);
  }
  const float d2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const int live = real && d2 > kEps;
  const float r = live ? sqrtf(d2) : kSqrtEps;
  s_ei[RECV * kEdges + j] = ri;
  s_ei[SEND * kEdges + j] = si;
  s_ei[REAL * kEdges + j] = real;
  s_ei[LIVE * kEdges + j] = live;
  s_ef[R * kEdges + j] = r;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    s_ef[(V + q) * kEdges + j] = v[q];
    s_ef[(DU + q) * kEdges + j] = du[q];
  }
  s_ef[DR * kEdges + j] =
      live ? (v[0] * du[0] + v[1] * du[1] + v[2] * du[2]) / r : 0.0f;
}

// ------------------------------------------------------- cf_fwd (U above 128)

__host__ __device__ __forceinline__ int hidden_stride(int U) { return (U + 3) & ~3; }

__global__ void cf_fwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                                   const float* __restrict__ w1, const float* __restrict__ b1,
                                   const float* __restrict__ w2, const float* __restrict__ b2,
                                   const int* __restrict__ send, const int* __restrict__ recv,
                                   const unsigned char* __restrict__ mask,
                                   float* __restrict__ out, int N, int E, int B, int U,
                                   double dmax, double offset, float gamma) {
  extern __shared__ float4 smem4[];
  const int uh = hidden_stride(U);
  float* s_h = reinterpret_cast<float*>(smem4);  // [kEdgesFwd][uh]
  float* s_w2 = s_h + kEdgesFwd * uh;            // [U][U]
  float* s_w1 = s_w2 + U * U;                    // [B][U]
  float* s_shift = s_w1 + B * U;                 // [B]
  float* s_b = s_shift + B;                      // [kEdgesFwd][B]
  float* s_r = s_b + kEdgesFwd * B;              // [kEdgesFwd]
  int* s_recv = reinterpret_cast<int*>(s_r + kEdgesFwd);
  int* s_send = s_recv + kEdgesFwd;
  int* s_real = s_send + kEdgesFwd;
  int* s_misc = s_real + kEdgesFwd;  // [kMisc]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRowsFwd;
  const int r1 = min(r0 + kRowsFwd, N);
  if (tid == 0) {
    s_misc[0] = lower_bound(recv, E, r0);
    s_misc[1] = lower_bound(recv, E, r1);
  }
  stage(s_w2, U, w2, U, U);
  stage(s_w1, U, w1, B, U);
  fill_shifts(s_shift, B, dmax, offset);
  fill(s_h, kEdgesFwd * uh, 0.0f);  // the padding columns [U, uh) stay 0
  __syncthreads();
  const int e0 = s_misc[0], e1 = s_misc[1];

  const int u = tid;  // this thread's hidden unit and output column
  const float b1u = u < U ? __ldg(b1 + u) : 0.0f;
  const float b2u = u < U ? __ldg(b2 + u) : 0.0f;
  float acc = 0.0f;
  int cur = r0;  // the row whose sum acc holds
  for (int c = next_real(mask, e0, e1, s_misc + 2); c < e1;
       c = next_real(mask, c, e1, s_misc + 2)) {
    const int n = min(kEdgesFwd, e1 - c);
    if (tid < n) {
      const int e = c + tid;
      const int si = __ldg(send + e), ri = __ldg(recv + e);
      const int real = mask[e] != 0;
      float d2 = 0.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float v = real ? __ldg(pos + 3 * si + q) - __ldg(pos + 3 * ri + q) : 0.0f;
        d2 = fmaf(v, v, d2);
      }
      s_r[tid] = real && d2 > kEps ? sqrtf(d2) : kSqrtEps;
      s_recv[tid] = ri;
      s_send[tid] = si;
      s_real[tid] = real;
    }
    __syncthreads();
    basis(s_b, s_r, s_shift, n, B, gamma);
    float xv[kEdgesFwd];
#pragma unroll
    for (int j = 0; j < kEdgesFwd; ++j)
      xv[j] = (u < U && j < n && s_real[j])
                  ? __ldg(x + static_cast<long long>(s_send[j]) * U + u) : 0.0f;
    __syncthreads();
    if (u < U) {
      for (int j = 0; j < n; ++j) {
        float z = b1u;
        for (int k = 0; k < B; ++k) z = fmaf(s_b[j * B + k], s_w1[k * U + u], z);
        s_h[j * uh + u] = ssp(z);
      }
    }
    __syncthreads();
    if (u < U) {
      // rows j >= n of s_h hold an earlier chunk's values; their f[j] is unused
      float f[kEdgesFwd];
#pragma unroll
      for (int j = 0; j < kEdgesFwd; ++j) f[j] = b2u;
      for (int k = 0; k < U; k += 4) {
        const float w0 = s_w2[k * U + u];
        const float wa = k + 1 < U ? s_w2[(k + 1) * U + u] : 0.0f;
        const float wb = k + 2 < U ? s_w2[(k + 2) * U + u] : 0.0f;
        const float wc = k + 3 < U ? s_w2[(k + 3) * U + u] : 0.0f;
#pragma unroll
        for (int j = 0; j < kEdgesFwd; ++j) {
          const float4 h = *reinterpret_cast<const float4*>(s_h + j * uh + k);
          f[j] = fmaf(h.x, w0, f[j]);
          f[j] = fmaf(h.y, wa, f[j]);
          f[j] = fmaf(h.z, wb, f[j]);
          f[j] = fmaf(h.w, wc, f[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kEdgesFwd; ++j) {
        if (j < n && s_real[j]) {
          const int r = s_recv[j];
          for (; cur < r; ++cur) {
            out[static_cast<long long>(cur) * U + u] = acc;
            acc = 0.0f;
          }
          acc = fmaf(xv[j], f[j], acc);
        }
      }
    }
    c += n;
    // next_real's first barrier orders this chunk's reads before the next
    // chunk's writes
  }
  if (u < U) {
    for (; cur < r1; ++cur) {
      out[static_cast<long long>(cur) * U + u] = acc;
      acc = 0.0f;
    }
  }
}

// ------------------------------------------- tiles of cf_vjp (and of cf_hesjvp)
//
// cf_vjp runs 32-edge chunks over NT threads (8 or 16 warps): warp w takes
// the chunk's edges w * EW .. w * EW + EW - 1 (EW = 32 / warps), lane l the
// unit groups g = l + 32 j (units 4 g .. 4 g + 3, j < G). Units are padded to
// up = U rounded up to 32; padded weights are 0, so padded units carry 0.

constexpr int kEdgesTile = 32;   // edges per chunk of cf_vjp, the tiled cf_fwd and cf_hesjvp
constexpr int kThreadsVjp = 256; // threads of their blocks
constexpr int kTiledUnits = 128; // U up to which cf_fwd and cf_hesjvp take the tiled kernel

__host__ __device__ __forceinline__ int units_padded(int U) { return (U + 31) & ~31; }

// Where W[row][4 col4 .. 4 col4 + 3] lies in a [up][up] matrix whose float4
// columns are XOR-swizzled by row. A quarter-warp reading one row at 8
// consecutive float4 columns, or rows 4 g + c (g = 8 consecutive lanes) at
// one float4 column, meets each bank once: neither the row reads of h W2 nor
// the column reads of W2 a conflict.
__device__ __forceinline__ int swz(int row, int col4, int up) {
  return row * up + 4 * (col4 ^ ((row >> 2) & 7));
}

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

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
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

// dst = W2 (U, U) zero-padded to [up][up] and swizzled (swz), kStage loads
// in flight per thread
__device__ __forceinline__ void stage_swizzled(float* __restrict__ dst,
                                               const float* __restrict__ src, int U, int up) {
  const int n = up * up, tid = threadIdx.x, nthreads = blockDim.x;
  for (int base = tid; base < n; base += kStage * nthreads) {
    float v[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = base + q * nthreads, t = i / up, u = i - t * up;
      v[q] = i < n && t < U && u < U ? __ldg(src + t * U + u) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      const int i = base + q * nthreads, t = i / up, u = i - t * up;
      if (i < n) dst[swz(t, u >> 2, up) + (u & 3)] = v[q];
    }
  }
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

// edge_geometry over a chunk of KE slots (stride KE in s_ef, s_ei): slots
// j >= n are edges that are not real
template <int KE>
__device__ __forceinline__ void chunk_geometry(
    const float* __restrict__ pos, const float* __restrict__ upos,
    const int* __restrict__ send, const int* __restrict__ recv,
    const unsigned char* __restrict__ mask, int c, int n, float* s_ef, int* s_ei) {
  const int j = threadIdx.x;
  if (j >= KE) return;
  const int e = c + j;
  const bool in = j < n;
  const int si = in ? __ldg(send + e) : 0, ri = in ? __ldg(recv + e) : 0;
  const int real = in && mask[e] != 0;
  float v[3], du[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = real ? __ldg(pos + 3 * si + q) - __ldg(pos + 3 * ri + q) : 0.0f;
    if (upos != nullptr && real) du[q] = __ldg(upos + 3 * si + q) - __ldg(upos + 3 * ri + q);
  }
  const float d2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const int live = real && d2 > kEps;
  const float r = live ? sqrtf(d2) : kSqrtEps;
  s_ei[RECV * KE + j] = ri;
  s_ei[SEND * KE + j] = si;
  s_ei[REAL * KE + j] = real;
  s_ei[LIVE * KE + j] = live;
  s_ef[R * KE + j] = r;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    s_ef[(V + q) * KE + j] = v[q];
    s_ef[(DU + q) * KE + j] = du[q];
  }
  s_ef[DR * KE + j] = live ? (v[0] * du[0] + v[1] * du[1] + v[2] * du[2]) / r : 0.0f;
}

// ------------------------------------------------------- cf_fwd (U <= 128)
//
// kThreadsVjp threads, two blocks a SM, each over `rows` receiver rows. Per
// chunk of 32 edges: geometry and basis; warp w takes edges 4 w .. 4 w + 3,
// lane l the units 4 l .. 4 l + 3; z = b W1 + b1 gives h = ssp(z) in a
// shared row that only the warp reads back; F = h W2 + b2 runs as 4 x 4
// register tiles (W2 row-major, rows padded to up: read only by rows, so no
// swizzle); m = x[j] F goes to a shared row. After a barrier, threads u < U
// add the chunk's real m rows in edge order onto the receiver rows.

__global__ void __launch_bounds__(kThreadsVjp, 2)
    cf_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const int* __restrict__ send, const int* __restrict__ recv,
                  const unsigned char* __restrict__ mask, float* __restrict__ out, int N,
                  int E, int B, int U, int rows, double dmax, double offset, float gamma,
                  int vec) {
  constexpr int KE = kEdgesTile, NW = kThreadsVjp / 32, EW = KE / NW;
  extern __shared__ float4 smem4[];
  const int up = units_padded(U);
  float* s_w2 = reinterpret_cast<float*>(smem4);  // [up][up]
  float* s_w1 = s_w2 + up * up;                   // [B][up]
  float* s_h = s_w1 + B * up;                     // [KE][up]
  float* s_m = s_h + KE * up;                     // [KE][up]
  float* s_b = s_m + KE * up;                     // [KE][B]
  float* s_shift = s_b + KE * B;                  // [B]
  float* s_ef = s_shift + B;                      // [kSlots][KE]
  int* s_ei = reinterpret_cast<int*>(s_ef + kSlots * KE);  // [kISlots][KE]
  int* s_misc = s_ei + kISlots * KE;                       // [kMisc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, N);
  if (tid == 0) s_misc[0] = lower_bound(recv, E, r0);
  if (tid == 32) s_misc[1] = lower_bound(recv, E, r1);
  stage_padded(s_w2, w2, U, U, up);
  fill(s_w2 + U * up, (up - U) * up, 0.0f);  // the padded rows, read by the product
  stage_padded(s_w1, w1, B, U, up);
  fill_shifts(s_shift, B, dmax, offset);
  // rows of a chunk that hold no edge are read: keep them finite
  fill(s_h, 2 * KE * up, 0.0f);
  __syncthreads();
  const int e0 = s_misc[0], e1 = s_misc[1];

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int u = 4 * lane;   // this lane's units u .. u + 3
  const bool gok = u < up;  // which are not all padding
  const float4 b1v = load_units(b1, u, U, false), b2v = load_units(b2, u, U, false);
  float acc = 0.0f;  // threads tid < U: unit tid of row cur
  int cur = r0;
  for (int c = next_real(mask, e0, e1, s_misc + 2); c < e1;
       c = next_real(mask, c, e1, s_misc + 2)) {
    const int n = min(KE, e1 - c);
    chunk_geometry<KE>(pos, nullptr, send, recv, mask, c, n, s_ef, s_ei);
    __syncthreads();
    basis(s_b, s_ef + R * KE, s_shift, KE, B, gamma);
    __syncthreads();
    if (warp * EW < n) {  // this warp's slots hold edges
      float4 xv[EW];
      if (gok) {
        float4 z[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          const int e = warp * EW + ei;
          xv[ei] = s_ei[REAL * KE + e]
                       ? load_units(x + static_cast<long long>(s_ei[SEND * KE + e]) * U, u, U,
                                    vec)
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
#pragma unroll 4
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
        if (!s_ei[REAL * KE + e]) continue;
        const int r = s_ei[RECV * KE + e];
        for (; cur < r; ++cur) {
          out[static_cast<long long>(cur) * U + tid] = acc;
          acc = 0.0f;
        }
        acc += s_m[e * up + tid];
      }
    }
    c += n;
    // next_real's first barrier orders this chunk's reads before the next
    // chunk's writes
  }
  if (tid < U) {
    for (; cur < r1; ++cur) {
      out[static_cast<long long>(cur) * U + tid] = acc;
      acc = 0.0f;
    }
  }
}

// Receiver side of the position cotangent for the chunk's edges j < n, by
// threads 0-2 (component tid): rows before each edge's receiver are
// finished and written, -s_ef[(DV + tid) * KE + j] added to the open row.
template <int KE>
__device__ __forceinline__ void receiver_sweep(const float* s_ef, const int* s_ei, int n,
                                               float* __restrict__ pos_recv, float& pacc,
                                               int& pcur) {
  const int q = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const int r = s_ei[RECV * KE + j];
    for (; pcur < r; ++pcur) {
      pos_recv[3 * pcur + q] = pacc;
      pacc = 0.0f;
    }
    pacc -= s_ef[(DV + q) * KE + j];
  }
}

// ------------------------------------------------------------------ cf_vjp
//
// NT threads (kThreadsVjp), G unit groups a lane (up <= 128 G). Per chunk of
// 32 edges: geometry and basis; z = b W1 + b1 (with q = (b g) W1 for the r
// cotangent), h to shared, c = ct[i], a = c x[j] to shared; then, with no
// barrier between, F = h W2 + b2 (ct_x by atomics), dz = (W2 a) sig (to
// shared, rbar by a warp sum) and the W2 sum += h^T a in registers; then the
// W1 sum += b^T dz (shared, each thread its own entries) and dv.

template <int NT, int G>
__global__ void __launch_bounds__(NT, 1)
    cf_vjp_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ ct, const int* __restrict__ send,
                  const int* __restrict__ recv, const unsigned char* __restrict__ mask,
                  float* __restrict__ ct_x, float* __restrict__ pos_send,
                  float* __restrict__ gw1, float* __restrict__ gb1,
                  float* __restrict__ gw2, float* __restrict__ gb2,
                  float* __restrict__ pos_recv, int N, int E, int B, int U, int rows,
                  double dmax, double offset, float gamma, int vec) {
  constexpr int KE = kEdgesTile, NW = NT / 32, EW = KE / NW;
  constexpr int TI = 128 * G / NW;  // rows of the W2 sum a thread holds
  extern __shared__ float4 smem4[];
  const int up = units_padded(U), ngroups = up >> 2;
  float* s_w2 = reinterpret_cast<float*>(smem4);  // [up][up], swizzled
  float* s_w1 = s_w2 + up * up;                   // [B][up]
  float* s_gw1 = s_w1 + B * up;                   // [B][up]: the W1 sum
  float* s_h = s_gw1 + B * up;                    // [KE][up]
  float* s_a = s_h + KE * up;                     // [KE][up]
  float* s_dz = s_a + KE * up;                    // [KE][up]
  float* s_b = s_dz + KE * up;                    // [KE][B]
  float* s_shift = s_b + KE * B;                  // [B]
  float* s_ef = s_shift + B;                      // [kSlots][KE]
  int* s_ei = reinterpret_cast<int*>(s_ef + kSlots * KE);  // [kISlots][KE]
  int* s_misc = s_ei + kISlots * KE;                       // [kMisc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, N);
  if (tid == 0) s_misc[0] = lower_bound(recv, E, r0);
  if (tid == 32) s_misc[1] = lower_bound(recv, E, r1);
  stage_swizzled(s_w2, w2, U, up);
  stage_padded(s_w1, w1, B, U, up);
  fill_shifts(s_shift, B, dmax, offset);
  fill(s_gw1, B * up, 0.0f);
  // slots of a chunk that hold no edge are read: keep them finite
  fill(s_h, 3 * KE * up + KE * B, 0.0f);
  __syncthreads();
  const int e0 = s_misc[0], e1 = s_misc[1];

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int gs[G];
  bool gok[G];
  float4 b1v[G], b2v[G], gb1v[G], gb2v[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    gs[j] = lane + 32 * j;
    gok[j] = gs[j] < ngroups;
    b1v[j] = load_units(b1, 4 * gs[j], U, false);
    b2v[j] = load_units(b2, 4 * gs[j], U, false);
    gb1v[j] = gb2v[j] = zero4;
  }
  float sw2[TI][4 * G];  // the W2 sum: rows warp * TI + i, the units of the lane's groups
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int q = 0; q < 4 * G; ++q) sw2[i][q] = 0.0f;
  const bool w2_rows = warp * TI < up;
  const float two_gamma = 2.0f * gamma;
  float pacc = 0.0f;  // threads 0-2: component tid of the receiver row pcur
  int pcur = r0;
  for (int c = next_real(mask, e0, e1, s_misc + 2); c < e1;
       c = next_real(mask, c, e1, s_misc + 2)) {
    const int n = min(KE, e1 - c);
    chunk_geometry<KE>(pos, nullptr, send, recv, mask, c, n, s_ef, s_ei);
    __syncthreads();
    basis(s_b, s_ef + R * KE, s_shift, KE, B, gamma);
    __syncthreads();

    // z = b W1 + b1 -> h (shared) and sig; q = (b g) W1; c = ct[i]; a = c x[j]
    float4 cv[EW][G], sig[EW][G], qv[EW][G];
    {
      float4 xv[EW][G], z[EW][G];
      float re[EW];
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
        const bool real = s_ei[REAL * KE + e];
        const long long si = s_ei[SEND * KE + e], ri = s_ei[RECV * KE + e];
        re[ei] = s_ef[R * KE + e];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const bool ld = real && gok[j];
          cv[ei][j] = ld ? load_units(ct + ri * U, 4 * gs[j], U, vec) : zero4;
          xv[ei][j] = ld ? load_units(x + si * U, 4 * gs[j], U, vec) : zero4;
          z[ei][j] = b1v[j];
          qv[ei][j] = zero4;
        }
      }
      for (int k = 0; k < B; ++k) {
        const float sk = s_shift[k];
        float4 w[G];
#pragma unroll
        for (int j = 0; j < G; ++j) w[j] = gok[j] ? ld4(s_w1 + k * up + 4 * gs[j]) : zero4;
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          const float bk = s_b[(warp * EW + ei) * B + k];
          const float bg = bk * (two_gamma * (re[ei] - sk));
#pragma unroll
          for (int j = 0; j < G; ++j) {
            fma4(z[ei][j], bk, w[j]);
            fma4(qv[ei][j], bg, w[j]);
          }
        }
      }
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!gok[j]) continue;
          float4 h;
          hidden(z[ei][j].x, h.x, sig[ei][j].x);
          hidden(z[ei][j].y, h.y, sig[ei][j].y);
          hidden(z[ei][j].z, h.z, sig[ei][j].z);
          hidden(z[ei][j].w, h.w, sig[ei][j].w);
          const float4 a = make_float4(cv[ei][j].x * xv[ei][j].x, cv[ei][j].y * xv[ei][j].y,
                                       cv[ei][j].z * xv[ei][j].z, cv[ei][j].w * xv[ei][j].w);
          st4(s_h + e * up + 4 * gs[j], h);
          st4(s_a + e * up + 4 * gs[j], a);
          gb2v[j].x += a.x;
          gb2v[j].y += a.y;
          gb2v[j].z += a.z;
          gb2v[j].w += a.w;
        }
      }
    }
    __syncthreads();

    const bool edges = warp * EW < n;  // this warp's slots hold edges
    if (edges) {
      // F = h W2 + b2, then ct_x[j] += c F
      float4 f[EW][G];
#pragma unroll
      for (int ei = 0; ei < EW; ++ei)
#pragma unroll
        for (int j = 0; j < G; ++j) f[ei][j] = b2v[j];
#pragma unroll 2
      for (int t = 0; t < up; t += 4) {
        float4 h4[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) h4[ei] = ld4(s_h + (warp * EW + ei) * up + t);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!gok[j]) continue;
          const float4 wa = ld4(s_w2 + swz(t, gs[j], up));
          const float4 wb = ld4(s_w2 + swz(t + 1, gs[j], up));
          const float4 wc = ld4(s_w2 + swz(t + 2, gs[j], up));
          const float4 wd = ld4(s_w2 + swz(t + 3, gs[j], up));
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            fma4(f[ei][j], h4[ei].x, wa);
            fma4(f[ei][j], h4[ei].y, wb);
            fma4(f[ei][j], h4[ei].z, wc);
            fma4(f[ei][j], h4[ei].w, wd);
          }
        }
      }
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
        if (!s_ei[REAL * KE + e]) continue;
        float* row = ct_x + static_cast<long long>(s_ei[SEND * KE + e]) * U;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int u = 4 * gs[j];
          if (u < U) atomicAdd(row + u, cv[ei][j].x * f[ei][j].x);
          if (u + 1 < U) atomicAdd(row + u + 1, cv[ei][j].y * f[ei][j].y);
          if (u + 2 < U) atomicAdd(row + u + 2, cv[ei][j].z * f[ei][j].z);
          if (u + 3 < U) atomicAdd(row + u + 3, cv[ei][j].w * f[ei][j].w);
        }
      }

      // dz = (W2 a) sig to shared, the b1 sum, and rbar = sum_u dz_u q_u
      float4 d[EW][G];
#pragma unroll
      for (int ei = 0; ei < EW; ++ei)
#pragma unroll
        for (int j = 0; j < G; ++j) d[ei][j] = zero4;
#pragma unroll 2
      for (int t = 0; t < up; t += 4) {
        float4 a4[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) a4[ei] = ld4(s_a + (warp * EW + ei) * up + t);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!gok[j]) continue;
          const int u = 4 * gs[j];
          const float4 va = ld4(s_w2 + swz(u, t >> 2, up));
          const float4 vb = ld4(s_w2 + swz(u + 1, t >> 2, up));
          const float4 vc = ld4(s_w2 + swz(u + 2, t >> 2, up));
          const float4 vd = ld4(s_w2 + swz(u + 3, t >> 2, up));
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            d[ei][j].x += dot4(va, a4[ei]);
            d[ei][j].y += dot4(vb, a4[ei]);
            d[ei][j].z += dot4(vc, a4[ei]);
            d[ei][j].w += dot4(vd, a4[ei]);
          }
        }
      }
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
        float p = 0.0f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!gok[j]) continue;
          const float4 dz = make_float4(d[ei][j].x * sig[ei][j].x, d[ei][j].y * sig[ei][j].y,
                                        d[ei][j].z * sig[ei][j].z, d[ei][j].w * sig[ei][j].w);
          st4(s_dz + e * up + 4 * gs[j], dz);
          gb1v[j].x += dz.x;
          gb1v[j].y += dz.y;
          gb1v[j].z += dz.z;
          gb1v[j].w += dz.w;
          p += dot4(dz, qv[ei][j]);
        }
        p = warp_sum(p);
        if (lane == 0) s_ef[RBAR * KE + e] = p;
      }
    }

    // the W2 sum += h^T a over the chunk's edges: rows warp * TI .. + TI
    if (w2_rows) {
      for (int e = 0; e < n; ++e) {
        float4 av[G];
#pragma unroll
        for (int j = 0; j < G; ++j) av[j] = gok[j] ? ld4(s_a + e * up + 4 * gs[j]) : zero4;
#pragma unroll
        for (int i = 0; i < TI; i += 4) {
          const float4 h4 = ld4(s_h + e * up + warp * TI + i);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int j = 0; j < G; ++j) {
              sw2[i + ii][4 * j] = fmaf(hv[ii], av[j].x, sw2[i + ii][4 * j]);
              sw2[i + ii][4 * j + 1] = fmaf(hv[ii], av[j].y, sw2[i + ii][4 * j + 1]);
              sw2[i + ii][4 * j + 2] = fmaf(hv[ii], av[j].z, sw2[i + ii][4 * j + 2]);
              sw2[i + ii][4 * j + 3] = fmaf(hv[ii], av[j].w, sw2[i + ii][4 * j + 3]);
            }
        }
      }
    }
    __syncthreads();

    // the W1 sum += b^T dz: each thread its own entries (rows k = warp mod NW)
    for (int k = warp; k < B; k += NW) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (!gok[j]) continue;
        float* p = s_gw1 + k * up + 4 * gs[j];
        float4 g = ld4(p);
#pragma unroll 8
        for (int e = 0; e < n; ++e) fma4(g, s_b[e * B + k], ld4(s_dz + e * up + 4 * gs[j]));
        st4(p, g);
      }
    }
    // dv = rbar v / r onto the sender (atomics) and the receiver (the sweep)
    if (tid < n) {
      const int j = tid;
      const bool live = s_ei[LIVE * KE + j];
      const float scale = live ? s_ef[RBAR * KE + j] / s_ef[R * KE + j] : 0.0f;
      const int si = s_ei[SEND * KE + j];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float dv = scale * s_ef[(V + q) * KE + j];
        if (live) atomicAdd(pos_send + 3 * si + q, dv);
        s_ef[(DV + q) * KE + j] = dv;
      }
    }
    __syncthreads();
    if (tid < 3) receiver_sweep<KE>(s_ef, s_ei, n, pos_recv, pacc, pcur);
    c += n;
    // next_real's first barrier orders this chunk's reads before the next
    // chunk's writes
  }
  if (tid < 3) {
    for (; pcur < r1; ++pcur) {
      pos_recv[3 * pcur + tid] = pacc;
      pacc = 0.0f;
    }
  }
  if (w2_rows) {
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int t = warp * TI + i;
      if (t >= U) break;
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int u = 4 * gs[j] + q;
          if (gok[j] && u < U) atomicAdd(gw2 + t * U + u, sw2[i][4 * j + q]);
        }
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float sb1[4] = {gb1v[j].x, gb1v[j].y, gb1v[j].z, gb1v[j].w};
    const float sb2[4] = {gb2v[j].x, gb2v[j].y, gb2v[j].z, gb2v[j].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = 4 * gs[j] + q;
      if (gok[j] && u < U) {
        atomicAdd(gb1 + u, sb1[q]);
        atomicAdd(gb2 + u, sb2[q]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < B * U; i += NT) {
    const int k = i / U;
    atomicAdd(gw1 + i, s_gw1[k * up + i - k * U]);
  }
}

// --------------------------------------------------------------- cf_hesjvp
//
// The tiled kernel (U <= kTiledUnits), on cf_vjp's layout: one block of
// kThreadsVjp = 256 threads per SM, 32-edge chunks, warp w on edges
// 4 w .. 4 w + 3, lane l on units 4 l .. 4 l + 3, each U x U product as
// 4 x 4 register tiles fed by float4 shared loads from the swizzled W2.
// WT says whether the weight tangents uW1, ub1, uW2, ub2 are present; with
// WT false (a force loss: they are absent) every term of theirs is left
// out, not multiplied by zero. Per chunk:
//   phase 0: geometry (with dr) and basis; z = b W1 + b1, s1 = (b g) W1 and
//     [WT] b uW1 in one loop over the bins; dz = dr s1 (+ b uW1 + ub1),
//     h, sig, dh = sig dz; rows h and dh to shared; c = ct[i], x[j], ux[j]
//     by the lane that owns the units; rows a = c x[j] and q = c ux[j] to
//     shared; the b2 sum += q in registers.
//   phase 1: F = h W2 + b2 and dF = dh W2 (+ h uW2 + ub2) in one pass over
//     W2; w_x[j] += c dF (atomics); the message rows m = dF x[j] + F ux[j]
//     to shared; the W2 sum += dh (x) a + h (x) q in registers. After a
//     barrier, threads u < U sweep the m rows in edge order into Ju, each
//     row written once.
//   phase 2: abar = W2 a and hbar = W2 q (+ uW2 a) in one pass over W2;
//     z, s1, s2 = (b (g^2 + 2 gamma)) W1 and [WT] s3 = (b g) uW1, b uW1
//     recomputed from the basis rows (cheaper in registers than carrying
//     sig and dz from phase 0); dzbar = abar sig, zbar = hbar sig +
//     abar sig (1 - sig) dz to the rows of h and dh; the b1 sum += zbar;
//     drbar = sum_u dzbar s1 and rbar = sum_u dr dzbar s2 (+ dzbar s3) +
//     zbar s1, each a warp sum (a warp holds every unit of its edges).
//   then the W1 sum += (b g dr) (x) dzbar + b (x) zbar (shared, each thread
//   its own entries), wv onto the sender (atomics) and the receiver (the
//   sweep). Barriers: 9 per chunk (three in next_real).
// uW2 (WT only) is read from device memory as float4 rows: uw2 in phase 1,
// its transpose uw2t in phase 2, both coalesced (64 KB, L2-resident).

template <bool WT>
__global__ void __launch_bounds__(kThreadsVjp, 1)
    cf_hesjvp_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ ct, const float* __restrict__ ux,
                     const float* __restrict__ upos, const float* __restrict__ uw1,
                     const float* __restrict__ ub1, const float* __restrict__ uw2,
                     const float* __restrict__ ub2, const float* __restrict__ uw2t,
                     const int* __restrict__ send, const int* __restrict__ recv,
                     const unsigned char* __restrict__ mask, float* __restrict__ ju,
                     float* __restrict__ w_x, float* __restrict__ pos_send,
                     float* __restrict__ ww1, float* __restrict__ wb1,
                     float* __restrict__ ww2, float* __restrict__ wb2,
                     float* __restrict__ pos_recv, int N, int E, int B, int U, int rows,
                     double dmax, double offset, float gamma, int vec) {
  constexpr int NT = kThreadsVjp, KE = kEdgesTile, NW = NT / 32, EW = KE / NW;
  constexpr int TI = kTiledUnits / NW;  // rows of the W2 sum a thread holds
  extern __shared__ float4 smem4[];
  const int up = units_padded(U), ngroups = up >> 2;
  float* s_w2 = reinterpret_cast<float*>(smem4);  // [up][up], swizzled
  float* s_w1 = s_w2 + up * up;                   // [B][up]
  float* s_uw1 = s_w1 + B * up;                   // [B][up], staged if WT
  float* s_gw1 = s_uw1 + B * up;                  // [B][up]: the W1 sum
  float* s_h = s_gw1 + B * up;                    // [KE][up]: h, then dzbar
  float* s_dh = s_h + KE * up;                    // [KE][up]: dh, then zbar
  float* s_a = s_dh + KE * up;                    // [KE][up]
  float* s_q = s_a + KE * up;                     // [KE][up]
  float* s_m = s_q + KE * up;                     // [KE][up]: the rows of Ju
  float* s_b = s_m + KE * up;                     // [KE][B]
  float* s_shift = s_b + KE * B;                  // [B]
  float* s_ef = s_shift + B;                      // [kSlots][KE]
  int* s_ei = reinterpret_cast<int*>(s_ef + kSlots * KE);  // [kISlots][KE]
  int* s_misc = s_ei + kISlots * KE;                       // [kMisc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, N);
  if (tid == 0) s_misc[0] = lower_bound(recv, E, r0);
  if (tid == 32) s_misc[1] = lower_bound(recv, E, r1);
  stage_swizzled(s_w2, w2, U, up);
  stage_padded(s_w1, w1, B, U, up);
  if (WT) stage_padded(s_uw1, uw1, B, U, up);
  fill_shifts(s_shift, B, dmax, offset);
  fill(s_gw1, B * up, 0.0f);
  // slots of a chunk that hold no edge are read: keep them finite
  fill(s_h, 5 * KE * up + KE * B, 0.0f);
  __syncthreads();
  const int e0 = s_misc[0], e1 = s_misc[1];

  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int u = 4 * lane;             // this lane's units u .. u + 3
  const bool gok = lane < ngroups;    // which are not all padding
  const float4 b1v = load_units(b1, u, U, false), b2v = load_units(b2, u, U, false);
  const float4 ub1v = WT ? load_units(ub1, u, U, false) : zero4;
  const float4 ub2v = WT ? load_units(ub2, u, U, false) : zero4;
  float4 wb1v = zero4, wb2v = zero4;
  float sw2[TI][4];  // the W2 sum: rows warp * TI + i, units u .. u + 3
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) sw2[i][k] = 0.0f;
  const bool w2_rows = warp * TI < up;
  const float two_gamma = 2.0f * gamma;
  float acc = 0.0f;   // threads tid < U: unit tid of Ju's row cur
  int cur = r0;
  float pacc = 0.0f;  // threads 0-2: component tid of w_pos's receiver row pcur
  int pcur = r0;
  for (int c = next_real(mask, e0, e1, s_misc + 2); c < e1;
       c = next_real(mask, c, e1, s_misc + 2)) {
    const int n = min(KE, e1 - c);
    chunk_geometry<KE>(pos, upos, send, recv, mask, c, n, s_ef, s_ei);
    __syncthreads();
    basis(s_b, s_ef + R * KE, s_shift, KE, B, gamma);
    __syncthreads();
    const bool edges = warp * EW < n;  // this warp's slots hold edges

    // phase 0: h, dh, a = c x[j], q = c ux[j] to shared
    if (edges && gok) {
      float4 cv[EW], xv[EW], uxv[EW], z[EW], s1[EW], bu[EW];
      float re[EW];
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
        const bool real = s_ei[REAL * KE + e];
        const long long si = s_ei[SEND * KE + e], ri = s_ei[RECV * KE + e];
        cv[ei] = real ? load_units(ct + ri * U, u, U, vec) : zero4;
        xv[ei] = real ? load_units(x + si * U, u, U, vec) : zero4;
        uxv[ei] = real ? load_units(ux + si * U, u, U, vec) : zero4;
        re[ei] = s_ef[R * KE + e];
        z[ei] = b1v;
        s1[ei] = zero4;
        bu[ei] = ub1v;
      }
      for (int k = 0; k < B; ++k) {
        const float sk = s_shift[k];
        const float4 w = ld4(s_w1 + k * up + u);
        const float4 uw = WT ? ld4(s_uw1 + k * up + u) : zero4;
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          const float bk = s_b[(warp * EW + ei) * B + k];
          fma4(z[ei], bk, w);
          fma4(s1[ei], bk * (two_gamma * (re[ei] - sk)), w);
          if (WT) fma4(bu[ei], bk, uw);
        }
      }
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
        const float dr = s_ef[DR * KE + e];
        float4 h, sig;
        hidden(z[ei].x, h.x, sig.x);
        hidden(z[ei].y, h.y, sig.y);
        hidden(z[ei].z, h.z, sig.z);
        hidden(z[ei].w, h.w, sig.w);
        const float4 dh = make_float4(sig.x * fmaf(dr, s1[ei].x, bu[ei].x),
                                      sig.y * fmaf(dr, s1[ei].y, bu[ei].y),
                                      sig.z * fmaf(dr, s1[ei].z, bu[ei].z),
                                      sig.w * fmaf(dr, s1[ei].w, bu[ei].w));
        const float4 q = make_float4(cv[ei].x * uxv[ei].x, cv[ei].y * uxv[ei].y,
                                     cv[ei].z * uxv[ei].z, cv[ei].w * uxv[ei].w);
        st4(s_h + e * up + u, h);
        st4(s_dh + e * up + u, dh);
        st4(s_a + e * up + u, make_float4(cv[ei].x * xv[ei].x, cv[ei].y * xv[ei].y,
                                          cv[ei].z * xv[ei].z, cv[ei].w * xv[ei].w));
        st4(s_q + e * up + u, q);
        wb2v.x += q.x;
        wb2v.y += q.y;
        wb2v.z += q.z;
        wb2v.w += q.w;
      }
    }
    __syncthreads();

    // phase 1: F and dF, then w_x and the message rows m
    if (edges && gok) {
      float4 f[EW], df[EW];
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        f[ei] = b2v;
        df[ei] = ub2v;
      }
#pragma unroll 2
      for (int t = 0; t < up; t += 4) {
        float4 h4[EW], dh4[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          h4[ei] = ld4(s_h + (warp * EW + ei) * up + t);
          dh4[ei] = ld4(s_dh + (warp * EW + ei) * up + t);
        }
        const float4 wa = ld4(s_w2 + swz(t, lane, up));
        const float4 wb = ld4(s_w2 + swz(t + 1, lane, up));
        const float4 wc = ld4(s_w2 + swz(t + 2, lane, up));
        const float4 wd = ld4(s_w2 + swz(t + 3, lane, up));
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          fma4(f[ei], h4[ei].x, wa);
          fma4(f[ei], h4[ei].y, wb);
          fma4(f[ei], h4[ei].z, wc);
          fma4(f[ei], h4[ei].w, wd);
          fma4(df[ei], dh4[ei].x, wa);
          fma4(df[ei], dh4[ei].y, wb);
          fma4(df[ei], dh4[ei].z, wc);
          fma4(df[ei], dh4[ei].w, wd);
        }
        if (WT) {
          // rows t .. t + 3 of uW2 (zero at U and beyond)
          const float4 ua = t < U ? load_units(uw2 + t * U, u, U, vec) : zero4;
          const float4 ub = t + 1 < U ? load_units(uw2 + (t + 1) * U, u, U, vec) : zero4;
          const float4 uc = t + 2 < U ? load_units(uw2 + (t + 2) * U, u, U, vec) : zero4;
          const float4 ud = t + 3 < U ? load_units(uw2 + (t + 3) * U, u, U, vec) : zero4;
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            fma4(df[ei], h4[ei].x, ua);
            fma4(df[ei], h4[ei].y, ub);
            fma4(df[ei], h4[ei].z, uc);
            fma4(df[ei], h4[ei].w, ud);
          }
        }
      }
      // c, x[j] and ux[j] again (L2-hot since phase 0), not held in registers
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const int e = warp * EW + ei;
        const bool real = s_ei[REAL * KE + e];
        const long long si = s_ei[SEND * KE + e], ri = s_ei[RECV * KE + e];
        const float4 xv = real ? load_units(x + si * U, u, U, vec) : zero4;
        const float4 uxv = real ? load_units(ux + si * U, u, U, vec) : zero4;
        st4(s_m + e * up + u, make_float4(fmaf(df[ei].x, xv.x, f[ei].x * uxv.x),
                                          fmaf(df[ei].y, xv.y, f[ei].y * uxv.y),
                                          fmaf(df[ei].z, xv.z, f[ei].z * uxv.z),
                                          fmaf(df[ei].w, xv.w, f[ei].w * uxv.w)));
        if (!real) continue;
        const float4 cv = load_units(ct + ri * U, u, U, vec);
        float* row = w_x + si * U;
        if (u < U) atomicAdd(row + u, cv.x * df[ei].x);
        if (u + 1 < U) atomicAdd(row + u + 1, cv.y * df[ei].y);
        if (u + 2 < U) atomicAdd(row + u + 2, cv.z * df[ei].z);
        if (u + 3 < U) atomicAdd(row + u + 3, cv.w * df[ei].w);
      }
    }

    // the W2 sum += dh (x) a + h (x) q over the chunk's edges: rows
    // warp * TI .. + TI
    if (w2_rows && gok) {
      for (int e = 0; e < n; ++e) {
        const float4 av = ld4(s_a + e * up + u), qv = ld4(s_q + e * up + u);
#pragma unroll
        for (int i = 0; i < TI; i += 4) {
          const float4 h4 = ld4(s_h + e * up + warp * TI + i);
          const float4 dh4 = ld4(s_dh + e * up + warp * TI + i);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
          const float dhv[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            sw2[i + ii][0] = fmaf(dhv[ii], av.x, fmaf(hv[ii], qv.x, sw2[i + ii][0]));
            sw2[i + ii][1] = fmaf(dhv[ii], av.y, fmaf(hv[ii], qv.y, sw2[i + ii][1]));
            sw2[i + ii][2] = fmaf(dhv[ii], av.z, fmaf(hv[ii], qv.z, sw2[i + ii][2]));
            sw2[i + ii][3] = fmaf(dhv[ii], av.w, fmaf(hv[ii], qv.w, sw2[i + ii][3]));
          }
        }
      }
    }
    __syncthreads();

    // Ju: the m rows onto the receivers in edge order, each row written once
    if (tid < U) {
      for (int e = 0; e < n; ++e) {
        const int r = s_ei[RECV * KE + e];
        for (; cur < r; ++cur) {
          ju[static_cast<long long>(cur) * U + tid] = acc;
          acc = 0.0f;
        }
        acc += s_m[e * up + tid];
      }
    }

    // phase 2: abar, hbar, dzbar and zbar (to the rows of h and dh), the b1
    // sum, drbar and rbar
    if (edges) {
      float pd[EW], pr[EW];
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) pd[ei] = pr[ei] = 0.0f;
      if (gok) {
        float4 ab[EW], hb[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) ab[ei] = hb[ei] = zero4;
#pragma unroll 2
        for (int t = 0; t < up; t += 4) {
          float4 a4[EW], q4[EW];
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            a4[ei] = ld4(s_a + (warp * EW + ei) * up + t);
            q4[ei] = ld4(s_q + (warp * EW + ei) * up + t);
          }
          const float4 va = ld4(s_w2 + swz(u, t >> 2, up));
          const float4 vb = ld4(s_w2 + swz(u + 1, t >> 2, up));
          const float4 vc = ld4(s_w2 + swz(u + 2, t >> 2, up));
          const float4 vd = ld4(s_w2 + swz(u + 3, t >> 2, up));
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            ab[ei].x += dot4(va, a4[ei]);
            ab[ei].y += dot4(vb, a4[ei]);
            ab[ei].z += dot4(vc, a4[ei]);
            ab[ei].w += dot4(vd, a4[ei]);
            hb[ei].x += dot4(va, q4[ei]);
            hb[ei].y += dot4(vb, q4[ei]);
            hb[ei].z += dot4(vc, q4[ei]);
            hb[ei].w += dot4(vd, q4[ei]);
          }
          if (WT) {
            // rows t .. t + 3 of uW2^T: uW2[u .. u + 3][t + i]
            const float4 ta = t < U ? load_units(uw2t + t * U, u, U, vec) : zero4;
            const float4 tb = t + 1 < U ? load_units(uw2t + (t + 1) * U, u, U, vec) : zero4;
            const float4 tc = t + 2 < U ? load_units(uw2t + (t + 2) * U, u, U, vec) : zero4;
            const float4 td = t + 3 < U ? load_units(uw2t + (t + 3) * U, u, U, vec) : zero4;
#pragma unroll
            for (int ei = 0; ei < EW; ++ei) {
              fma4(hb[ei], a4[ei].x, ta);
              fma4(hb[ei], a4[ei].y, tb);
              fma4(hb[ei], a4[ei].z, tc);
              fma4(hb[ei], a4[ei].w, td);
            }
          }
        }
        // z, s1, s2 and [WT] s3 and b uW1 again over the bins
        float4 z[EW], s1[EW], s2[EW], s3[EW], bu[EW];
        float re[EW];
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          re[ei] = s_ef[R * KE + warp * EW + ei];
          z[ei] = b1v;
          s1[ei] = s2[ei] = s3[ei] = zero4;
          bu[ei] = ub1v;
        }
        for (int k = 0; k < B; ++k) {
          const float sk = s_shift[k];
          const float4 w = ld4(s_w1 + k * up + u);
          const float4 uw = WT ? ld4(s_uw1 + k * up + u) : zero4;
#pragma unroll
          for (int ei = 0; ei < EW; ++ei) {
            const float bk = s_b[(warp * EW + ei) * B + k];
            const float gk = two_gamma * (re[ei] - sk);
            const float bg = bk * gk;
            fma4(z[ei], bk, w);
            fma4(s1[ei], bg, w);
            fma4(s2[ei], bk * fmaf(gk, gk, two_gamma), w);
            if (WT) {
              fma4(s3[ei], bg, uw);
              fma4(bu[ei], bk, uw);
            }
          }
        }
#pragma unroll
        for (int ei = 0; ei < EW; ++ei) {
          const int e = warp * EW + ei;
          const float dr = s_ef[DR * KE + e];
          const float zv[4] = {z[ei].x, z[ei].y, z[ei].z, z[ei].w};
          const float av[4] = {ab[ei].x, ab[ei].y, ab[ei].z, ab[ei].w};
          const float hv[4] = {hb[ei].x, hb[ei].y, hb[ei].z, hb[ei].w};
          const float s1v[4] = {s1[ei].x, s1[ei].y, s1[ei].z, s1[ei].w};
          const float buv[4] = {bu[ei].x, bu[ei].y, bu[ei].z, bu[ei].w};
          float dzb[4], zb[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float h, sig;
            hidden(zv[k], h, sig);
            const float dz = fmaf(dr, s1v[k], buv[k]);
            dzb[k] = av[k] * sig;
            zb[k] = fmaf(hv[k], sig, dzb[k] * (1.0f - sig) * dz);
          }
          const float4 dzb4 = make_float4(dzb[0], dzb[1], dzb[2], dzb[3]);
          const float4 zb4 = make_float4(zb[0], zb[1], zb[2], zb[3]);
          st4(s_h + e * up + u, dzb4);
          st4(s_dh + e * up + u, zb4);
          wb1v.x += zb4.x;
          wb1v.y += zb4.y;
          wb1v.z += zb4.z;
          wb1v.w += zb4.w;
          pd[ei] = dot4(dzb4, s1[ei]);
          pr[ei] = fmaf(dr, dot4(dzb4, s2[ei]), dot4(zb4, s1[ei]));
          if (WT) pr[ei] += dot4(dzb4, s3[ei]);
        }
      }
#pragma unroll
      for (int ei = 0; ei < EW; ++ei) {
        const float d = warp_sum(pd[ei]), r = warp_sum(pr[ei]);
        if (lane == 0) {
          s_ef[DRBAR * KE + warp * EW + ei] = d;
          s_ef[RBAR * KE + warp * EW + ei] = r;
        }
      }
    }
    __syncthreads();

    // the W1 sum += (b g dr) (x) dzbar + b (x) zbar: each thread its own
    // entries (rows k = warp mod NW)
    if (gok) {
      for (int k = warp; k < B; k += NW) {
        const float sk = s_shift[k];
        float* p = s_gw1 + k * up + u;
        float4 g = ld4(p);
#pragma unroll 4
        for (int e = 0; e < n; ++e) {
          const float bk = s_b[e * B + k];
          const float bgdr = bk * (two_gamma * (s_ef[R * KE + e] - sk)) * s_ef[DR * KE + e];
          fma4(g, bgdr, ld4(s_h + e * up + u));
          fma4(g, bk, ld4(s_dh + e * up + u));
        }
        st4(p, g);
      }
    }
    // wv = rbar v / r + drbar (du - dr v / r) / r onto the sender (atomics)
    // and the receiver (the sweep)
    if (tid < n) {
      const int j = tid;
      const bool live = s_ei[LIVE * KE + j];
      const float rinv = 1.0f / s_ef[R * KE + j];
      const float rbar = s_ef[RBAR * KE + j], drbar = s_ef[DRBAR * KE + j];
      const float dr = s_ef[DR * KE + j];
      const int si = s_ei[SEND * KE + j];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float vh = s_ef[(V + q) * KE + j] * rinv;
        const float wv =
            live ? rbar * vh + drbar * (s_ef[(DU + q) * KE + j] - dr * vh) * rinv : 0.0f;
        if (live) atomicAdd(pos_send + 3 * si + q, wv);
        s_ef[(DV + q) * KE + j] = wv;
      }
    }
    __syncthreads();
    if (tid < 3) receiver_sweep<KE>(s_ef, s_ei, n, pos_recv, pacc, pcur);
    c += n;
    // next_real's first barrier orders this chunk's reads before the next
    // chunk's writes
  }
  if (tid < U) {
    for (; cur < r1; ++cur) {
      ju[static_cast<long long>(cur) * U + tid] = acc;
      acc = 0.0f;
    }
  }
  if (tid < 3) {
    for (; pcur < r1; ++pcur) {
      pos_recv[3 * pcur + tid] = pacc;
      pacc = 0.0f;
    }
  }
  if (w2_rows && gok) {
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int t = warp * TI + i;
      if (t >= U) break;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (u + k < U) atomicAdd(ww2 + t * U + u + k, sw2[i][k]);
    }
  }
  if (gok) {
    const float sb1[4] = {wb1v.x, wb1v.y, wb1v.z, wb1v.w};
    const float sb2[4] = {wb2v.x, wb2v.y, wb2v.z, wb2v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (u + k < U) {
        atomicAdd(wb1 + u + k, sb1[k]);
        atomicAdd(wb2 + u + k, sb2[k]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < B * U; i += NT) {
    const int k = i / U;
    atomicAdd(ww1 + i, s_gw1[k * up + i - k * U]);
  }
}

// The kernel of U above kTiledUnits (the chain's gate is U 148 at B 20):
// thread u owns unit u over 8-edge chunks, per-edge scalars are block sums,
// W2 sits in shared memory with its rows padded to U + 1, the W2 and W1 sums
// in shared memory; every weight tangent is read (absent ones as zeros).
__global__ void cf_hesjvp_wide_kernel(
    const float* __restrict__ x, const float* __restrict__ pos,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ ct, const float* __restrict__ ux,
    const float* __restrict__ upos, const float* __restrict__ uw1,
    const float* __restrict__ ub1, const float* __restrict__ uw2,
    const float* __restrict__ ub2, const float* __restrict__ uw2t,
    const int* __restrict__ send, const int* __restrict__ recv,
    const unsigned char* __restrict__ mask, float* __restrict__ ju,
    float* __restrict__ w_x, float* __restrict__ pos_send, float* __restrict__ ww1,
    float* __restrict__ wb1, float* __restrict__ ww2, float* __restrict__ wb2,
    float* __restrict__ pos_recv, int N, int E, int B, int U, int rows, double dmax,
    double offset, float gamma) {
  extern __shared__ float4 smem4[];
  const int ld = U + 1, nw = blockDim.x >> 5;
  float* s_w2 = reinterpret_cast<float*>(smem4);  // [U][ld]
  float* s_gw2 = s_w2 + U * ld;                   // [U][U]
  float* s_w1 = s_gw2 + U * U;                    // [B][U]
  float* s_uw1 = s_w1 + B * U;                    // [B][U]
  float* s_gw1 = s_uw1 + B * U;                   // [B][U]
  float* s_shift = s_gw1 + B * U;                 // [B]
  float* s_h = s_shift + B;                       // [kEdges][U]
  float* s_dh = s_h + kEdges * U;                 // [kEdges][U]
  float* s_a = s_dh + kEdges * U;                 // [kEdges][U]
  float* s_q = s_a + kEdges * U;                  // [kEdges][U]
  float* s_b = s_q + kEdges * U;                  // [kEdges][B]
  float* s_ef = s_b + kEdges * B;                 // [kSlots][kEdges]
  float* s_red = s_ef + kSlots * kEdges;          // [nw][2 kEdges]
  int* s_ei = reinterpret_cast<int*>(s_red + 2 * nw * kEdges);
  int* s_misc = s_ei + kISlots * kEdges;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, N);
  if (tid == 0) {
    s_misc[0] = lower_bound(recv, E, r0);
    s_misc[1] = lower_bound(recv, E, r1);
  }
  stage(s_w2, ld, w2, U, U);
  stage(s_w1, U, w1, B, U);
  stage(s_uw1, U, uw1, B, U);
  fill_shifts(s_shift, B, dmax, offset);
  fill(s_gw2, U * U, 0.0f);
  fill(s_gw1, B * U, 0.0f);
  fill(s_h, 4 * kEdges * U + kEdges * B, 0.0f);
  __syncthreads();
  const int e0 = s_misc[0], e1 = s_misc[1];

  const int u = tid;
  const float b1u = u < U ? __ldg(b1 + u) : 0.0f;
  const float b2u = u < U ? __ldg(b2 + u) : 0.0f;
  const float ub1u = u < U ? __ldg(ub1 + u) : 0.0f;
  const float ub2u = u < U ? __ldg(ub2 + u) : 0.0f;
  const float two_gamma = 2.0f * gamma;
  float wb1u = 0.0f, wb2u = 0.0f;
  float acc = 0.0f;  // Ju of row cur
  int cur = r0;
  float pacc = 0.0f;  // threads 0-2: component tid of w_pos's receiver row pcur
  int pcur = r0;
  for (int c = next_real(mask, e0, e1, s_misc + 2); c < e1;
       c = next_real(mask, c, e1, s_misc + 2)) {
    const int n = min(kEdges, e1 - c);
    edge_geometry(pos, upos, send, recv, mask, c, n, s_ef, s_ei);
    __syncthreads();
    basis(s_b, s_ef + R * kEdges, s_shift, n, B, gamma);
    __syncthreads();

    // z, h, sig and their tangents dz, dh
    float sig[kEdges], dz[kEdges], xv[kEdges], uxv[kEdges], cv[kEdges];
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      sig[j] = dz[j] = xv[j] = uxv[j] = cv[j] = 0.0f;
      if (u < U && j < n) {
        const float r = s_ef[R * kEdges + j], dr = s_ef[DR * kEdges + j];
        float z = b1u, t = ub1u;
        for (int k = 0; k < B; ++k) {
          const float bk = s_b[j * B + k];
          const float w = s_w1[k * U + u];
          z = fmaf(bk, w, z);
          t = fmaf(bk, fmaf(dr * (two_gamma * (r - s_shift[k])), w, s_uw1[k * U + u]), t);
        }
        float h;
        hidden(z, h, sig[j]);
        dz[j] = t;
        s_h[j * U + u] = h;
        s_dh[j * U + u] = sig[j] * t;
        if (s_ei[REAL * kEdges + j]) {
          const long long sj = s_ei[SEND * kEdges + j];
          xv[j] = __ldg(x + sj * U + u);
          uxv[j] = __ldg(ux + sj * U + u);
          cv[j] = __ldg(ct + static_cast<long long>(s_ei[RECV * kEdges + j]) * U + u);
        }
      }
    }
    __syncthreads();

    // F, dF, Ju, w_x, a = c x, q = c ux, and column u of the W2 and b2 sums
    if (u < U) {
      float f[kEdges], df[kEdges], a[kEdges], q[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        f[j] = b2u;
        df[j] = ub2u;
      }
      for (int t = 0; t < U; ++t) {
        const float w = s_w2[t * ld + u];
        const float uw = __ldg(uw2 + t * U + u);
#pragma unroll
        for (int j = 0; j < kEdges; ++j) {
          const float h = s_h[j * U + t];
          f[j] = fmaf(h, w, f[j]);
          df[j] = fmaf(s_dh[j * U + t], w, fmaf(h, uw, df[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        a[j] = q[j] = 0.0f;
        if (j < n && s_ei[REAL * kEdges + j]) {
          const int r = s_ei[RECV * kEdges + j];
          for (; cur < r; ++cur) {
            ju[static_cast<long long>(cur) * U + u] = acc;
            acc = 0.0f;
          }
          acc = fmaf(df[j], xv[j], fmaf(f[j], uxv[j], acc));
          atomicAdd(w_x + static_cast<long long>(s_ei[SEND * kEdges + j]) * U + u,
                    cv[j] * df[j]);
          a[j] = cv[j] * xv[j];
          q[j] = cv[j] * uxv[j];
        }
        s_a[j * U + u] = a[j];
        s_q[j * U + u] = q[j];
        wb2u += q[j];
      }
      for (int t = 0; t < U; ++t) {
        float g = s_gw2[t * U + u];
#pragma unroll
        for (int j = 0; j < kEdges; ++j)
          g = fmaf(s_dh[j * U + t], a[j], fmaf(s_h[j * U + t], q[j], g));
        s_gw2[t * U + u] = g;
      }
    }
    __syncthreads();

    // abar = W2 a, hbar = uW2 a + W2 q, dzbar, zbar, column u of the W1 and
    // b1 sums, and the partial sums of each edge's drbar and rbar
    float p[2 * kEdges];
#pragma unroll
    for (int j = 0; j < 2 * kEdges; ++j) p[j] = 0.0f;
    if (u < U) {
      float ab[kEdges], hb[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) ab[j] = hb[j] = 0.0f;
      for (int t = 0; t < U; ++t) {
        const float w = s_w2[u * ld + t];
        const float uw = __ldg(uw2t + t * U + u);  // uW2[u, t]
#pragma unroll
        for (int j = 0; j < kEdges; ++j) {
          const float aj = s_a[j * U + t];
          ab[j] = fmaf(w, aj, ab[j]);
          hb[j] = fmaf(uw, aj, fmaf(w, s_q[j * U + t], hb[j]));
        }
      }
      float dzb[kEdges], zb[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        dzb[j] = ab[j] * sig[j];
        zb[j] = hb[j] * sig[j] + ab[j] * sig[j] * (1.0f - sig[j]) * dz[j];
        wb1u += zb[j];
      }
      float s1[kEdges], s2[kEdges], s3[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) s1[j] = s2[j] = s3[j] = 0.0f;
      for (int k = 0; k < B; ++k) {
        const float w = s_w1[k * U + u];
        const float uw = s_uw1[k * U + u];
        const float sk = s_shift[k];
        float g = s_gw1[k * U + u];
#pragma unroll
        for (int j = 0; j < kEdges; ++j) {
          const float bk = s_b[j * B + k];
          const float gk = two_gamma * (s_ef[R * kEdges + j] - sk);
          const float bg = bk * gk;
          g = fmaf(bg * s_ef[DR * kEdges + j], dzb[j], fmaf(bk, zb[j], g));
          s1[j] = fmaf(w, bg, s1[j]);
          s2[j] = fmaf(w, bk * fmaf(gk, gk, two_gamma), s2[j]);
          s3[j] = fmaf(uw, bg, s3[j]);
        }
        s_gw1[k * U + u] = g;
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        p[j] = dzb[j] * s1[j];
        p[kEdges + j] = s_ef[DR * kEdges + j] * dzb[j] * s2[j] + dzb[j] * s3[j]
                        + zb[j] * s1[j];
      }
    }
    block_sum<2 * kEdges>(p, s_red, s_ef + DRBAR * kEdges);
    __syncthreads();

    // wv = rbar v / r + drbar (du - dr v / r) / r onto the sender (atomics)
    // and the receiver (below)
    if (tid < n) {
      const int j = tid;
      const bool live = s_ei[LIVE * kEdges + j];
      const float rinv = 1.0f / s_ef[R * kEdges + j];
      const float rbar = s_ef[RBAR * kEdges + j], drbar = s_ef[DRBAR * kEdges + j];
      const float dr = s_ef[DR * kEdges + j];
      const int si = s_ei[SEND * kEdges + j];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float vh = s_ef[(V + q) * kEdges + j] * rinv;
        const float wv =
            live ? rbar * vh + drbar * (s_ef[(DU + q) * kEdges + j] - dr * vh) * rinv : 0.0f;
        if (live) atomicAdd(pos_send + 3 * si + q, wv);
        s_ef[(DV + q) * kEdges + j] = wv;
      }
    }
    __syncthreads();
    if (tid < 3) {
      for (int j = 0; j < n; ++j) {
        const int r = s_ei[RECV * kEdges + j];
        for (; pcur < r; ++pcur) {
          pos_recv[3 * pcur + tid] = pacc;
          pacc = 0.0f;
        }
        pacc -= s_ef[(DV + tid) * kEdges + j];
      }
    }
    c += n;
  }
  if (u < U) {
    for (; cur < r1; ++cur) {
      ju[static_cast<long long>(cur) * U + u] = acc;
      acc = 0.0f;
    }
  }
  if (tid < 3) {
    for (; pcur < r1; ++pcur) {
      pos_recv[3 * pcur + tid] = pacc;
      pacc = 0.0f;
    }
  }
  __syncthreads();
  for (int i = tid; i < U * U; i += blockDim.x) atomicAdd(ww2 + i, s_gw2[i]);
  for (int i = tid; i < B * U; i += blockDim.x) atomicAdd(ww1 + i, s_gw1[i]);
  if (u < U) {
    atomicAdd(wb1 + u, wb1u);
    atomicAdd(wb2 + u, wb2u);
  }
}

int threads_for(int U) { return ((U + 31) / 32) * 32; }

// receiver rows per block for `per_sm` blocks a SM (cf_vjp and cf_hesjvp
// one, the tiled cf_fwd two), at least kMinRows
int rows_for(int N, int per_sm = 1) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int rows = (N + per_sm * sms - 1) / (per_sm * sms);
  return rows > kMinRows ? rows : kMinRows;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Dynamic shared memory of one block of kernel `kind` (0 cf_fwd, 1 cf_vjp,
// 2 cf_hesjvp) for (B, U), in bytes.
extern "C" long long gcnn_cf_smem_bytes(int kind, int B, int U) {
  const long long b = B, u = U, nw = threads_for(U) / 32;
  if (kind == 0 && U <= kTiledUnits) {
    // the tiled kernel: W2 and W1 padded to up units, the chunk's h and m
    // rows, its basis rows, the centres and per-edge scalars; 4 ints an edge
    const long long e = kEdgesTile, p = units_padded(U);
    const long long floats = p * p + b * p + 2 * e * p + e * b + b + kSlots * e;
    return 4 * (floats + kISlots * e + kMisc);
  }
  if (kind == 0) {
    const long long e = kEdgesFwd;
    const long long floats = e * hidden_stride(U) + u * u + b * u + b + e * b + e;
    return 4 * (floats + 3 * e + kMisc);
  }
  if (kind == 1) {
    // W2 and W1 padded to up units, the W1 sum, the chunk's h, a and dz rows,
    // its basis rows, the centres and per-edge scalars; 4 ints an edge
    const long long e = kEdgesTile, p = units_padded(U);
    const long long floats = p * p + 2 * b * p + 3 * e * p + e * b + b + kSlots * e;
    return 4 * (floats + kISlots * e + kMisc);
  }
  if (U <= kTiledUnits) {
    // the tiled kernel: W2 (swizzled), W1, uW1 and the W1 sum padded to up
    // units, the chunk's h, dh, a, q and m rows, its basis rows, the centres
    // and per-edge scalars; 4 ints an edge (the W2 sum lives in registers)
    const long long e = kEdgesTile, p = units_padded(U);
    const long long floats = p * p + 3 * b * p + 5 * e * p + e * b + b + kSlots * e;
    return 4 * (floats + kISlots * e + kMisc);
  }
  const long long e = kEdges;
  const long long floats = u * (u + 1) + u * u + b + e * b + kSlots * e + 3 * b * u
                           + 4 * e * u + 2 * nw * e;
  return 4 * (floats + kISlots * e + kMisc);
}

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// Outputs that take atomics (the sender sides, the weight sums) come zeroed.
extern "C" int gcnn_cf_fwd_f32(const float* x, const float* pos, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               const int* send, const int* recv,
                               const unsigned char* mask, float* out, int N, int E,
                               int B, int U, double dmax, double offset, double gamma,
                               void* stream) {
  if (N <= 0 || U <= 0) return static_cast<int>(cudaSuccess);
  const long long smem = gcnn_cf_smem_bytes(0, B, U);
  const auto s = static_cast<cudaStream_t>(stream);
  if (U > kTiledUnits) {
    cudaError_t err = allow_smem(cf_fwd_wide_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_fwd_wide_kernel<<<(N + kRowsFwd - 1) / kRowsFwd, threads_for(U), smem, s>>>(
        x, pos, w1, b1, w2, b2, send, recv, mask, out, N, E, B, U, dmax, offset,
        static_cast<float>(gamma));
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = allow_smem(cf_fwd_kernel, smem);
  if (err == cudaSuccess)  // room for two blocks a SM
    err = cudaFuncSetAttribute(cf_fwd_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float4 loads of x rows where they are 16-byte aligned
  const int vec = U % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const int rows = rows_for(N, 2);
  cf_fwd_kernel<<<(N + rows - 1) / rows, kThreadsVjp, smem, s>>>(
      x, pos, w1, b1, w2, b2, send, recv, mask, out, N, E, B, U, rows, dmax, offset,
      static_cast<float>(gamma), vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_cf_vjp_f32(const float* x, const float* pos, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               const float* ct, const int* send, const int* recv,
                               const unsigned char* mask, float* ct_x, float* pos_send,
                               float* gw1, float* gb1, float* gw2, float* gb2,
                               float* pos_recv, int N, int E, int B, int U, double dmax,
                               double offset, double gamma, void* stream) {
  if (N <= 0 || U <= 0) return static_cast<int>(cudaSuccess);
  const int up = units_padded(U);
  if (up > 256) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = gcnn_cf_smem_bytes(1, B, U);
  auto kernel = up <= 128 ? cf_vjp_kernel<kThreadsVjp, 1> : cf_vjp_kernel<kThreadsVjp, 2>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float4 loads of x and ct rows where they are 16-byte aligned
  const int vec = U % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0
                  && reinterpret_cast<std::uintptr_t>(ct) % 16 == 0;
  const int rows = rows_for(N);
  kernel<<<(N + rows - 1) / rows, kThreadsVjp, smem, static_cast<cudaStream_t>(stream)>>>(
      x, pos, w1, b1, w2, b2, ct, send, recv, mask, ct_x, pos_send, gw1, gb1, gw2, gb2,
      pos_recv, N, E, B, U, rows, dmax, offset, static_cast<float>(gamma), vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_cf_hesjvp_f32(
    const float* x, const float* pos, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* ct, const float* ux, const float* upos,
    const float* uw1, const float* ub1, const float* uw2, const float* ub2,
    const float* uw2t, const int* send, const int* recv, const unsigned char* mask,
    float* ju, float* w_x, float* pos_send, float* ww1, float* wb1, float* ww2,
    float* wb2, float* pos_recv, int N, int E, int B, int U, double dmax, double offset,
    double gamma, void* stream) {
  if (N <= 0 || U <= 0) return static_cast<int>(cudaSuccess);
  // the weight tangents uw1, ub1, uw2 (with uw2t, its transpose) and ub2 are
  // all given, or all null (absent: the tiled kernel leaves their terms out)
  const bool wt = uw1 != nullptr;
  if ((ub1 != nullptr) != wt || (uw2 != nullptr) != wt || (ub2 != nullptr) != wt
      || (uw2t != nullptr) != wt || (!wt && U > kTiledUnits))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = gcnn_cf_smem_bytes(2, B, U);
  const int rows = rows_for(N);
  const auto s = static_cast<cudaStream_t>(stream);
  if (U > kTiledUnits) {
    cudaError_t err = allow_smem(cf_hesjvp_wide_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cf_hesjvp_wide_kernel<<<(N + rows - 1) / rows, threads_for(U), smem, s>>>(
        x, pos, w1, b1, w2, b2, ct, ux, upos, uw1, ub1, uw2, ub2, uw2t, send, recv, mask,
        ju, w_x, pos_send, ww1, wb1, ww2, wb2, pos_recv, N, E, B, U, rows, dmax, offset,
        static_cast<float>(gamma));
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = wt ? cf_hesjvp_kernel<true> : cf_hesjvp_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float4 loads of the (N, U) and (U, U) rows where they are 16-byte aligned
  bool vec = U % 4 == 0;
  for (const float* p : {x, ct, ux, uw2, uw2t})
    vec = vec && reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  kernel<<<(N + rows - 1) / rows, kThreadsVjp, smem, s>>>(
      x, pos, w1, b1, w2, b2, ct, ux, upos, uw1, ub1, uw2, ub2, uw2t, send, recv, mask, ju,
      w_x, pos_send, ww1, wb1, ww2, wb2, pos_recv, N, E, B, U, rows, dmax, offset,
      static_cast<float>(gamma), vec);
  return static_cast<int>(cudaGetLastError());
}
