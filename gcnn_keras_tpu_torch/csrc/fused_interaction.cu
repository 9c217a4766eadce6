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
// cf_vjp about 3 times that, cf_hesjvp about 8 times (16 U^2 + 16 B U). The
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
// cf_fwd and cf_hesjvp (as csrc/fused_cfconv.cu): thread u owns unit u;
// per-edge scalars (r, its cotangents) are block sums over the units in a
// fixed order. W1 and W2 sit in shared memory, W2 with its rows padded to
// U + 1 so that both a column (thread u reading W2[t, u]) and a row (thread t
// reading W2[t, u]) are free of bank conflicts; cf_hesjvp reads uW2 from
// global memory (L2), by columns from uW2 and by rows from its transpose,
// both coalesced; its weight sums sit in shared memory (each thread its own
// column).
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

namespace {

constexpr int kRowsFwd = 16;   // receiver rows per block of cf_fwd
constexpr int kMinRows = 16;   // fewest receiver rows per block of cf_vjp, cf_hesjvp
constexpr int kEdgesFwd = 16;  // edges per chunk of cf_fwd
constexpr int kEdges = 8;      // edges per chunk of cf_hesjvp
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

// ------------------------------------------------------------------ cf_fwd

__host__ __device__ __forceinline__ int hidden_stride(int U) { return (U + 3) & ~3; }

__global__ void cf_fwd_kernel(const float* __restrict__ x, const float* __restrict__ pos,
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

constexpr int kEdgesTile = 32;   // edges per chunk of cf_vjp
constexpr int kThreadsVjp = 256; // threads of a cf_vjp block (one block per SM)

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

__global__ void cf_hesjvp_kernel(
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

// receiver rows per block of cf_vjp and cf_hesjvp: one block per SM
int rows_for(int N) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int rows = (N + sms - 1) / sms;
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
  cudaError_t err = allow_smem(cf_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cf_fwd_kernel<<<(N + kRowsFwd - 1) / kRowsFwd, threads_for(U), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      x, pos, w1, b1, w2, b2, send, recv, mask, out, N, E, B, U, dmax, offset,
      static_cast<float>(gamma));
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
  const long long smem = gcnn_cf_smem_bytes(2, B, U);
  cudaError_t err = allow_smem(cf_hesjvp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = rows_for(N);
  cf_hesjvp_kernel<<<(N + rows - 1) / rows, threads_for(U), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, pos, w1, b1, w2, b2, ct, ux, upos, uw1, ub1, uw2, ub2, uw2t, send, recv, mask,
      ju, w_x, pos_send, ww1, wb1, ww2, wb2, pos_recv, N, E, B, U, rows, dmax, offset,
      static_cast<float>(gamma));
  return static_cast<int>(cudaGetLastError());
}
