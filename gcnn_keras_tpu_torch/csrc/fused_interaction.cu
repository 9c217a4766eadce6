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
// Layout (as csrc/fused_cfconv.cu): a block owns a run of receiver rows and
// their contiguous edge range (binary search), thread u owns unit u, and
// edges go in chunks; per-edge scalars (r, its cotangents) are block sums
// over the units in a fixed order. W1 and W2 sit in shared memory, W2 with
// its rows padded to U + 1 so that both a column (thread u reading W2[t, u])
// and a row (thread t reading W2[t, u]) are free of bank conflicts; cf_hesjvp
// reads uW2 from global memory (L2), by columns from uW2 and by rows from its
// transpose, both coalesced. Sums onto receivers (y, Ju, the receiver side of
// the position cotangents) are taken in edge order over the block's rows and
// each row written once, without atomics. Sums onto senders (ct_x, w_x, the
// sender side of the position cotangents) are atomicAdds into zeroed outputs,
// in an order that varies from run to run. The weight cotangents are summed
// per block in shared memory (each thread its own column), then added once
// per block with atomicAdds: cf_vjp and cf_hesjvp run one block per SM (their
// shared memory allows no more), each over N / SMs rows. Runs of masked
// edges (the padding edges at the dead last node) are skipped a block-width
// window at a time. Everything is float32 FMA: no TF32, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsFwd = 16;   // receiver rows per block of cf_fwd
constexpr int kMinRows = 16;   // fewest receiver rows per block of cf_vjp, cf_hesjvp
constexpr int kEdgesFwd = 16;  // edges per chunk of cf_fwd
constexpr int kEdges = 8;      // edges per chunk of cf_vjp and cf_hesjvp
constexpr int kStage = 16;     // loads in flight per thread while staging weights
constexpr float kLog2 = 0.6931471805599453f;
constexpr float kEps = 1e-12f;
constexpr float kSqrtEps = 1e-6f;

// per-edge float slots of cf_vjp and cf_hesjvp, each kEdges wide; DRBAR and
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

// ------------------------------------------------------------------ cf_vjp

__global__ void cf_vjp_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                              const float* __restrict__ w1, const float* __restrict__ b1,
                              const float* __restrict__ w2, const float* __restrict__ b2,
                              const float* __restrict__ ct, const int* __restrict__ send,
                              const int* __restrict__ recv,
                              const unsigned char* __restrict__ mask,
                              float* __restrict__ ct_x, float* __restrict__ pos_send,
                              float* __restrict__ gw1, float* __restrict__ gb1,
                              float* __restrict__ gw2, float* __restrict__ gb2,
                              float* __restrict__ pos_recv, int N, int E, int B, int U,
                              int rows, double dmax, double offset, float gamma) {
  extern __shared__ float4 smem4[];
  const int ld = U + 1, nw = blockDim.x >> 5;
  float* s_w2 = reinterpret_cast<float*>(smem4);  // [U][ld]
  float* s_gw2 = s_w2 + U * ld;                   // [U][U]
  float* s_w1 = s_gw2 + U * U;                    // [B][U]
  float* s_gw1 = s_w1 + B * U;                    // [B][U]
  float* s_shift = s_gw1 + B * U;                 // [B]
  float* s_h = s_shift + B;                       // [kEdges][U]
  float* s_a = s_h + kEdges * U;                  // [kEdges][U]
  float* s_b = s_a + kEdges * U;                  // [kEdges][B]
  float* s_ef = s_b + kEdges * B;                 // [kSlots][kEdges]
  float* s_red = s_ef + kSlots * kEdges;          // [nw][kEdges]
  int* s_ei = reinterpret_cast<int*>(s_red + nw * kEdges);  // [kISlots][kEdges]
  int* s_misc = s_ei + kISlots * kEdges;                    // [kMisc]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, N);
  if (tid == 0) {
    s_misc[0] = lower_bound(recv, E, r0);
    s_misc[1] = lower_bound(recv, E, r1);
  }
  stage(s_w2, ld, w2, U, U);
  stage(s_w1, U, w1, B, U);
  fill_shifts(s_shift, B, dmax, offset);
  fill(s_gw2, U * U, 0.0f);
  fill(s_gw1, B * U, 0.0f);
  // rows j >= n of a chunk are read with a zero weight: keep them finite
  fill(s_h, 2 * kEdges * U + kEdges * B, 0.0f);
  __syncthreads();
  const int e0 = s_misc[0], e1 = s_misc[1];

  const int u = tid;  // this thread's unit: column u of W2, W1 and their sums
  const float b1u = u < U ? __ldg(b1 + u) : 0.0f;
  const float b2u = u < U ? __ldg(b2 + u) : 0.0f;
  float gb1u = 0.0f, gb2u = 0.0f;
  float pacc = 0.0f;  // threads 0-2: component tid of the receiver row pcur
  int pcur = r0;
  for (int c = next_real(mask, e0, e1, s_misc + 2); c < e1;
       c = next_real(mask, c, e1, s_misc + 2)) {
    const int n = min(kEdges, e1 - c);
    edge_geometry(pos, nullptr, send, recv, mask, c, n, s_ef, s_ei);
    __syncthreads();
    basis(s_b, s_ef + R * kEdges, s_shift, n, B, gamma);
    __syncthreads();

    // the hidden layer of each edge: h to shared memory, sig kept
    float sig[kEdges], xv[kEdges], cv[kEdges];
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      sig[j] = xv[j] = cv[j] = 0.0f;
      if (u < U && j < n) {
        float z = b1u;
        for (int k = 0; k < B; ++k) z = fmaf(s_b[j * B + k], s_w1[k * U + u], z);
        float h;
        hidden(z, h, sig[j]);
        s_h[j * U + u] = h;
        if (s_ei[REAL * kEdges + j]) {
          xv[j] = __ldg(x + static_cast<long long>(s_ei[SEND * kEdges + j]) * U + u);
          cv[j] = __ldg(ct + static_cast<long long>(s_ei[RECV * kEdges + j]) * U + u);
        }
      }
    }
    __syncthreads();

    // F, ct_x, the cotangent a of F, and column u of the W2 and b2 sums
    if (u < U) {
      float f[kEdges], a[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) f[j] = b2u;
      for (int t = 0; t < U; ++t) {
        const float w = s_w2[t * ld + u];
#pragma unroll
        for (int j = 0; j < kEdges; ++j) f[j] = fmaf(s_h[j * U + t], w, f[j]);
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        a[j] = 0.0f;
        if (j < n && s_ei[REAL * kEdges + j]) {
          atomicAdd(ct_x + static_cast<long long>(s_ei[SEND * kEdges + j]) * U + u,
                    cv[j] * f[j]);
          a[j] = cv[j] * xv[j];
        }
        s_a[j * U + u] = a[j];
        gb2u += a[j];
      }
      for (int t = 0; t < U; ++t) {
        float g = s_gw2[t * U + u];
#pragma unroll
        for (int j = 0; j < kEdges; ++j) g = fmaf(s_h[j * U + t], a[j], g);
        s_gw2[t * U + u] = g;
      }
    }
    __syncthreads();

    // dz = (W2 a) sig, column u of the W1 and b1 sums, and the partial sums
    // of each edge's rbar
    float p[kEdges];
#pragma unroll
    for (int j = 0; j < kEdges; ++j) p[j] = 0.0f;
    if (u < U) {
      float dz[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) dz[j] = 0.0f;
      for (int t = 0; t < U; ++t) {
        const float w = s_w2[u * ld + t];
#pragma unroll
        for (int j = 0; j < kEdges; ++j) dz[j] = fmaf(w, s_a[j * U + t], dz[j]);
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        dz[j] *= sig[j];
        gb1u += dz[j];
      }
      float bg[kEdges];
#pragma unroll
      for (int j = 0; j < kEdges; ++j) bg[j] = 0.0f;
      for (int k = 0; k < B; ++k) {
        const float w = s_w1[k * U + u];
        const float sk = s_shift[k];
        float g = s_gw1[k * U + u];
#pragma unroll
        for (int j = 0; j < kEdges; ++j) {
          const float bk = s_b[j * B + k];
          g = fmaf(bk, dz[j], g);
          bg[j] = fmaf(w, bk * (2.0f * gamma * (s_ef[R * kEdges + j] - sk)), bg[j]);
        }
        s_gw1[k * U + u] = g;
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) p[j] = dz[j] * bg[j];
    }
    block_sum<kEdges>(p, s_red, s_ef + RBAR * kEdges);
    __syncthreads();

    // dv = rbar v / r onto the sender (atomics) and the receiver (below)
    if (tid < n) {
      const int j = tid;
      const bool live = s_ei[LIVE * kEdges + j];
      const float scale = live ? s_ef[RBAR * kEdges + j] / s_ef[R * kEdges + j] : 0.0f;
      const int si = s_ei[SEND * kEdges + j];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float dv = scale * s_ef[(V + q) * kEdges + j];
        if (live) atomicAdd(pos_send + 3 * si + q, dv);
        s_ef[(DV + q) * kEdges + j] = dv;
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
  if (tid < 3) {
    for (; pcur < r1; ++pcur) {
      pos_recv[3 * pcur + tid] = pacc;
      pacc = 0.0f;
    }
  }
  __syncthreads();
  for (int i = tid; i < U * U; i += blockDim.x) atomicAdd(gw2 + i, s_gw2[i]);
  for (int i = tid; i < B * U; i += blockDim.x) atomicAdd(gw1 + i, s_gw1[i]);
  if (u < U) {
    atomicAdd(gb1 + u, gb1u);
    atomicAdd(gb2 + u, gb2u);
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
  const long long e = kEdges;
  long long floats = u * (u + 1) + u * u + b + e * b + kSlots * e;
  if (kind == 1)
    floats += 2 * b * u + 2 * e * u + nw * e;
  else
    floats += 3 * b * u + 4 * e * u + 2 * nw * e;
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
  const long long smem = gcnn_cf_smem_bytes(1, B, U);
  cudaError_t err = allow_smem(cf_vjp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = rows_for(N);
  cf_vjp_kernel<<<(N + rows - 1) / rows, threads_for(U), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      x, pos, w1, b1, w2, b2, ct, send, recv, mask, ct_x, pos_send, gw1, gb1, gw2, gb2,
      pos_recv, N, E, B, U, rows, dmax, offset, static_cast<float>(gamma));
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
