// ACSF G2 (radial) and G4 (angular) descriptors for Hopper (sm_90a): the
// forward pass, the force pass (the adjoint with respect to positions) and
// the tangent pass (the derivative along a position tangent), six kernels:
//
//   g4_fwd_kernel  pos -> G4 (N, R*m)      g2_fwd_kernel  pos -> G2
//   g4_vjp_kernel  ct (N, R*m) -> dpos     g2_vjp_kernel  ct -> dpos
//   g4_jvp_kernel  dpos (N, 3) -> dG4      g2_jvp_kernel  dpos -> dG2
//
//   G2[i, slot(z_j)*m + s]    += exp(-eta_s (r_ij - rs_s)^2) fc(r_ij; rc_s)
//   G4[i, rel(z_j,z_k)*m + s] += 2^(1-zeta_s) max(1 + lambda_s cos, 1e-30)^zeta_s
//                                * exp(-eta_s (r_ij^2 + r_ik^2 + r_jk^2))
//                                * fc(r_ij) fc(r_ik) fc(r_jk) / multiplicity
//
// over real (unmasked) edges i <- j, sorted by receiver i, and real angle
// triples (i, j, k), sorted by centre i. Float32 positions (N, 3), int32
// atomic numbers (N,), int32 indices, bool masks.
//
// Replaces the TPU kernels of gcnn_keras_tpu/ops/pallas/fused_g4.py:
// _g4_fwd (fused_g4.py:660), _g4_jvp (:691), _g4_vjp (:729), _g2_fwd (:1088),
// _g2_jvp (:1106) and _g2_vjp (:1147). Those gather positions with one-hot
// matmuls from a 3x128-row node window, keep per-angle scalars on 128-lane
// rows and pool through an (8, N) transposed table, all for the MXU and
// VPU. Here the function is kept and
// the layout dropped: one warp owns one centre (receiver) node, finds the
// node's contiguous range of sorted angles (edges) by binary search, and its
// lanes walk that range, one angle (edge) per lane, with plain loads.
//
// - forward: each lane computes every unique transcendental of its angle
//   once (exp per unique eta, pow per unique (zeta, lambda), the cutoff
//   product per unique rc) and adds the m set values into the node's output
//   row, kept in shared memory, with shared-memory atomics; the warp then
//   writes the whole row, so the output needs no zeroing.
// - force pass: the warp stages the node's cotangent row in shared memory;
//   each lane forms the five geometry cotangents (cos, s2, r_ij, r_ik, r_jk)
//   and the three vector cotangents, keeps the centre's share in registers
//   (summed over the warp at the end) and adds the neighbours' shares to
//   dpos with float atomics: the neighbours j, k are not sorted. dpos must
//   be zero on entry.
// - tangent pass: the forward pass's structure with a gathered tangent:
//   each lane also loads dpos of i, j, k, forms the tangents of the
//   geometry (dr_ij, dr_ik, dr_jk, ds2, dcos; fused_g4.py:495-503) and the
//   derivative tables of the force pass, and adds the m set tangents into
//   the node's row in shared memory. The output is per centre, so no global
//   atomics are needed; the warp writes the whole row.
//
// Masked rows (padding points at the dead node, i = j = k) are skipped, not
// multiplied by zero. Atomics, in shared memory (forward and tangent pass)
// or in global memory (force pass), make the order of each float32 sum vary
// from run to run, so results differ from run to run in the last bits.
//
// Bound: at the HDNNP2nd serving shapes (N = 8192, A = 417024, R*m = 120 for
// G4; E = 54784, R*m = 20 for G2) the bytes dominate all six: each call
// must read its index rows and mask (5.4 MB for G4, 0.5 MB for G2) and
// write (or, in the force pass, read) the (N, R*m) descriptors once, and
// the tangent pass reads dpos besides: about 9.5 MB, 2.8-2.9 us at 3.35
// TB/s for G4, 1.3 MB, 0.4 us for G2. The special-function results the G4
// function needs (an rsqrt per distance, an exp per unique eta, a log2 and
// an exp2 per unique (zeta, lambda) plus an exp2 for the derivative, a cos
// and in the force and tangent passes a sin per distance and unique r_c)
// number 16 an angle in the forward pass and 23 in the force and tangent
// passes: 1.6 and 2.3 us at 16 a clock per SM. These kernels issue more (a
// sqrt and a reciprocal apiece, a powf for c and another for dc). This
// first version is not tuned: lanes of a warp diverge over ranges of
// unequal length, lanes that share a relation contend for the same shared
// words, and the per-set tables live in local memory. Its times against
// these bounds are in PERF.md (chip_smoke.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSets = 32;
constexpr int kMaxUniq = 8;
constexpr int kMaxElements = 16;
constexpr int kMaxZ = 96;
constexpr int kMaxColumns = 2048;
constexpr int kWarps = 4;  // centre nodes per block
constexpr float kEps = 1e-12f;

}  // namespace

// Launch parameters, passed by value (ops/cuda/acsf.py mirrors both structs
// field for field; every field is 4 bytes, so there is no padding).
struct AcsfG4Params {
  int m, n_eta, n_zl, n_rc, num_rel, num_el;
  float scale;  // 1 / multiplicity
  float eta[kMaxUniq], zeta[kMaxUniq], lam[kMaxUniq];
  float pow2[kMaxUniq];  // 2^(1 - zeta)
  float rc[kMaxUniq], pi_rc[kMaxUniq];  // rc and pi / rc
  int eta_inv[kMaxSets], zl_inv[kMaxSets], rc_inv[kMaxSets];
  int slot_of_z[kMaxZ];  // element slot, -1 for an atomic number that is none
  int pair_rel[kMaxElements * kMaxElements];  // relation of (slot_j, slot_k)
};

struct AcsfG2Params {
  int m, num_rel;
  float eta[kMaxSets], rs[kMaxSets], rc[kMaxSets], pi_rc[kMaxSets];
  int slot_of_z[kMaxZ];  // element slot, 0 for an atomic number that is none
};

namespace {

// first row in [0, n) whose id (ids[row * stride]) is >= key
__device__ __forceinline__ int row_lower_bound(const int* __restrict__ ids,
                                           int stride, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + static_cast<long long>(mid) * stride) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the node's row range [begin, end), found by lanes 0 and 1, for the warp
__device__ __forceinline__ void warp_range(const int* __restrict__ ids,
                                           int stride, int n, int node,
                                           int lane, int* begin, int* end) {
  int b = 0;
  if (lane < 2) b = row_lower_bound(ids, stride, n, node + lane);
  *begin = __shfl_sync(0xffffffffu, b, 0);
  *end = __shfl_sync(0xffffffffu, b, 1);
}

__device__ __forceinline__ int z_index(int z) {
  return min(max(z, 0), kMaxZ - 1);
}

__device__ __forceinline__ float cutoff(float r, float rc, float pi_rc) {
  return 0.5f * (cosf(fminf(fmaxf(r, -rc), rc) * pi_rc) + 1.0f);
}

// d fc / d r, zero outside [-rc, rc]
__device__ __forceinline__ float cutoff_d(float r, float rc, float pi_rc) {
  return fabsf(r) <= rc ? -0.5f * pi_rc * sinf(r * pi_rc) : 0.0f;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void load3(const float* __restrict__ pos, int n,
                                      float* out) {
  const float* p = pos + 3LL * n;
  out[0] = __ldg(p);
  out[1] = __ldg(p + 1);
  out[2] = __ldg(p + 2);
}

struct Angle {
  float vij[3], vik[3], vjk[3];
  float rij, rik, rjk, cos;
};

__device__ __forceinline__ void angle_geometry(const float* __restrict__ pos,
                                               const float* pi, int j, int k,
                                               Angle* g) {
  float pj[3], pk[3];
  load3(pos, j, pj);
  load3(pos, k, pk);
  for (int d = 0; d < 3; ++d) {
    g->vij[d] = pj[d] - pi[d];
    g->vik[d] = pk[d] - pi[d];
    g->vjk[d] = pk[d] - pj[d];
  }
  g->rij = sqrtf(fmaxf(dot3(g->vij, g->vij), kEps));
  g->rik = sqrtf(fmaxf(dot3(g->vik, g->vik), kEps));
  g->rjk = sqrtf(fmaxf(dot3(g->vjk, g->vjk), kEps));
  g->cos = dot3(g->vij, g->vik) / g->rij / g->rik;
}

__device__ __forceinline__ int g4_relation(const AcsfG4Params& p, int zj,
                                           int zk) {
  const int sj = p.slot_of_z[z_index(zj)];
  const int sk = p.slot_of_z[z_index(zk)];
  return (sj < 0 || sk < 0) ? 0 : p.pair_rel[sj * p.num_el + sk];
}

// an angle's unique transcendentals and their derivatives, the tables of
// the force and tangent passes
struct AngleTables {
  float e[kMaxUniq], de[kMaxUniq], c[kMaxUniq], dc[kMaxUniq];
  float f[kMaxUniq], df_ij[kMaxUniq], df_ik[kMaxUniq], df_jk[kMaxUniq];
};

__device__ __forceinline__ void derivative_tables(const AcsfG4Params& p,
                                                  const Angle& g,
                                                  AngleTables* t) {
  const float s2 = g.rij * g.rij + g.rik * g.rik + g.rjk * g.rjk;
  for (int u = 0; u < p.n_eta; ++u) {
    t->e[u] = expf(-p.eta[u] * s2);
    t->de[u] = -p.eta[u] * t->e[u];
  }
  for (int u = 0; u < p.n_zl; ++u) {
    const float raw = g.cos * p.lam[u] + 1.0f;
    const float base = fmaxf(raw, 1e-30f);
    t->c[u] = p.pow2[u] * powf(base, p.zeta[u]);
    // zero on the clamped branch (exactly collinear angles)
    t->dc[u] = raw > 1e-30f
        ? p.pow2[u] * p.zeta[u] * p.lam[u] * powf(base, p.zeta[u] - 1.0f) : 0.0f;
  }
  for (int u = 0; u < p.n_rc; ++u) {
    const float rc = p.rc[u], w = p.pi_rc[u];
    const float fij = cutoff(g.rij, rc, w), fik = cutoff(g.rik, rc, w);
    const float fjk = cutoff(g.rjk, rc, w);
    t->f[u] = fij * fik * fjk;
    t->df_ij[u] = cutoff_d(g.rij, rc, w) * fik * fjk;
    t->df_ik[u] = fij * cutoff_d(g.rik, rc, w) * fjk;
    t->df_jk[u] = fij * fik * cutoff_d(g.rjk, rc, w);
  }
}

// d rep_s / d r of G2 set s at distance r
__device__ __forceinline__ float g2_drep_dr(const AcsfG2Params& p, int s,
                                            float r) {
  const float dr = r - p.rs[s];
  const float g = expf(-p.eta[s] * (dr * dr));
  return -2.0f * p.eta[s] * dr * g * cutoff(r, p.rc[s], p.pi_rc[s])
         + g * cutoff_d(r, p.rc[s], p.pi_rc[s]);
}

__global__ void __launch_bounds__(kWarps * 32) g4_fwd_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ angles, const bool* __restrict__ mask,
    float* __restrict__ out, int n_node, int n_angle,
    const __grid_constant__ AcsfG4Params p) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n_node) return;  // the whole warp leaves together
  const int m = p.m;
  const int width = p.num_rel * m;
  float* row = rows + warp * width;
  for (int c = lane; c < width; c += 32) row[c] = 0.0f;
  int begin, end;
  warp_range(angles, 3, n_angle, node, lane, &begin, &end);
  __syncwarp();
  float pi[3];
  load3(pos, node, pi);
  for (int a = begin + lane; a < end; a += 32) {
    if (!mask[a]) continue;
    const int j = __ldg(angles + 3LL * a + 1);
    const int k = __ldg(angles + 3LL * a + 2);
    Angle g;
    angle_geometry(pos, pi, j, k, &g);
    const float s2 = g.rij * g.rij + g.rik * g.rik + g.rjk * g.rjk;
    float e[kMaxUniq], c[kMaxUniq], f[kMaxUniq];
    for (int u = 0; u < p.n_eta; ++u) e[u] = expf(-p.eta[u] * s2);
    for (int u = 0; u < p.n_zl; ++u)
      c[u] = p.pow2[u] * powf(fmaxf(g.cos * p.lam[u] + 1.0f, 1e-30f), p.zeta[u]);
    for (int u = 0; u < p.n_rc; ++u)
      f[u] = cutoff(g.rij, p.rc[u], p.pi_rc[u]) * cutoff(g.rik, p.rc[u], p.pi_rc[u])
             * cutoff(g.rjk, p.rc[u], p.pi_rc[u]);
    float* dst = row + g4_relation(p, __ldg(z + j), __ldg(z + k)) * m;
    for (int s = 0; s < m; ++s)
      atomicAdd(dst + s, c[p.zl_inv[s]] * e[p.eta_inv[s]] * f[p.rc_inv[s]] * p.scale);
  }
  __syncwarp();
  float* o = out + static_cast<long long>(node) * width;
  for (int c = lane; c < width; c += 32) o[c] = row[c];
}

__global__ void __launch_bounds__(kWarps * 32) g4_vjp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ angles, const bool* __restrict__ mask,
    const float* __restrict__ ct, float* __restrict__ dpos, int n_node,
    int n_angle, const __grid_constant__ AcsfG4Params p) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n_node) return;
  const int m = p.m;
  const int width = p.num_rel * m;
  float* row = rows + warp * width;
  const float* ct_row = ct + static_cast<long long>(node) * width;
  for (int c = lane; c < width; c += 32) row[c] = __ldg(ct_row + c);
  int begin, end;
  warp_range(angles, 3, n_angle, node, lane, &begin, &end);
  __syncwarp();
  if (begin == end) return;
  float pi[3];
  load3(pos, node, pi);
  float d_center[3] = {0.0f, 0.0f, 0.0f};
  for (int a = begin + lane; a < end; a += 32) {
    if (!mask[a]) continue;
    const int j = __ldg(angles + 3LL * a + 1);
    const int k = __ldg(angles + 3LL * a + 2);
    Angle g;
    angle_geometry(pos, pi, j, k, &g);
    AngleTables t;
    derivative_tables(p, g, &t);
    const float* ctr = row + g4_relation(p, __ldg(z + j), __ldg(z + k)) * m;
    float a_cos = 0.0f, a_s2 = 0.0f, a_rij = 0.0f, a_rik = 0.0f, a_rjk = 0.0f;
    for (int s = 0; s < m; ++s) {
      const int ue = p.eta_inv[s], uz = p.zl_inv[s], ur = p.rc_inv[s];
      const float cts = ctr[s] * p.scale;
      const float ce = cts * t.c[uz] * t.e[ue];
      a_cos += cts * t.dc[uz] * t.e[ue] * t.f[ur];
      a_s2 += cts * t.c[uz] * t.de[ue] * t.f[ur];
      a_rij += ce * t.df_ij[ur];
      a_rik += ce * t.df_ik[ur];
      a_rjk += ce * t.df_jk[ur];
    }
    const float inv_ij = 1.0f / g.rij, inv_ik = 1.0f / g.rik;
    const float inv_jk = 1.0f / g.rjk;
    const float cross = inv_ij * inv_ik;
    const float cij = g.cos * inv_ij * inv_ij, cik = g.cos * inv_ik * inv_ik;
    for (int d = 0; d < 3; ++d) {
      const float d_vij = a_cos * (g.vik[d] * cross - g.vij[d] * cij)
                          + a_s2 * 2.0f * g.vij[d] + a_rij * g.vij[d] * inv_ij;
      const float d_vik = a_cos * (g.vij[d] * cross - g.vik[d] * cik)
                          + a_s2 * 2.0f * g.vik[d] + a_rik * g.vik[d] * inv_ik;
      const float d_vjk = a_s2 * 2.0f * g.vjk[d] + a_rjk * g.vjk[d] * inv_jk;
      d_center[d] -= d_vij + d_vik;
      atomicAdd(dpos + 3LL * j + d, d_vij - d_vjk);
      atomicAdd(dpos + 3LL * k + d, d_vik + d_vjk);
    }
  }
  for (int d = 0; d < 3; ++d) {
    float v = d_center[d];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) atomicAdd(dpos + 3LL * node + d, v);
  }
}

__global__ void __launch_bounds__(kWarps * 32) g4_jvp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ angles, const bool* __restrict__ mask,
    const float* __restrict__ dpos, float* __restrict__ out, int n_node,
    int n_angle, const __grid_constant__ AcsfG4Params p) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n_node) return;
  const int m = p.m;
  const int width = p.num_rel * m;
  float* row = rows + warp * width;
  for (int c = lane; c < width; c += 32) row[c] = 0.0f;
  int begin, end;
  warp_range(angles, 3, n_angle, node, lane, &begin, &end);
  __syncwarp();
  float pi[3], dpi[3];
  load3(pos, node, pi);
  load3(dpos, node, dpi);
  for (int a = begin + lane; a < end; a += 32) {
    if (!mask[a]) continue;
    const int j = __ldg(angles + 3LL * a + 1);
    const int k = __ldg(angles + 3LL * a + 2);
    Angle g;
    angle_geometry(pos, pi, j, k, &g);
    float dpj[3], dpk[3], dvij[3], dvik[3], dvjk[3];
    load3(dpos, j, dpj);
    load3(dpos, k, dpk);
    for (int d = 0; d < 3; ++d) {
      dvij[d] = dpj[d] - dpi[d];
      dvik[d] = dpk[d] - dpi[d];
      dvjk[d] = dpk[d] - dpj[d];
    }
    const float drij = dot3(g.vij, dvij) / g.rij;
    const float drik = dot3(g.vik, dvik) / g.rik;
    const float drjk = dot3(g.vjk, dvjk) / g.rjk;
    const float ds2 = 2.0f * (g.rij * drij + g.rik * drik + g.rjk * drjk);
    const float dcos = (dot3(dvij, g.vik) + dot3(g.vij, dvik)) / (g.rij * g.rik)
                       - g.cos * (drij / g.rij + drik / g.rik);
    AngleTables t;
    derivative_tables(p, g, &t);
    float* dst = row + g4_relation(p, __ldg(z + j), __ldg(z + k)) * m;
    for (int s = 0; s < m; ++s) {
      const int ue = p.eta_inv[s], uz = p.zl_inv[s], ur = p.rc_inv[s];
      const float ce = t.c[uz] * t.e[ue];
      const float d = t.dc[uz] * t.e[ue] * t.f[ur] * dcos
                      + t.c[uz] * t.de[ue] * t.f[ur] * ds2
                      + ce * (t.df_ij[ur] * drij + t.df_ik[ur] * drik
                              + t.df_jk[ur] * drjk);
      atomicAdd(dst + s, d * p.scale);
    }
  }
  __syncwarp();
  float* o = out + static_cast<long long>(node) * width;
  for (int c = lane; c < width; c += 32) o[c] = row[c];
}

__global__ void __launch_bounds__(kWarps * 32) g2_fwd_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const bool* __restrict__ mask, float* __restrict__ out, int n_node,
    int n_edge, const __grid_constant__ AcsfG2Params p) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n_node) return;
  const int m = p.m;
  const int width = p.num_rel * m;
  float* row = rows + warp * width;
  for (int c = lane; c < width; c += 32) row[c] = 0.0f;
  int begin, end;
  warp_range(receivers, 1, n_edge, node, lane, &begin, &end);
  __syncwarp();
  float pi[3];
  load3(pos, node, pi);
  for (int e = begin + lane; e < end; e += 32) {
    if (!mask[e]) continue;
    const int j = __ldg(senders + e);
    float pj[3], v[3];
    load3(pos, j, pj);
    for (int d = 0; d < 3; ++d) v[d] = pj[d] - pi[d];
    const float r = sqrtf(fmaxf(dot3(v, v), kEps));
    float* dst = row + p.slot_of_z[z_index(__ldg(z + j))] * m;
    for (int s = 0; s < m; ++s) {
      const float dr = r - p.rs[s];
      atomicAdd(dst + s, expf(-p.eta[s] * (dr * dr)) * cutoff(r, p.rc[s], p.pi_rc[s]));
    }
  }
  __syncwarp();
  float* o = out + static_cast<long long>(node) * width;
  for (int c = lane; c < width; c += 32) o[c] = row[c];
}

__global__ void __launch_bounds__(kWarps * 32) g2_vjp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const bool* __restrict__ mask, const float* __restrict__ ct,
    float* __restrict__ dpos, int n_node, int n_edge,
    const __grid_constant__ AcsfG2Params p) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n_node) return;
  const int m = p.m;
  const int width = p.num_rel * m;
  float* row = rows + warp * width;
  const float* ct_row = ct + static_cast<long long>(node) * width;
  for (int c = lane; c < width; c += 32) row[c] = __ldg(ct_row + c);
  int begin, end;
  warp_range(receivers, 1, n_edge, node, lane, &begin, &end);
  __syncwarp();
  if (begin == end) return;
  float pi[3];
  load3(pos, node, pi);
  float d_center[3] = {0.0f, 0.0f, 0.0f};
  for (int e = begin + lane; e < end; e += 32) {
    if (!mask[e]) continue;
    const int j = __ldg(senders + e);
    float pj[3], v[3];
    load3(pos, j, pj);
    for (int d = 0; d < 3; ++d) v[d] = pj[d] - pi[d];
    const float r = sqrtf(fmaxf(dot3(v, v), kEps));
    const float* ctr = row + p.slot_of_z[z_index(__ldg(z + j))] * m;
    float a_r = 0.0f;
    for (int s = 0; s < m; ++s) a_r += ctr[s] * g2_drep_dr(p, s, r);
    for (int d = 0; d < 3; ++d) {
      const float dv = a_r * v[d] / r;
      d_center[d] -= dv;
      atomicAdd(dpos + 3LL * j + d, dv);
    }
  }
  for (int d = 0; d < 3; ++d) {
    float v = d_center[d];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) atomicAdd(dpos + 3LL * node + d, v);
  }
}

__global__ void __launch_bounds__(kWarps * 32) g2_jvp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const bool* __restrict__ mask, const float* __restrict__ dpos,
    float* __restrict__ out, int n_node, int n_edge,
    const __grid_constant__ AcsfG2Params p) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int node = blockIdx.x * kWarps + warp;
  if (node >= n_node) return;
  const int m = p.m;
  const int width = p.num_rel * m;
  float* row = rows + warp * width;
  for (int c = lane; c < width; c += 32) row[c] = 0.0f;
  int begin, end;
  warp_range(receivers, 1, n_edge, node, lane, &begin, &end);
  __syncwarp();
  float pi[3], dpi[3];
  load3(pos, node, pi);
  load3(dpos, node, dpi);
  for (int e = begin + lane; e < end; e += 32) {
    if (!mask[e]) continue;
    const int j = __ldg(senders + e);
    float pj[3], dpj[3], v[3], dv[3];
    load3(pos, j, pj);
    load3(dpos, j, dpj);
    for (int d = 0; d < 3; ++d) {
      v[d] = pj[d] - pi[d];
      dv[d] = dpj[d] - dpi[d];
    }
    const float r = sqrtf(fmaxf(dot3(v, v), kEps));
    const float dr = dot3(v, dv) / r;
    float* dst = row + p.slot_of_z[z_index(__ldg(z + j))] * m;
    for (int s = 0; s < m; ++s) atomicAdd(dst + s, g2_drep_dr(p, s, r) * dr);
  }
  __syncwarp();
  float* o = out + static_cast<long long>(node) * width;
  for (int c = lane; c < width; c += 32) o[c] = row[c];
}

bool g4_params_ok(const AcsfG4Params* p) {
  return p->m > 0 && p->m <= kMaxSets && p->n_eta <= kMaxUniq
         && p->n_zl <= kMaxUniq && p->n_rc <= kMaxUniq
         && p->num_el <= kMaxElements && p->num_rel > 0
         && p->num_rel * p->m <= kMaxColumns;
}

bool g2_params_ok(const AcsfG2Params* p) {
  return p->m > 0 && p->m <= kMaxSets && p->num_rel > 0
         && p->num_rel * p->m <= kMaxColumns;
}

dim3 grid_for(int n_node) { return dim3((n_node + kWarps - 1) / kWarps); }

size_t shared_bytes(int width) { return sizeof(float) * kWarps * width; }

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for parameters outside the kernel's
// limits. The fwd and jvp outputs are (n_node, num_rel * m), every row
// written; the vjp outputs dpos (n_node, 3) must be zero on entry.

extern "C" int gcnn_acsf_g4_fwd_f32(const float* pos, const int* z,
                                    const int* angles, const bool* mask,
                                    float* out, int n_node, int n_angle,
                                    const AcsfG4Params* p, void* stream) {
  if (!g4_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  g4_fwd_kernel<<<grid_for(n_node), kWarps * 32, shared_bytes(p->num_rel * p->m),
                  static_cast<cudaStream_t>(stream)>>>(pos, z, angles, mask, out,
                                                       n_node, n_angle, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g4_vjp_f32(const float* pos, const int* z,
                                    const int* angles, const bool* mask,
                                    const float* ct, float* dpos, int n_node,
                                    int n_angle, const AcsfG4Params* p,
                                    void* stream) {
  if (!g4_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  g4_vjp_kernel<<<grid_for(n_node), kWarps * 32, shared_bytes(p->num_rel * p->m),
                  static_cast<cudaStream_t>(stream)>>>(pos, z, angles, mask, ct,
                                                       dpos, n_node, n_angle, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g4_jvp_f32(const float* pos, const int* z,
                                    const int* angles, const bool* mask,
                                    const float* dpos, float* out, int n_node,
                                    int n_angle, const AcsfG4Params* p,
                                    void* stream) {
  if (!g4_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  g4_jvp_kernel<<<grid_for(n_node), kWarps * 32, shared_bytes(p->num_rel * p->m),
                  static_cast<cudaStream_t>(stream)>>>(pos, z, angles, mask, dpos,
                                                       out, n_node, n_angle, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g2_fwd_f32(const float* pos, const int* z,
                                    const int* senders, const int* receivers,
                                    const bool* mask, float* out, int n_node,
                                    int n_edge, const AcsfG2Params* p,
                                    void* stream) {
  if (!g2_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  g2_fwd_kernel<<<grid_for(n_node), kWarps * 32, shared_bytes(p->num_rel * p->m),
                  static_cast<cudaStream_t>(stream)>>>(pos, z, senders, receivers,
                                                       mask, out, n_node, n_edge, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g2_vjp_f32(const float* pos, const int* z,
                                    const int* senders, const int* receivers,
                                    const bool* mask, const float* ct,
                                    float* dpos, int n_node, int n_edge,
                                    const AcsfG2Params* p, void* stream) {
  if (!g2_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  g2_vjp_kernel<<<grid_for(n_node), kWarps * 32, shared_bytes(p->num_rel * p->m),
                  static_cast<cudaStream_t>(stream)>>>(pos, z, senders, receivers,
                                                       mask, ct, dpos, n_node,
                                                       n_edge, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g2_jvp_f32(const float* pos, const int* z,
                                    const int* senders, const int* receivers,
                                    const bool* mask, const float* dpos,
                                    float* out, int n_node, int n_edge,
                                    const AcsfG2Params* p, void* stream) {
  if (!g2_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  g2_jvp_kernel<<<grid_for(n_node), kWarps * 32, shared_bytes(p->num_rel * p->m),
                  static_cast<cudaStream_t>(stream)>>>(pos, z, senders, receivers,
                                                       mask, dpos, out, n_node,
                                                       n_edge, *p);
  return static_cast<int>(cudaGetLastError());
}
