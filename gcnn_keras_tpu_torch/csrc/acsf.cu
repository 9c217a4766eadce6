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
// VPU. Here the function is kept and the layout dropped.
//
// G4 forward and tangent pass (g4_fwd_kernel, g4_jvp_kernel): rows owned by
// angle ranges, no search, no atomics, deterministic.
// - Block b (256 threads) takes the angles [224 b, 224 b + 224) and owns the
//   centres whose first angle lies there, and the centres without angles
//   between them (the last block also those after the last angle, to N).
//   The centre ids are angles[:, 0]; a block's rows are found from the ids
//   it loads anyway, so no search is needed. A row that runs past the range
//   is finished by its owner in further rounds of 256 angles (1482 angles
//   for a centre of a 40-atom cluster within r_c: the blocks it spans own
//   nothing).
// - A round: every thread computes one angle (skipped where masked) into
//   shared memory: its m set values (with the tangent pass, its m set
//   tangents along dpos; the geometry tangents of fused_g4.py:495-503). The
//   unique transcendentals stay in registers, in arrays sized at compile
//   time: exact counts for the HDNNP tables (2 eta, 4 (zeta, lambda), 1
//   r_c), else kMaxUniq (8) of each; each set picks its factors by compare
//   and select. r and 1/r come from one rsqrt, the cutoff and its
//   derivative from one __sincosf, the power from exp2(zeta __log2f(base)),
//   and dc = c zeta lambda / base.
// - Then each warp sums its own 32 angles (its slice), row by row: the
//   angles of each relation grouped by __match_any_sync, each (group, set)
//   pair summed by one lane in lane order. A row within the slice is
//   written out whole; the slice's first row, if it began before, and its
//   last, if it goes on, are kept in shared memory, and the warp of the
//   slice where such a row starts adds the slices' parts in slice order
//   (after the carried sum of a row from the last round), then writes the
//   row out or carries it into the next round.
// So every output row is written once, and every sum is taken in an order
// fixed by the input: the same inputs give the same bits from run to run.
//
// G4 force pass (g4_vjp_kernel): balanced by angles, no search, the shares
// summed in shared memory before any global write.
// - Block b (256 threads) takes the angles [256 b, 256 b + 256), one a
//   thread (skipped where masked). The thread reads its centre's cotangent
//   slice ct[i, rel*m : rel*m + m] (the rows of a run of angles with the same
//   centre are the same, so they stay in L1 and L2), contracts the m set
//   cotangents into the five geometry cotangents (cos, s2, r_ij, r_ik, r_jk)
//   with the unique transcendentals in registers (angle_sets' third pass),
//   and forms the shares of i, j and k in dpos.
// - The centre's share is summed over each run of lanes with the same
//   centre (the angles are sorted by centre), and j's over each run with
//   the same j (set_angle's order: j repeats over the centre's other
//   neighbours), by a segmented shuffle tree; k's stays per angle.
// - In a batch of molecules a block's angles touch a short range of node
//   ids (a molecule's nodes are contiguous): about 40 at the HDNNP2nd
//   serving batch. Where that range fits kVjpWindow (1024) nodes, the shares
//   are added into a window of dpos in shared memory (shared-memory
//   atomics), and the block then adds each nonzero coordinate of the window
//   to dpos with one global atomic. Where it does not (neighbours far apart
//   in id), the shares go to dpos with global atomics.
//
// G2 forward and tangent pass (g2_fwd_kernel, g2_jvp_kernel): one routine
// (g2_owned_rows<kJvp>), the G4 forward's owned rows over edges: no search,
// no atomics, deterministic.
// - Block b (256 threads) takes the edges [224 b, 224 b + 224) and owns the
//   receivers whose first edge lies there, and the receivers without edges
//   between them (the last block also those after the last edge, to N),
//   found from the receiver ids it loads anyway. It first zeroes its rows
//   without edges, a run of rows at a time.
// - A round: every thread computes one edge (skipped where masked) into
//   shared memory, its m set values and its sender's slot; in the tangent
//   pass it loads dpos of i and j beside their positions and writes the m
//   set tangents d rep_s / d r * (v . dv) / r instead, 1 / r from the same
//   rsqrt. Each row of the round has a head and a tail edge there; a
//   block-wide count of the heads numbers the rows and gives each its span of
//   edges. Then a thread per (row, column) sums the row's edges of its
//   column's slot, in edge order, and writes the column once (R*m = 20
//   columns at the HDNNP2nd tables). A row that goes on past the round is
//   carried in shared memory into the next round of 256 edges, in which its
//   owner finishes it (the star centre of chip_smoke.py's G2 layout cases
//   has three ranges' worth of edges).
//
// G2 force pass (g2_vjp_kernel): the G4 force pass's layout, over edges.
// Block b (256 threads) takes the edges [256 b, 256 b + 256), one a thread
// (skipped where masked). The thread reads its receiver's cotangent slice
// ct[i, slot*m : slot*m + m] (the same for a run of edges: L1), contracts it
// into one radial cotangent and forms the shares of i and j in dpos. The
// receiver's share is summed over each run of lanes with the same receiver
// (run_sum); then both shares go through the shared dpos window, or with
// global atomics where a block's edges join nodes further apart in id.
//
// The three G2 kernels take r and 1 / r from one rsqrt, the cutoff and
// its derivative from one __sincosf (cutoff_sin) for each run of sets with
// the same r_c (one an edge for the HDNNP tables), and one exp2f a set.
// exp2f is within 2 ulp of 2^x; the two products that form its argument x =
// -eta log2(e) (r - rs)^2 add at most about 1.2e-7 |x| relative (|x| <= 6.9
// at the HDNNP2nd tables for r < r_c: 8.6e-7).
//
// Masked rows (padding points at the dead node, i = j = k) are skipped, not
// multiplied by zero. dpos must be zero on entry to the force passes. Which
// sums use atomics: only the G2 and G4 force passes, which add through the
// shared window and to global memory in an order that varies from run to
// run: their results differ from run to run in the last bits (the run sums
// over lanes alone are taken in a fixed order). The G2 and G4 forward and
// tangent passes have no atomics: the same inputs give the same bits.
//
// Bound: at the HDNNP2nd serving shapes (N = 8192, A = 417024, R*m = 120 for
// G4; E = 54784, R*m = 20 for G2) the bytes dominate all six: each call
// must read its index rows and mask (5.4 MB for G4, 0.5 MB for G2) and
// write (or, in the force pass, read) the (N, R*m) descriptors once, and
// the tangent pass reads dpos besides (the force pass writes it): about 9.5
// MB, 2.8-2.9 us at 3.35 TB/s for G4, 1.3 MB, 0.4 us for G2. The
// special-function results the G4 function needs (an rsqrt per distance, an
// exp per unique eta, a log2 and an exp2 per unique (zeta, lambda) plus an
// exp2 for the derivative, a cos and in the force and tangent passes a sin
// per distance and unique r_c) number 16 an angle in the forward pass and
// 23 in the force and tangent passes: 1.6 and 2.3 us at 16 a clock per SM.
// The G4 fwd and jvp kernels wait on chains of shared-memory and global
// loads between their block barriers; the force passes on their per-row
// loads (receivers, then positions; senders, then atomic numbers, then the
// cotangent slice) and their atomics. The G2 kernels (245 blocks for the fwd
// and jvp kernels, 214 for the vjp kernel at that batch) are one chain of
// dependent loads long (the tangent pass loads dpos beside the positions),
// and their launch. Their
// times against these bounds, and the designs tried, are in PERF.md
// (probe_kernel_variants.py).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kMaxSets = 32;
constexpr int kMaxUniq = 8;
constexpr int kMaxElements = 16;
constexpr int kMaxZ = 96;
constexpr int kMaxColumns = 2048;
constexpr int kG4Threads = 256;  // G4 fwd and jvp: threads of a block, angles of a round
constexpr int kG4Warps = kG4Threads / 32;
constexpr int kValStride = kG4Threads + 1;  // a round's values of one set, padded
constexpr int kG4Range = 224;    // angles of a block's range
constexpr int kVjpWindow = 1024;  // G2, G4 vjp: nodes of a block's shared dpos window
constexpr int kG2Threads = 256;  // G2 fwd and vjp: threads of a block, edges of a round
constexpr int kG2Warps = kG2Threads / 32;
constexpr int kG2Stride = kG2Threads + 1;  // a round's values of one set, padded
constexpr int kG2Range = 224;    // G2 fwd: edges of a block's range
constexpr unsigned kFull = 0xffffffffu;
static_assert(kG4Range <= kG4Threads, "round 0 covers a block's range");
static_assert(kG2Range <= kG2Threads, "round 0 covers a block's range");
constexpr float kPi = 3.14159265358979323f;
constexpr float kInvPi = 0.318309886183790672f;
constexpr float kLog2e = 1.44269504088896341f;
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

__device__ __forceinline__ int z_index(int z) {
  return min(max(z, 0), kMaxZ - 1);
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

// ---------------------------------------------------------------- G4 angles

// fc = (cos(pi x) + 1) / 2 and s = sin(pi x) at x = r / rc, both 0 from x =
// 1 on (d fc / d r = -(pi / rc) s / 2). __sincosf on [0, pi] is within
// 2^-21.4 of both.
__device__ __forceinline__ void cutoff_sin(float x, float* fc, float* s) {
  float sn, cs;
  __sincosf(kPi * fminf(x, 1.0f), &sn, &cs);
  *fc = x < 1.0f ? 0.5f * (cs + 1.0f) : 0.0f;
  *s = x < 1.0f ? sn : 0.0f;
}

// t[u] for a runtime u < N, by compare and select (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&t)[N], int u) {
  float x = t[0];
#pragma unroll
  for (int q = 1; q < N; ++q) x = u == q ? t[q] : x;
  return x;
}

// what angle_sets computes for an angle: its set values (forward), its set
// tangents along dpos (tangent pass), or the shares of i, j and k in the
// position cotangent of its set cotangents (force pass)
enum G4Pass { kG4Fwd, kG4Jvp, kG4Vjp };

// Angle (i, j, k) of the G4 sums. kG4Fwd: its m set values, times the
// scale, into vals[s * kValStride]; kG4Jvp: its m set tangents along `extra`
// (dpos) there; kG4Vjp: from the m set cotangents of its row and relation in
// `extra` (ct), the five geometry cotangents (cos, s2, r_ij, r_ik, r_jk),
// then the shares of i, j and k in dpos into vals[0..2], [3..5], [6..8].
// Returns its relation (slot and pair_rel: p.slot_of_z and p.pair_rel in
// shared memory). The unique transcendentals of the angle stay in
// registers: NE, NZ and NR cover the unique counts of eta, (zeta, lambda)
// and r_c.
template <int kPass, int NE, int NZ, int NR>
__device__ __forceinline__ int angle_sets(const float* __restrict__ pos,
                                          const int* __restrict__ z, int i, int j, int k,
                                          const float* __restrict__ extra,
                                          const AcsfG4Params& p, const int* slot,
                                          const int* pair_rel, float* vals) {
  constexpr bool kJvp = kPass == kG4Jvp, kVjp = kPass == kG4Vjp;
  float pi[3], pj[3], pk[3];
  load3(pos, i, pi);
  load3(pos, j, pj);
  load3(pos, k, pk);
  // the force pass reads its cotangents by relation: found first
  int rel = 0;
  if constexpr (kVjp) {
    const int sj = slot[z_index(__ldg(z + j))], sk = slot[z_index(__ldg(z + k))];
    rel = sj < 0 || sk < 0 ? 0 : pair_rel[sj * p.num_el + sk];
  }
  // the geometry, with r = d2 rsqrt(d2) and 1 / r = rsqrt(d2)
  Angle g;
  for (int d = 0; d < 3; ++d) {
    g.vij[d] = pj[d] - pi[d];
    g.vik[d] = pk[d] - pi[d];
    g.vjk[d] = pk[d] - pj[d];
  }
  const float dij = fmaxf(dot3(g.vij, g.vij), kEps), dik = fmaxf(dot3(g.vik, g.vik), kEps);
  const float djk = fmaxf(dot3(g.vjk, g.vjk), kEps);
  const float inv_ij = rsqrtf(dij), inv_ik = rsqrtf(dik), inv_jk = rsqrtf(djk);
  g.rij = dij * inv_ij;
  g.rik = dik * inv_ik;
  g.rjk = djk * inv_jk;
  g.cos = dot3(g.vij, g.vik) * inv_ij * inv_ik;
  const float s2 = dij + dik + djk;
  // the tangents of the geometry (fused_g4.py:495-503)
  float drij = 0.0f, drik = 0.0f, drjk = 0.0f, ds2 = 0.0f, dcos = 0.0f;
  if (kJvp) {
    float dpi[3], dpj[3], dpk[3], dvij[3], dvik[3], dvjk[3];
    load3(extra, i, dpi);
    load3(extra, j, dpj);
    load3(extra, k, dpk);
    for (int d = 0; d < 3; ++d) {
      dvij[d] = dpj[d] - dpi[d];
      dvik[d] = dpk[d] - dpi[d];
      dvjk[d] = dpk[d] - dpj[d];
    }
    drij = dot3(g.vij, dvij) * inv_ij;
    drik = dot3(g.vik, dvik) * inv_ik;
    drjk = dot3(g.vjk, dvjk) * inv_jk;
    ds2 = 2.0f * (g.rij * drij + g.rik * drik + g.rjk * drjk);
    dcos = (dot3(dvij, g.vik) + dot3(g.vij, dvik)) * inv_ij * inv_ik
           - g.cos * (drij * inv_ij + drik * inv_ik);
  }
  // per unique value: e = exp(-eta s2), c = 2^(1-zeta) base^zeta, f the
  // cutoff product; with kJvp de, dc and df, each times its geometry
  // tangent; with kVjp de = d e / d s2, dc = d c / d cos, and df (d f / d
  // r_ij), df_ik and df_jk
  float e[NE], de[NE], c[NZ], dc[NZ], f[NR], df[NR], df_ik[NR], df_jk[NR];
#pragma unroll
  for (int u = 0; u < NE; ++u) {
    e[u] = de[u] = 0.0f;
    if (u < p.n_eta) {
      e[u] = expf(-p.eta[u] * s2);
      if (kJvp) de[u] = -p.eta[u] * e[u] * ds2;
      if (kVjp) de[u] = -p.eta[u] * e[u];
    }
  }
#pragma unroll
  for (int u = 0; u < NZ; ++u) {
    c[u] = dc[u] = 0.0f;
    if (u < p.n_zl) {
      const float raw = fmaf(g.cos, p.lam[u], 1.0f);
      const float base = fmaxf(raw, 1e-30f);
      // __log2f is within 2^-22 of log2 on [0.5, 2] (2 ulp elsewhere): c
      // within about 1e-6 of its value at zeta 8
      c[u] = p.pow2[u] * exp2f(p.zeta[u] * __log2f(base));
      // d c / d cos = c zeta lambda / base (base <= 2, so __fdividef is
      // exact to 2 ulp); zero on the clamped branch (exactly collinear)
      if (kJvp)
        dc[u] = raw > 1e-30f ? __fdividef(c[u] * (p.zeta[u] * p.lam[u]), base) * dcos : 0.0f;
      if (kVjp)
        dc[u] = raw > 1e-30f ? __fdividef(c[u] * (p.zeta[u] * p.lam[u]), base) : 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < NR; ++u) {
    f[u] = df[u] = df_ik[u] = df_jk[u] = 0.0f;
    if (u < p.n_rc) {
      const float w = p.pi_rc[u] * kInvPi;  // 1 / rc
      float fij, sij, fik, sik, fjk, sjk;
      cutoff_sin(g.rij * w, &fij, &sij);
      cutoff_sin(g.rik * w, &fik, &sik);
      cutoff_sin(g.rjk * w, &fjk, &sjk);
      f[u] = fij * fik * fjk;
      if (kJvp)
        df[u] = -0.5f * p.pi_rc[u]
                * (sij * drij * fik * fjk + fij * sik * drik * fjk + fij * fik * sjk * drjk);
      if (kVjp) {
        const float h = -0.5f * p.pi_rc[u];
        df[u] = h * sij * fik * fjk;
        df_ik[u] = h * fij * sik * fjk;
        df_jk[u] = h * fij * fik * sjk;
      }
    }
  }
  if constexpr (kVjp) {
    // the set cotangents contracted into the five geometry cotangents
    const float* ctr = extra + static_cast<long long>(i) * (p.num_rel * p.m) + rel * p.m;
    float a_cos = 0.0f, a_s2 = 0.0f, a_rij = 0.0f, a_rik = 0.0f, a_rjk = 0.0f;
    for (int s = 0; s < p.m; ++s) {
      const int ue = p.eta_inv[s], uz = p.zl_inv[s], ur = p.rc_inv[s];
      const float ct = __ldg(ctr + s), fs = pick(f, ur);
      const float ctc = ct * pick(c, uz), ctce = ctc * pick(e, ue);
      a_cos += ct * pick(dc, uz) * pick(e, ue) * fs;
      a_s2 += ctc * pick(de, ue) * fs;
      a_rij += ctce * pick(df, ur);
      a_rik += ctce * pick(df_ik, ur);
      a_rjk += ctce * pick(df_jk, ur);
    }
    // then the three difference vectors' cotangents, through cos (d cos /
    // d v_ij = v_ik / (r_ij r_ik) - cos v_ij / r_ij^2), s2 (2 v) and r (v / r)
    a_cos *= p.scale;
    const float a2 = 2.0f * a_s2 * p.scale;
    a_rij *= p.scale * inv_ij;
    a_rik *= p.scale * inv_ik;
    a_rjk *= p.scale * inv_jk;
    const float cross = inv_ij * inv_ik;
    const float cij = g.cos * inv_ij * inv_ij, cik = g.cos * inv_ik * inv_ik;
    for (int d = 0; d < 3; ++d) {
      const float d_vij = a_cos * (g.vik[d] * cross - g.vij[d] * cij) + (a2 + a_rij) * g.vij[d];
      const float d_vik = a_cos * (g.vij[d] * cross - g.vik[d] * cik) + (a2 + a_rik) * g.vik[d];
      const float d_vjk = (a2 + a_rjk) * g.vjk[d];
      vals[d] = -(d_vij + d_vik);
      vals[3 + d] = d_vij - d_vjk;
      vals[6 + d] = d_vik + d_vjk;
    }
  }
  if constexpr (!kVjp) {
    for (int s = 0; s < p.m; ++s) {
      const int ue = p.eta_inv[s], uz = p.zl_inv[s], ur = p.rc_inv[s];
      const float ce = pick(c, uz) * pick(e, ue);
      float v;
      if (kJvp)
        v = pick(f, ur) * (pick(dc, uz) * pick(e, ue) + pick(c, uz) * pick(de, ue))
            + ce * pick(df, ur);
      else
        v = ce * pick(f, ur);
      vals[s * kValStride] = v * p.scale;
    }
    const int sj = slot[z_index(__ldg(z + j))], sk = slot[z_index(__ldg(z + k))];
    rel = sj < 0 || sk < 0 ? 0 : pair_rel[sj * p.num_el + sk];
  }
  return rel;
}

// ---------------------------------------------------------------- G4 fwd and jvp
// Rows owned by angle ranges (see the header): block b takes the angles
// [b * kG4Range, + kG4Range) and owns the centres whose first angle lies
// there, and the centres without angles before them.

// a[first set bit of b], and that bit cleared; 0 when b is 0
__device__ __forceinline__ float take(const float* a, unsigned& b) {
  if (!b) return 0.0f;
  const float x = a[__ffs(b) - 1];
  b &= b - 1;
  return x;
}

// id (the centre or receiver) of angle or edge a if the block computes it,
// else -1: those of [ab0, ab1) after those of the row that began before ab0
// (id_before), and past ab1 those of the block's last row (id_last), if it
// began in the range
__device__ __forceinline__ int computed_id(int id, int a, int n_rows, int ab1, int id_before,
                                           int id_last) {
  if (a >= n_rows) return -1;
  return (a < ab1 ? id != id_before : id == id_last && id_last != id_before) ? id : -1;
}

// rows lo..hi-1 of out zeroed by one warp, or by warp w of kG4Warps warps
// (rows lo + w, lo + w + kG4Warps, ...)
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int lo, int hi, int width,
                                          int first, int step, int lane) {
  for (int r = lo + first; r < hi; r += step)
    for (int c = lane; c < width; c += 32) out[static_cast<long long>(r) * width + c] = 0.0f;
}

template <bool kJvp, int NE, int NZ, int NR>
__device__ __forceinline__ void g4_owned_rows(const float* __restrict__ pos,
                                              const int* __restrict__ z,
                                              const int* __restrict__ angles,
                                              const bool* __restrict__ mask,
                                              const float* __restrict__ dpos,
                                              float* __restrict__ out, int n_node, int n_angle,
                                              const AcsfG4Params& p) {
  extern __shared__ float smem[];
  __shared__ int sid[kG4Threads + 2];     // rows of angles base - 1 .. base + kG4Threads
                                          // that the block computes, else -1
  __shared__ int srel[kG4Threads];        // relation of each angle of a round, -1 if masked
  __shared__ int rid[kG4Threads + 1];     // ids of angles ab0 - 1 .. ab0 + kG4Threads - 1
  __shared__ int gkey[kG4Warps][32];      // a warp's groups: (ordinal of its row) * 256 + relation,
  __shared__ unsigned gmask[kG4Warps][32];  // and lanes
  __shared__ int ords[kG4Warps];          // rows of a warp's angles (its slice)
  __shared__ bool open_right[kG4Warps];   // the slice's last row goes on past it
  __shared__ int slot[kMaxZ];             // p.slot_of_z
  __shared__ int pair_rel[kMaxElements * kMaxElements];  // p.pair_rel
  const int m = p.m, width = p.num_rel * m;
  float* svals = smem;                         // m x kValStride set values of a round
  float* part = svals + m * kValStride;        // 2 rows a warp: its slice's first and last
  float* carry = part + 2 * kG4Warps * width;  // a row that runs into the next round, 2 x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the (group, set) pairs of a row: lane_g + per_pass k, set lane_s
  const int per_pass = 32 / m, lane_g = lane / m, lane_s = lane % m;
  const int ab0 = blockIdx.x * kG4Range, ab1 = min(ab0 + kG4Range, n_angle);
  const bool last = ab1 >= n_angle;
  for (int k = tid; k < kMaxZ; k += kG4Threads) slot[k] = p.slot_of_z[k];
  for (int k = tid; k < p.num_el * p.num_el; k += kG4Threads) pair_rel[k] = p.pair_rel[k];
  __syncthreads();  // the tables, before the first angle's relation
  const int id_before = ab0 > 0 ? __ldg(angles + 3LL * (ab0 - 1)) : -1;
  const int id_last = ab1 > ab0 ? __ldg(angles + 3LL * (ab1 - 1)) : -1;
  for (int base = ab0, round = 0;; base += kG4Threads, ++round) {
    // every thread computes one angle's m set values into shared memory
    const int a = base + tid;
    const int raw = a < n_angle ? __ldg(angles + 3LL * a) : -1;
    const int id = computed_id(raw, a, n_angle, ab1, id_before, id_last);
    sid[tid + 1] = id;
    if (round == 0) rid[tid + 1] = raw;
    if (round == 0 && tid == 0) rid[0] = id_before;
    if (tid == 0) sid[0] = round > 0 ? __ldg(angles + 3LL * (base - 1)) : -1;
    if (tid == kG4Threads - 1)
      sid[kG4Threads + 1] = computed_id(a + 1 < n_angle ? __ldg(angles + 3LL * (a + 1)) : -1,
                                        a + 1, n_angle, ab1, id_before, id_last);
    srel[tid] = id >= 0 && mask[a]
                    ? angle_sets<kJvp ? kG4Jvp : kG4Fwd, NE, NZ, NR>(
                          pos, z, raw, __ldg(angles + 3LL * a + 1), __ldg(angles + 3LL * a + 2),
                          dpos, p, slot, pair_rel, svals + tid)
                    : -1;
    __syncthreads();
    const bool more = sid[kG4Threads + 1] >= 0;
    if (round == 0) {
      // Rows without angles: those between the rows of angles a - 1 and a,
      // for a in [ab0, ab1), each run zeroed by the warp of a; in the last
      // block also those after the last angle, by every warp
      const int lo = ab0 + tid < ab1 ? rid[tid] + 1 : 0;
      const int hi = ab0 + tid < ab1 ? min(rid[tid + 1], n_node) : 0;
      for (unsigned runs = __ballot_sync(kFull, lo < hi); runs; runs &= runs - 1) {
        const int b = __ffs(runs) - 1;
        zero_rows(out, __shfl_sync(kFull, lo, b), __shfl_sync(kFull, hi, b), width, 0, 1, lane);
      }
      if (last) zero_rows(out, max(id_last, id_before) + 1, n_node, width, warp, kG4Warps, lane);
    }
    // Each warp sums its own 32 angles (its slice), row by row: the angles
    // of each relation grouped by __match_any_sync, each (group, set) pair
    // summed by one lane, in lane order (32 / m groups at a time). A row that lies within the slice
    // is written out; the slice's first row, if it began before the slice,
    // and its last, if it goes on past it, stay in part for the second step.
    const int t = warp * 32 + lane;
    const int row = sid[t + 1];
    const unsigned starts = __ballot_sync(kFull, row >= 0 && sid[t] != row);
    const bool open_left = sid[warp * 32 + 1] >= 0 && !(starts & 1u);
    const int n_rows = __popc(starts) + open_left;
    const int ord = __popc(starts & ((2u << lane) - 1)) - 1 + open_left;
    const int first_row = __shfl_sync(kFull, row, 0), last_row = __shfl_sync(kFull, row, 31);
    const bool goes_on = last_row >= 0 && sid[warp * 32 + 33] == last_row;
    const int key = row >= 0 && srel[t] >= 0 ? ord * 256 + srel[t] : -1;
    const unsigned grp = __match_any_sync(kFull, key);
    const bool leads = key >= 0 && lane == __ffs(grp) - 1;
    const unsigned leaders = __ballot_sync(kFull, leads);
    if (leads) {
      const int g = __popc(leaders & ((1u << lane) - 1));
      gkey[warp][g] = key;
      gmask[warp][g] = grp;
    }
    if (lane == 0) {
      ords[warp] = n_rows;
      open_right[warp] = goes_on;
    }
    __syncwarp();
    const int n_groups = __popc(leaders);
    for (int o = 0; o < n_rows; ++o) {
      float* buf = part + (2 * warp + (o > 0)) * width;
      for (int c = lane; c < width; c += 32) buf[c] = 0.0f;
      // this row's groups, g_lo .. g_hi - 1 in leader order
      const unsigned mine = __ballot_sync(kFull, lane < n_groups && gkey[warp][lane] >> 8 == o);
      const int g_lo = __ffs(mine) - 1, g_hi = g_lo + __popc(mine);
      __syncwarp();
      for (int g = g_lo + lane_g; lane_g < per_pass && g < g_hi; g += per_pass) {
        const float* v = svals + lane_s * kValStride + warp * 32;
        unsigned b = gmask[warp][g];
        float acc = 0.0f;
        while (b) {
          const float x0 = take(v, b), x1 = take(v, b), x2 = take(v, b), x3 = take(v, b);
          acc = acc + x0 + x1 + x2 + x3;
        }
        buf[(gkey[warp][g] & 255) * m + lane_s] = acc;
      }
      __syncwarp();
      if (!(o == 0 && open_left) && !(o == n_rows - 1 && goes_on)) {
        // the row lies within the slice: written out whole
        const unsigned lanes = __ballot_sync(kFull, row >= 0 && ord == o);
        const int r = __shfl_sync(kFull, row, __ffs(lanes) - 1);
        float* dst = out + static_cast<long long>(r) * width;
        if (r < n_node)
          for (int c = lane; c < width; c += 32) dst[c] = buf[c];
        __syncwarp();
      }
    }
    __syncthreads();
    // Rows across slices: the warp of the slice where a row starts (in this
    // round) adds its parts in slice order, after the carried sum of a row
    // that began in an earlier round (warp 0, slot 0); then carries the sum
    // into the next round, or writes the row out. No barrier follows: the
    // next round's first step writes none of what this step reads, and its
    // barrier comes before its warps write part.
    for (int pass = 0; pass < 2; ++pass) {
      int w0 = -1;
      if (pass == 0 && warp == 0 && open_left) w0 = 0;   // carried in
      if (pass == 1 && goes_on && n_rows > open_left) w0 = warp;
      if (w0 < 0) continue;
      const int r = pass == 0 ? first_row : last_row;
      const bool carried_in = pass == 0;
      // the row goes on past slice w: it is the slice's last row (its only
      // one past w0) and that goes on
      auto goes_past = [&](int w) {
        return open_right[w] && ((pass == 1 && w == w0) || ords[w] == 1);
      };
      int w1 = w0;
      while (w1 < kG4Warps - 1 && goes_past(w1)) ++w1;
      const bool carried_out = goes_past(w1);
      const float* prev = carry + ((round + 1) & 1) * width;
      float* dst = carried_out ? carry + (round & 1) * width
                   : r < n_node ? out + static_cast<long long>(r) * width : nullptr;
      for (int c = lane; c < width; c += 32) {
        float acc = carried_in ? prev[c] : 0.0f;
        for (int w = w0; w <= w1; ++w)
          acc += part[(2 * w + (w == w0 && pass == 1 && ords[w] > 1)) * width + c];
        if (dst) dst[c] = acc;
      }
    }
    if (!more) break;
  }
}

template <int NE, int NZ, int NR>
__global__ void __launch_bounds__(kG4Threads) g4_fwd_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ angles, const bool* __restrict__ mask,
    float* __restrict__ out, int n_node, int n_angle,
    const __grid_constant__ AcsfG4Params p) {
  g4_owned_rows<false, NE, NZ, NR>(pos, z, angles, mask, nullptr, out, n_node, n_angle, p);
}

template <int NE, int NZ, int NR>
__global__ void __launch_bounds__(kG4Threads) g4_jvp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ angles, const bool* __restrict__ mask,
    const float* __restrict__ dpos, float* __restrict__ out, int n_node,
    int n_angle, const __grid_constant__ AcsfG4Params p) {
  g4_owned_rows<true, NE, NZ, NR>(pos, z, angles, mask, dpos, out, n_node, n_angle, p);
}

// ---------------------------------------------------------------- G4 vjp
// Block b (kG4Threads threads) takes the angles [b * kG4Threads, + kG4Threads),
// one a thread; see the header.

// v summed over each run of lanes with equal keys (consecutive lanes), by a
// segmented shuffle tree in a fixed order; the run's first lane holds the
// sum. Returns whether this lane is a run's first.
__device__ __forceinline__ bool run_sum(int key, float* v) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);  // every lane takes part
  const bool head = lane == 0 || prev != key;
  const unsigned after = __ballot_sync(kFull, head) & ~((2u << lane) - 1u);
  const int end = after ? __ffs(after) - 1 : 32;  // the next run's first lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float o = __shfl_down_sync(kFull, v[d], off);
      if (lane + off < end) v[d] += o;
    }
  }
  return head;
}

__device__ __forceinline__ void add3(float* dst, const float* v) {
  atomicAdd(dst, v[0]);
  atomicAdd(dst + 1, v[1]);
  atomicAdd(dst + 2, v[2]);
}

// The force passes' dpos window: the shares of a block's rows added into
// dpos of nodes span[0] .. span[0] + kVjpWindow - 1 in shared memory, then
// each nonzero coordinate added to dpos with one global atomic.

// win (3 kVjpWindow floats) zeroed and span emptied by the block's
// `threads` threads; a barrier follows
__device__ __forceinline__ void window_clear(float* win, int* span, int threads) {
  for (int t = threadIdx.x; t < 3 * kVjpWindow; t += threads) win[t] = 0.0f;
  if (threadIdx.x == 0) {
    span[0] = INT_MAX;
    span[1] = -1;
  }
}

// the lowest and highest node of a warp's live rows (lo, hi; INT_MAX and -1
// where a lane has none) folded into span
__device__ __forceinline__ void window_span(int lo, int hi, int* span) {
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if ((threadIdx.x & 31) == 0 && hi >= 0) {
    atomicMin(span, lo);
    atomicMax(span + 1, hi);
  }
}

// each nonzero coordinate of the window's nodes b_lo .. b_hi added to dpos
__device__ __forceinline__ void window_flush(const float* win, int b_lo, int b_hi,
                                             float* __restrict__ dpos, int threads) {
  float* out = dpos + 3LL * b_lo;
  for (int t = threadIdx.x; t < 3 * (b_hi - b_lo + 1); t += threads) {
    const float v = win[t];
    if (v != 0.0f) atomicAdd(out + t, v);
  }
}

template <int NE, int NZ, int NR>
__global__ void __launch_bounds__(kG4Threads) g4_vjp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ angles, const bool* __restrict__ mask,
    const float* __restrict__ ct, float* __restrict__ dpos, int n_angle,
    const __grid_constant__ AcsfG4Params p) {
  __shared__ float win[3 * kVjpWindow];  // dpos of nodes span[0] .. span[0] + kVjpWindow - 1
  __shared__ int span[2];                 // the lowest and highest node the block's angles touch
  __shared__ int slot[kMaxZ];             // p.slot_of_z
  __shared__ int pair_rel[kMaxElements * kMaxElements];  // p.pair_rel
  const int tid = threadIdx.x;
  window_clear(win, span, kG4Threads);
  for (int t = tid; t < kMaxZ; t += kG4Threads) slot[t] = p.slot_of_z[t];
  for (int t = tid; t < p.num_el * p.num_el; t += kG4Threads) pair_rel[t] = p.pair_rel[t];
  __syncthreads();
  // each thread the shares of its angle's i, j and k (none where masked)
  const int a = blockIdx.x * kG4Threads + tid;
  const bool live = a < n_angle && mask[a];
  int i = -1, j = -1, k = -1;
  float sh[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    i = __ldg(angles + 3LL * a);
    j = __ldg(angles + 3LL * a + 1);
    k = __ldg(angles + 3LL * a + 2);
    angle_sets<kG4Vjp, NE, NZ, NR>(pos, z, i, j, k, ct, p, slot, pair_rel, sh);
  }
  window_span(live ? min(i, min(j, k)) : INT_MAX, live ? max(i, max(j, k)) : -1, span);
  // the angles are sorted by centre, and j repeats over consecutive angles:
  // one share of each run of lanes with the same i, and with the same j
  const bool head_i = run_sum(i, sh);
  const bool head_j = run_sum(j, sh + 3);
  __syncthreads();
  const int b_lo = span[0], b_hi = span[1];
  if (b_hi < 0) return;  // no live angle in the block
  if (b_hi - b_lo < kVjpWindow) {
    // the block's nodes fit the window: shares added there, then one global
    // add for each coordinate of each node that got one
    if (live) {
      if (head_i) add3(win + 3 * (i - b_lo), sh);
      if (head_j) add3(win + 3 * (j - b_lo), sh + 3);
      add3(win + 3 * (k - b_lo), sh + 6);
    }
    __syncthreads();
    window_flush(win, b_lo, b_hi, dpos, kG4Threads);
  } else if (live) {
    // neighbours far apart in id: shares added to dpos
    if (head_i) add3(dpos + 3LL * i, sh);
    if (head_j) add3(dpos + 3LL * j, sh + 3);
    add3(dpos + 3LL * k, sh + 6);
  }
}

// ---------------------------------------------------------------- G2 edges

// edge e's receiver i, sender j and mask (-1, -1 and false past the last
// edge), loaded together and ahead of what waits on them (the G2 fwd
// kernel's zeroing of rows without edges, the vjp kernel's window)
struct EdgeIds {
  int i, j;
  bool live;
};

__device__ __forceinline__ EdgeIds edge_ids(const int* __restrict__ senders,
                                            const int* __restrict__ receivers,
                                            const bool* __restrict__ mask, int e, int n_edge) {
  EdgeIds x = {-1, -1, false};
  if (e < n_edge) {
    x.i = __ldg(receivers + e);
    x.j = __ldg(senders + e);
    x.live = mask[e];
  }
  return x;
}

// Edge i <- j of the G2 sums: v = p_j - p_i, and r and 1 / r from one rsqrt
struct Edge {
  float v[3];
  float r, inv;
};

__device__ __forceinline__ Edge edge_geometry(const float* __restrict__ pos, int i, int j) {
  float pi[3], pj[3];
  load3(pos, i, pi);
  load3(pos, j, pj);
  Edge g;
  for (int d = 0; d < 3; ++d) g.v[d] = pj[d] - pi[d];
  const float d2 = fmaxf(dot3(g.v, g.v), kEps);
  g.inv = rsqrtf(d2);
  g.r = d2 * g.inv;
  return g;
}

// f(s, g, dr, fc, sn) for each G2 set s at distance r: dr = r - rs_s, g =
// exp(-eta_s dr^2), fc = fc(r; rc_s) and sn = sin(pi r / rc_s) (d fc / d r =
// -(pi / rc_s) sn / 2). The cutoff is computed once for each run of sets
// with the same r_c.
template <typename F>
__device__ __forceinline__ void g2_sets(const AcsfG2Params& p, float r, F f) {
  float fc = 0.0f, sn = 0.0f;
#pragma unroll 4
  for (int s = 0; s < p.m; ++s) {
    if (s == 0 || p.rc[s] != p.rc[s - 1]) cutoff_sin(r * (p.pi_rc[s] * kInvPi), &fc, &sn);
    const float dr = r - p.rs[s];
    f(s, exp2f(-(p.eta[s] * kLog2e) * (dr * dr)), dr, fc, sn);
  }
}

// ---------------------------------------------------------------- G2 fwd and jvp
// Rows owned by edge ranges (see the header): block b takes the edges
// [b * kG2Range, + kG2Range) and owns the receivers whose first edge lies
// there, and the receivers without edges before them.

template <bool kJvp>
__device__ __forceinline__ void g2_owned_rows(const float* __restrict__ pos,
                                              const int* __restrict__ z,
                                              const int* __restrict__ senders,
                                              const int* __restrict__ receivers,
                                              const bool* __restrict__ mask,
                                              const float* __restrict__ dpos,
                                              float* __restrict__ out, int n_node, int n_edge,
                                              const AcsfG2Params& p) {
  extern __shared__ float smem[];
  __shared__ int srel[kG2Threads];       // sender slot of each edge of a round, -1 if skipped
  __shared__ int row_id[kG2Threads];     // the rows of a round, in order: their ids,
  __shared__ int row_begin[kG2Threads];  // first edges
  __shared__ int row_end[kG2Threads];    // and ends
  __shared__ int heads[kG2Warps];        // rows that start in each warp's edges
  const int m = p.m, width = p.num_rel * m;
  float* vals = smem;                     // m x kG2Stride set values of a round
  float* carry = vals + m * kG2Stride;    // a row that goes on into the next round, 2 x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ab0 = blockIdx.x * kG2Range, ab1 = min(ab0 + kG2Range, n_edge);
  const int id_before = ab0 > 0 ? __ldg(receivers + ab0 - 1) : -1;
  const int id_last = ab1 > ab0 ? __ldg(receivers + ab1 - 1) : -1;
  int e = ab0 + tid;
  EdgeIds x = edge_ids(senders, receivers, mask, e, n_edge);  // round 0's edge
  {
    // Rows without edges: those between the rows of edges e - 1 and e, for
    // e in [ab0, ab1), each run zeroed by the warp of e; in the last block
    // also those after the last edge
    int lo = 0, hi = 0;
    if (e < ab1) {
      lo = (e > ab0 ? __ldg(receivers + e - 1) : id_before) + 1;
      hi = min(x.i, n_node);
    }
    for (unsigned runs = __ballot_sync(kFull, lo < hi); runs; runs &= runs - 1) {
      const int b = __ffs(runs) - 1;
      const long long q1 = 1LL * __shfl_sync(kFull, hi, b) * width;
      for (long long q = 1LL * __shfl_sync(kFull, lo, b) * width + lane; q < q1; q += 32)
        out[q] = 0.0f;
    }
    if (ab1 >= n_edge)
      for (long long q = (max(id_last, id_before) + 1LL) * width + tid; q < 1LL * n_node * width;
           q += kG2Threads)
        out[q] = 0.0f;
  }
  for (int base = ab0, round = 0;; ++round) {
    // The round's rows: each has a head edge (the round's first, or where the
    // row starts) and a tail edge (the round's last, or where it ends). The
    // heads, counted over the block, number the rows in order.
    const int id = computed_id(x.i, e, n_edge, ab1, id_before, id_last);
    int prev = __shfl_up_sync(kFull, id, 1), next = __shfl_down_sync(kFull, id, 1);
    if (lane == 0 && tid > 0)
      prev = computed_id(e - 1 < n_edge ? __ldg(receivers + e - 1) : -1, e - 1, n_edge, ab1,
                         id_before, id_last);
    if (lane == 31 && tid < kG2Threads - 1)
      next = computed_id(e + 1 < n_edge ? __ldg(receivers + e + 1) : -1, e + 1, n_edge, ab1,
                         id_before, id_last);
    const int nb = base + kG2Threads;  // the next round's first edge
    const bool more = computed_id(nb < n_edge ? __ldg(receivers + nb) : -1, nb, n_edge, ab1,
                                  id_before, id_last) >= 0;
    // every thread computes one edge's m set values (kJvp: their tangents
    // along dpos) into shared memory
    int rel = -1;
    if (id >= 0 && x.live) {
      const Edge g = edge_geometry(pos, id, x.j);
      rel = p.slot_of_z[z_index(__ldg(z + x.j))];
      if constexpr (kJvp) {
        // the tangent of r, tr = (v . dv) / r with dv = dpos_j - dpos_i, times
        // d rep_s / d r = g (d fc / d r - 2 eta_s dr fc)
        float dpi[3], dpj[3];
        load3(dpos, id, dpi);
        load3(dpos, x.j, dpj);
        const float tr = ((dpj[0] - dpi[0]) * g.v[0] + (dpj[1] - dpi[1]) * g.v[1]
                          + (dpj[2] - dpi[2]) * g.v[2]) * g.inv;
        g2_sets(p, g.r, [&](int s, float gs, float dr, float fc, float sn) {
          vals[s * kG2Stride + tid] =
              gs * (-0.5f * p.pi_rc[s] * sn - 2.0f * p.eta[s] * dr * fc) * tr;
        });
      } else {
        g2_sets(p, g.r, [&](int s, float gs, float, float fc, float) {
          vals[s * kG2Stride + tid] = gs * fc;
        });
      }
    }
    srel[tid] = rel;
    const bool head = id >= 0 && (tid == 0 || prev != id);
    const bool tail = id >= 0 && (tid == kG2Threads - 1 || next != id);
    const unsigned hb = __ballot_sync(kFull, head);
    if (lane == 0) heads[warp] = __popc(hb);
    __syncthreads();
    int ord = __popc(hb & ((2u << lane) - 1)) - 1, n_rows = 0;
    for (int w = 0; w < kG2Warps; ++w) {
      if (w < warp) ord += heads[w];
      n_rows += heads[w];
    }
    if (head) {
      row_id[ord] = id;
      row_begin[ord] = tid;
    }
    if (tail) row_end[ord] = tid + 1;
    __syncthreads();
    // A thread per (row, column) sums the row's edges of the column's slot in
    // edge order, after the carried sum of a row that began in an earlier
    // round (the round's first row, after round 0); then carries the sum
    // into the next round (the round's last row, if it goes on) or writes
    // the column out
    const float* carried_in = carry + ((round + 1) & 1) * width;
    float* carried_out = carry + (round & 1) * width;
    for (int q = tid; q < n_rows * width; q += kG2Threads) {
      const int o = q / width, c = q - o * width, rel_c = c / m, s = c - rel_c * m;
      float acc = o == 0 && round > 0 ? carried_in[c] : 0.0f;
      for (int k = row_begin[o]; k < row_end[o]; ++k)
        if (srel[k] == rel_c) acc += vals[s * kG2Stride + k];
      if (o == n_rows - 1 && more) carried_out[c] = acc;
      else if (row_id[o] < n_node) out[static_cast<long long>(row_id[o]) * width + c] = acc;
    }
    if (!more) break;
    base = nb;
    e = base + tid;
    x = edge_ids(senders, receivers, mask, e, n_edge);
    __syncthreads();  // before the next round writes what this one read
  }
}

__global__ void __launch_bounds__(kG2Threads) g2_fwd_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const bool* __restrict__ mask, float* __restrict__ out, int n_node,
    int n_edge, const __grid_constant__ AcsfG2Params p) {
  g2_owned_rows<false>(pos, z, senders, receivers, mask, nullptr, out, n_node, n_edge, p);
}

__global__ void __launch_bounds__(kG2Threads) g2_jvp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const bool* __restrict__ mask, const float* __restrict__ dpos,
    float* __restrict__ out, int n_node, int n_edge,
    const __grid_constant__ AcsfG2Params p) {
  g2_owned_rows<true>(pos, z, senders, receivers, mask, dpos, out, n_node, n_edge, p);
}

// ---------------------------------------------------------------- G2 vjp
// Block b (kG2Threads threads) takes the edges [b * kG2Threads, + kG2Threads),
// one a thread; see the header.

__global__ void __launch_bounds__(kG2Threads) g2_vjp_kernel(
    const float* __restrict__ pos, const int* __restrict__ z,
    const int* __restrict__ senders, const int* __restrict__ receivers,
    const bool* __restrict__ mask, const float* __restrict__ ct,
    float* __restrict__ dpos, int n_edge, const __grid_constant__ AcsfG2Params p) {
  __shared__ float win[3 * kVjpWindow];  // dpos of nodes span[0] .. span[0] + kVjpWindow - 1
  __shared__ int span[2];                 // the lowest and highest node the block's edges touch
  const EdgeIds x = edge_ids(senders, receivers, mask, blockIdx.x * kG2Threads + threadIdx.x,
                             n_edge);
  window_clear(win, span, kG2Threads);
  __syncthreads();
  // each thread the shares of its edge's receiver i and sender j (none where
  // masked)
  const bool live = x.live;
  const int i = live ? x.i : -1, j = live ? x.j : -1;
  float sh_i[3] = {0.0f, 0.0f, 0.0f}, sh_j[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const Edge g = edge_geometry(pos, i, j);
    // the set cotangents of the row and the sender's slot, contracted into
    // the radial cotangent: d rep_s / d r = g (d fc / d r - 2 eta_s dr fc)
    const float* ctr = ct + static_cast<long long>(i) * (p.num_rel * p.m)
                       + p.slot_of_z[z_index(__ldg(z + j))] * p.m;
    float a_r = 0.0f;
    g2_sets(p, g.r, [&](int s, float gs, float dr, float fc, float sn) {
      a_r += __ldg(ctr + s) * gs * (-0.5f * p.pi_rc[s] * sn - 2.0f * p.eta[s] * dr * fc);
    });
    a_r *= g.inv;
    for (int d = 0; d < 3; ++d) {
      sh_j[d] = a_r * g.v[d];
      sh_i[d] = -sh_j[d];
    }
  }
  window_span(live ? min(i, j) : INT_MAX, live ? max(i, j) : -1, span);
  // the edges are sorted by receiver: one share of each run of lanes with
  // the same i
  const bool head_i = run_sum(i, sh_i);
  __syncthreads();
  const int b_lo = span[0], b_hi = span[1];
  if (b_hi < 0) return;  // no live edge in the block
  if (b_hi - b_lo < kVjpWindow) {
    if (live) {
      if (head_i) add3(win + 3 * (i - b_lo), sh_i);
      add3(win + 3 * (j - b_lo), sh_j);
    }
    __syncthreads();
    window_flush(win, b_lo, b_hi, dpos, kG2Threads);
  } else if (live) {
    // neighbours far apart in id: shares added to dpos
    if (head_i) add3(dpos + 3LL * i, sh_i);
    add3(dpos + 3LL * j, sh_j);
  }
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

// the G4 kernels' register tables: exact for the unique counts of the
// HDNNP tables (2 eta, 4 (zeta, lambda), 1 r_c), else kMaxUniq of each.
// Exact counts take 22% (fwd) and 50% (jvp) off the kMaxUniq instance's
// time at the HDNNP2nd serving batch (PERF.md)
bool g4_hdnnp_counts(const AcsfG4Params* p) {
  return p->n_eta == 2 && p->n_zl == 4 && p->n_rc == 1;
}

// one launch with `bytes` of dynamic shared memory (above 48 KB once the
// kernel's limit is raised)
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int threads, int bytes, void* stream, Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// one launch of a G4 fwd or jvp kernel: a block for each kG4Range angles
// (one for none, which zeroes every row); shared memory for the set values
// of a round and kG4Warps + 2 rows
template <typename Kernel, typename... Args>
int launch_g4(Kernel kernel, const AcsfG4Params* p, int n_angle, void* stream, Args... args) {
  const int bytes = static_cast<int>(
      sizeof(float) * (p->m * kValStride + (2 * kG4Warps + 2) * p->num_rel * p->m));
  const int grid = std::max(1, (n_angle + kG4Range - 1) / kG4Range);
  return launch(kernel, grid, kG4Threads, bytes, stream, args..., *p);
}

// one launch of the G2 fwd or jvp kernel: a block for each kG2Range edges
// (one for none, which zeroes every row); shared memory for the set values
// of a round and 2 carried rows
template <typename Kernel, typename... Args>
int launch_g2(Kernel kernel, const AcsfG2Params* p, int n_edge, void* stream, Args... args) {
  const int bytes = static_cast<int>(sizeof(float) * (p->m * kG2Stride + 2 * p->num_rel * p->m));
  const int grid = std::max(1, (n_edge + kG2Range - 1) / kG2Range);
  return launch(kernel, grid, kG2Threads, bytes, stream, args..., *p);
}

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
  if (g4_hdnnp_counts(p))
    return launch_g4(g4_fwd_kernel<2, 4, 1>, p, n_angle, stream, pos, z, angles, mask, out,
                     n_node, n_angle);
  return launch_g4(g4_fwd_kernel<kMaxUniq, kMaxUniq, kMaxUniq>, p, n_angle, stream, pos, z,
                   angles, mask, out, n_node, n_angle);
}

extern "C" int gcnn_acsf_g4_vjp_f32(const float* pos, const int* z,
                                    const int* angles, const bool* mask,
                                    const float* ct, float* dpos, int n_node,
                                    int n_angle, const AcsfG4Params* p,
                                    void* stream) {
  if (!g4_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0 || n_angle <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n_angle + kG4Threads - 1) / kG4Threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g4_hdnnp_counts(p))
    g4_vjp_kernel<2, 4, 1><<<grid, kG4Threads, 0, s>>>(pos, z, angles, mask, ct, dpos, n_angle,
                                                       *p);
  else
    g4_vjp_kernel<kMaxUniq, kMaxUniq, kMaxUniq><<<grid, kG4Threads, 0, s>>>(
        pos, z, angles, mask, ct, dpos, n_angle, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g4_jvp_f32(const float* pos, const int* z,
                                    const int* angles, const bool* mask,
                                    const float* dpos, float* out, int n_node,
                                    int n_angle, const AcsfG4Params* p,
                                    void* stream) {
  if (!g4_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  if (g4_hdnnp_counts(p))
    return launch_g4(g4_jvp_kernel<2, 4, 1>, p, n_angle, stream, pos, z, angles, mask, dpos,
                     out, n_node, n_angle);
  return launch_g4(g4_jvp_kernel<kMaxUniq, kMaxUniq, kMaxUniq>, p, n_angle, stream, pos, z,
                   angles, mask, dpos, out, n_node, n_angle);
}

// angles of a G4 fwd or jvp block's range (kG4Range), for callers that lay
// out inputs by block
extern "C" int gcnn_acsf_g4_range() { return kG4Range; }

// edges of a G2 fwd block's range (kG2Range)
extern "C" int gcnn_acsf_g2_range() { return kG2Range; }

// nodes of a G2 or G4 vjp block's shared window (kVjpWindow): a block whose
// edges or angles touch a wider range of node ids adds to dpos directly
extern "C" int gcnn_acsf_vjp_window() { return kVjpWindow; }

extern "C" int gcnn_acsf_g2_fwd_f32(const float* pos, const int* z,
                                    const int* senders, const int* receivers,
                                    const bool* mask, float* out, int n_node,
                                    int n_edge, const AcsfG2Params* p,
                                    void* stream) {
  if (!g2_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  return launch_g2(g2_fwd_kernel, p, n_edge, stream, pos, z, senders, receivers, mask, out,
                   n_node, n_edge);
}

extern "C" int gcnn_acsf_g2_vjp_f32(const float* pos, const int* z,
                                    const int* senders, const int* receivers,
                                    const bool* mask, const float* ct,
                                    float* dpos, int n_node, int n_edge,
                                    const AcsfG2Params* p, void* stream) {
  if (!g2_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0 || n_edge <= 0) return static_cast<int>(cudaSuccess);
  g2_vjp_kernel<<<(n_edge + kG2Threads - 1) / kG2Threads, kG2Threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(pos, z, senders, receivers, mask, ct,
                                                       dpos, n_edge, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gcnn_acsf_g2_jvp_f32(const float* pos, const int* z,
                                    const int* senders, const int* receivers,
                                    const bool* mask, const float* dpos,
                                    float* out, int n_node, int n_edge,
                                    const AcsfG2Params* p, void* stream) {
  if (!g2_params_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node <= 0) return static_cast<int>(cudaSuccess);
  return launch_g2(g2_jvp_kernel, p, n_edge, stream, pos, z, senders, receivers, mask, dpos,
                   out, n_node, n_edge);
}
