"""ACSF G2 and G4 descriptors: the hand-written CUDA kernels, their plain
versions and their autograd Functions; counterpart of
``gcnn_keras_tpu/ops/pallas/fused_g4.py``.

Six kernels (``csrc/acsf.cu``) replace the six TPU kernels that energy and
force serving and force training run:

- ``g4_fwd``  (``_g4_fwd``):  pos -> G4 (N, R*m) over centre-sorted angles;
- ``g4_vjp``  (``_g4_vjp``):  ct (N, R*m) -> dpos (N, 3), the force pass;
- ``g4_jvp``  (``_g4_jvp``):  dpos (N, 3) -> dG (N, R*m), the force loss's
  second reverse pass;
- ``g2_fwd``  (``_g2_fwd``):  pos -> G2 (N, R*m) over receiver-sorted edges;
- ``g2_vjp``  (``_g2_vjp``):  ct -> dpos;
- ``g2_jvp``  (``_g2_jvp``):  dpos -> dG.

Column ``rel * m + s`` of the output holds set ``s`` of relation ``rel``:
the sender's element slot for G2, the (j, k) element pair for G4. The
relation is that of the JAX package's unfused layers, which is what it
computes off the TPU: an atomic number outside ``elements`` gives slot 0
in G2 and pair relation 0 in G4, and ordered pairs (``keep_pair_order``)
take relation ``slot_k * n_el + slot_j``.

``G4Fn``/``G2Fn`` run the fwd kernel; their backward is ``G4VjpFn``/
``G2VjpFn`` (the vjp kernel), whose backward is ``G4JvpFn``/``G2JvpFn`` (the
jvp kernel), whose backward is the ``*VjpFn`` again: the pair is linear in
its tensor argument and differentiable to any order in it, the counterpart
of the JAX package's ``custom_jvp`` + ``linear_call(jvp_fn, vjp_fn)``.
Positions are a constant of the pair, as ``linear_call``'s residual is: the
derivative of the force pass along positions (a position Hessian) is not
computed, and asking for it raises ``NotImplementedError``; derivatives
along everything else (a force loss's parameter gradients) work.

Forward mode (``training/fast_force_step.py``) takes the JAX package's
``custom_jvp``: the tangent of ``G*Fn`` along positions is ``G*JvpFn`` (the
jvp kernel) on the position tangent, and each of the pair is linear in its
tensor argument, so its tangent is itself on that argument's tangent. A
tangent on the pair's positions raises, as its backward does.

A CPU tensor takes the plain version (the closed forms of
``_rep_coeffs``/``_dv_from_coeffs``, ``_drep_rows`` and ``_g2_drep_dr``, not
autograd); a CUDA tensor launches the kernel or raises. ``launches[name]``
counts the launches of each kernel and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .build import load_library

Tensor = torch.Tensor

KERNELS = ("g2_fwd", "g4_fwd", "g4_vjp", "g2_vjp", "g4_jvp", "g2_jvp")
launches = dict.fromkeys(KERNELS, 0)

# limits of the kernels' own design (csrc/acsf.cu): per-set and unique-value
# tables live in the launch parameters, and output rows in shared memory
# (the G2 fwd and jvp kernels two carried and a round's set values; the G4
# fwd and jvp kernels two a warp, two carried and a round's set values; the
# vjp kernels read their cotangent rows from global memory)
MAX_SETS = 32
MAX_UNIQ = 8
MAX_ELEMENTS = 16
MAX_Z = 96
MAX_COLUMNS = 2048
EPS = 1e-12


# ------------------------------------------------------------ static tables

class G4Static(NamedTuple):
    """The shared G4 parameter grid factored into unique values."""
    uniq_eta: tuple          # Ue floats
    uniq_zl: tuple           # Uzl (zeta, lambda) float pairs
    uniq_rc: tuple           # Urc floats
    eta_inv: tuple           # m ints -> Ue index
    zl_inv: tuple            # m ints -> Uzl index
    rc_inv: tuple            # m ints -> Urc index
    elements: tuple          # atomic numbers of the element slots
    keep_pair_order: bool
    num_rel: int             # R (pair relations)
    scale: float             # 1/multiplicity (or 1.0)


def make_static(table: np.ndarray, elements: Sequence[int],
                keep_pair_order: bool, multiplicity) -> G4Static:
    """Factor the (R[, T], m, 4) grid table into unique static values.
    Requires the grid to be identical for every pair slot (the
    ``make_param_table`` construction)."""
    table = np.asarray(table, dtype=np.float32)
    grid = table.reshape(-1, table.shape[-2], 4)
    if not bool(np.all(grid == grid[0:1])):
        raise ValueError("G4 kernels need a shared (grid-constant) parameter table")
    g0 = grid[0]
    uniq_eta, eta_inv = np.unique(g0[:, 0], return_inverse=True)
    uniq_zl, zl_inv = np.unique(g0[:, 1:3], axis=0, return_inverse=True)
    uniq_rc, rc_inv = np.unique(g0[:, 3], return_inverse=True)
    num_el = len(elements)
    num_rel = num_el * num_el if keep_pair_order else num_el * (num_el + 1) // 2
    return G4Static(
        uniq_eta=tuple(float(v) for v in uniq_eta),
        uniq_zl=tuple((float(a), float(b)) for a, b in uniq_zl),
        uniq_rc=tuple(float(v) for v in uniq_rc),
        eta_inv=tuple(int(v) for v in np.ravel(eta_inv)),
        zl_inv=tuple(int(v) for v in np.ravel(zl_inv)),
        rc_inv=tuple(int(v) for v in np.ravel(rc_inv)),
        elements=tuple(int(z) for z in np.asarray(elements)),
        keep_pair_order=bool(keep_pair_order),
        num_rel=int(num_rel),
        scale=1.0 / float(multiplicity) if multiplicity else 1.0)


class G2Static(NamedTuple):
    sets: tuple              # m (eta, rs, rc) float triples
    elements: tuple          # atomic numbers of the element slots
    num_rel: int             # = len(elements)


def make_static_g2(table: np.ndarray, elements) -> G2Static:
    """Factor the (R, m, 3) shared grid table into static per-set values.
    Requires the same grid for every element slot (``make_param_table``)."""
    table = np.asarray(table, dtype=np.float32)
    if table.ndim != 3:
        raise ValueError("G2 kernels need a shared (R, m, 3) table")
    if not bool(np.all(table == table[0:1])):
        raise ValueError("G2 kernels need a shared grid-constant parameter table")
    return G2Static(
        sets=tuple((float(a), float(b), float(c)) for a, b, c in table[0]),
        elements=tuple(int(z) for z in np.asarray(elements)),
        num_rel=int(table.shape[0]))


def slot_of_z(elements: Sequence[int]) -> np.ndarray:
    """(MAX_Z,) element slot of each atomic number, -1 for one that is not
    an element; atomic numbers are clipped to [0, MAX_Z) first."""
    table = np.full(MAX_Z, -1, dtype=np.int32)
    for idx, z in enumerate(elements):
        table[int(z)] = idx
    return table


def pair_relation_table(num_el: int, keep_pair_order: bool) -> np.ndarray:
    """(num_el, num_el) G4 relation of the element slot pair (slot_j, slot_k),
    as the unfused layer's ``_pair_maps`` assigns it: unordered pairs
    (a <= b) in row-major order, ordered pairs as ``slot_k * n + slot_j``."""
    a = np.arange(num_el)[:, None]
    b = np.arange(num_el)[None, :]
    if keep_pair_order:
        return (b * num_el + a).astype(np.int32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return (lo * num_el - lo * (lo - 1) // 2 + (hi - lo)).astype(np.int32)


def _slots(z: Tensor, elements: Sequence[int]) -> Tensor:
    table = torch.as_tensor(slot_of_z(elements), device=z.device)
    return table[z.long().clamp(0, MAX_Z - 1)]


def g2_relation(z: Tensor, st: G2Static) -> Tensor:
    """Element slot of each atomic number, 0 for an unknown element."""
    return _slots(z, st.elements).clamp_min(0)


def g4_relation(zj: Tensor, zk: Tensor, st: G4Static) -> Tensor:
    """Pair relation of (zj, zk); 0 when either is not an element."""
    sj, sk = _slots(zj, st.elements), _slots(zk, st.elements)
    n = len(st.elements)
    table = torch.as_tensor(pair_relation_table(n, st.keep_pair_order),
                            device=zj.device).reshape(-1)
    known = (sj >= 0) & (sk >= 0)
    rel = table[(sj.clamp_min(0) * n + sk.clamp_min(0))]
    return torch.where(known, rel, torch.zeros_like(rel))


# ------------------------------------------------------------ plain versions

def _cutoff(r: Tensor, rc, pi_rc) -> Tensor:
    return 0.5 * (torch.cos(torch.clamp(r, -rc, rc) * pi_rc) + 1.0)


def _cutoff_d(r: Tensor, rc, pi_rc) -> Tensor:
    """d f_c / d r with the clip semantics (zero outside [-rc, rc])."""
    inside = (r.abs() <= rc).to(r.dtype)
    return -0.5 * pi_rc * torch.sin(r * pi_rc) * inside


def _dist(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=EPS))


def _g4_geometry(pos: Tensor, angles: Tensor):
    i, j, k = angles.long().unbind(1)
    pi, pj, pk = pos[i], pos[j], pos[k]
    vij, vik, vjk = pj - pi, pk - pi, pk - pj
    rij, rik, rjk = _dist(vij), _dist(vik), _dist(vjk)
    cos = (vij * vik).sum(-1) / rij / rik
    return i, j, k, vij, vik, vjk, rij, rik, rjk, cos


def _consts(st: G4Static, ref: Tensor):
    def t(v):
        return torch.tensor(v, dtype=ref.dtype, device=ref.device)
    zeta = [z for z, _ in st.uniq_zl]
    return dict(
        eta=t(st.uniq_eta), zeta=t(zeta), lam=t([l for _, l in st.uniq_zl]),
        pow2=t([2.0 ** (1.0 - z) for z in zeta]), rc=t(st.uniq_rc),
        pi_rc=t([math.pi / rc for rc in st.uniq_rc]),
        eta_inv=torch.tensor(st.eta_inv, device=ref.device),
        zl_inv=torch.tensor(st.zl_inv, device=ref.device),
        rc_inv=torch.tensor(st.rc_inv, device=ref.device))


def _g4_tables(st: G4Static, rij, rik, rjk, cos, with_derivs: bool):
    """Per-angle unique transcendental tables, (A, U) each."""
    k = _consts(st, rij)
    s2 = (rij * rij + rik * rik + rjk * rjk)[:, None]
    e = torch.exp(-k["eta"] * s2)
    raw = cos[:, None] * k["lam"] + 1.0
    base = torch.clamp(raw, min=1e-30)
    c = k["pow2"] * torch.pow(base, k["zeta"])
    rc, pi_rc = k["rc"], k["pi_rc"]
    fij, fik, fjk = (_cutoff(r[:, None], rc, pi_rc) for r in (rij, rik, rjk))
    tabs = dict(k=k, e=e, c=c, f=fij * fik * fjk)
    if with_derivs:
        # zero derivative on the clamped branch (exactly collinear angles)
        live = (raw > 1e-30).to(cos.dtype)
        tabs.update(
            de=-k["eta"] * e,
            dc=k["pow2"] * k["zeta"] * k["lam"] * torch.pow(base, k["zeta"] - 1.0) * live,
            df_ij=_cutoff_d(rij[:, None], rc, pi_rc) * fik * fjk,
            df_ik=fij * _cutoff_d(rik[:, None], rc, pi_rc) * fjk,
            df_jk=fij * fik * _cutoff_d(rjk[:, None], rc, pi_rc))
    return tabs


def g4_forward_plain(pos: Tensor, z: Tensor, angles: Tensor, angle_mask: Tensor,
                     st: G4Static) -> Tensor:
    """The G4 fwd kernel's plain PyTorch version: (N, R*m)."""
    n, m = pos.shape[0], len(st.eta_inv)
    i, j, k, _, _, _, rij, rik, rjk, cos = _g4_geometry(pos, angles)
    tabs = _g4_tables(st, rij, rik, rjk, cos, with_derivs=False)
    kk = tabs["k"]
    rep = (tabs["c"][:, kk["zl_inv"]] * tabs["e"][:, kk["eta_inv"]]
           * tabs["f"][:, kk["rc_inv"]] * st.scale)
    rep = rep * angle_mask[:, None].to(rep.dtype)
    rel = g4_relation(z[j], z[k], st)
    out = torch.zeros(n * st.num_rel, m, dtype=pos.dtype, device=pos.device)
    return out.index_add_(0, i * st.num_rel + rel, rep).reshape(n, st.num_rel * m)


def g4_vjp_plain(pos: Tensor, z: Tensor, angles: Tensor, angle_mask: Tensor,
                 ct: Tensor, st: G4Static) -> Tensor:
    """The G4 vjp kernel's plain PyTorch version: ct (N, R*m) -> dpos (N, 3),
    in closed form."""
    n, m = pos.shape[0], len(st.eta_inv)
    i, j, k, vij, vik, vjk, rij, rik, rjk, cos = _g4_geometry(pos, angles)
    tabs = _g4_tables(st, rij, rik, rjk, cos, with_derivs=True)
    kk = tabs["k"]
    rel = g4_relation(z[j], z[k], st)
    ctr = ct.reshape(n, st.num_rel, m)[i, rel] * st.scale
    ctr = ctr * angle_mask[:, None].to(ctr.dtype)
    zl, et, rc = kk["zl_inv"], kk["eta_inv"], kk["rc_inv"]
    c, e, f = tabs["c"][:, zl], tabs["e"][:, et], tabs["f"][:, rc]
    ce = ctr * c * e
    a_cos = (ctr * tabs["dc"][:, zl] * e * f).sum(1)[:, None]
    a_s2 = (ctr * c * tabs["de"][:, et] * f).sum(1)[:, None]
    a_rij = (ce * tabs["df_ij"][:, rc]).sum(1)[:, None]
    a_rik = (ce * tabs["df_ik"][:, rc]).sum(1)[:, None]
    a_rjk = (ce * tabs["df_jk"][:, rc]).sum(1)[:, None]
    inv_ij, inv_ik, inv_jk = (1.0 / r[:, None] for r in (rij, rik, rjk))
    cos = cos[:, None]
    d_vij = (a_cos * (vik * (inv_ij * inv_ik) - vij * (cos * inv_ij * inv_ij))
             + a_s2 * 2.0 * vij + a_rij * vij * inv_ij)
    d_vik = (a_cos * (vij * (inv_ij * inv_ik) - vik * (cos * inv_ik * inv_ik))
             + a_s2 * 2.0 * vik + a_rik * vik * inv_ik)
    d_vjk = a_s2 * 2.0 * vjk + a_rjk * vjk * inv_jk
    dpos = torch.zeros(n, 3, dtype=pos.dtype, device=pos.device)
    dpos.index_add_(0, i, -(d_vij + d_vik))
    dpos.index_add_(0, j, d_vij - d_vjk)
    return dpos.index_add_(0, k, d_vik + d_vjk)


def g4_jvp_plain(pos: Tensor, z: Tensor, angles: Tensor, angle_mask: Tensor,
                 dpos: Tensor, st: G4Static) -> Tensor:
    """The G4 jvp kernel's plain PyTorch version: dpos (N, 3) -> dG (N, R*m),
    the tangents of the per-set terms (``_drep_rows``) pooled as the forward
    pools the terms."""
    n, m = pos.shape[0], len(st.eta_inv)
    i, j, k, vij, vik, vjk, rij, rik, rjk, cos = _g4_geometry(pos, angles)
    dvij, dvik, dvjk = dpos[j] - dpos[i], dpos[k] - dpos[i], dpos[k] - dpos[j]
    drij = (vij * dvij).sum(-1) / rij
    drik = (vik * dvik).sum(-1) / rik
    drjk = (vjk * dvjk).sum(-1) / rjk
    ds2 = 2.0 * (rij * drij + rik * drik + rjk * drjk)
    dcos = (((dvij * vik).sum(-1) + (vij * dvik).sum(-1)) / (rij * rik)
            - cos * (drij / rij + drik / rik))
    tabs = _g4_tables(st, rij, rik, rjk, cos, with_derivs=True)
    kk = tabs["k"]
    zl, et, rc = kk["zl_inv"], kk["eta_inv"], kk["rc_inv"]
    c, e, f = tabs["c"][:, zl], tabs["e"][:, et], tabs["f"][:, rc]
    drep = (tabs["dc"][:, zl] * e * f * dcos[:, None]
            + c * tabs["de"][:, et] * f * ds2[:, None]
            + c * e * (tabs["df_ij"][:, rc] * drij[:, None]
                       + tabs["df_ik"][:, rc] * drik[:, None]
                       + tabs["df_jk"][:, rc] * drjk[:, None])) * st.scale
    drep = drep * angle_mask[:, None].to(drep.dtype)
    rel = g4_relation(z[j], z[k], st)
    out = torch.zeros(n * st.num_rel, m, dtype=pos.dtype, device=pos.device)
    return out.index_add_(0, i * st.num_rel + rel, drep).reshape(n, st.num_rel * m)


def _g2_geometry(pos: Tensor, senders: Tensor, receivers: Tensor):
    recv, send = receivers.long(), senders.long()
    vij = pos[send] - pos[recv]
    return recv, send, vij, _dist(vij)


def _g2_consts(st: G2Static, ref: Tensor):
    def t(col):
        return torch.tensor([s[col] for s in st.sets], dtype=ref.dtype,
                            device=ref.device)
    rc = t(2)
    return t(0), t(1), rc, torch.tensor([math.pi / s[2] for s in st.sets],
                                        dtype=ref.dtype, device=ref.device)


def g2_forward_plain(pos: Tensor, z: Tensor, senders: Tensor, receivers: Tensor,
                     edge_mask: Tensor, st: G2Static) -> Tensor:
    """The G2 fwd kernel's plain PyTorch version: (N, R*m)."""
    n, m = pos.shape[0], len(st.sets)
    recv, send, _, r = _g2_geometry(pos, senders, receivers)
    eta, rs, rc, pi_rc = _g2_consts(st, pos)
    r = r[:, None]
    rep = torch.exp(-eta * (r - rs) ** 2) * _cutoff(r, rc, pi_rc)
    rep = rep * edge_mask[:, None].to(rep.dtype)
    rel = g2_relation(z[send], st)
    out = torch.zeros(n * st.num_rel, m, dtype=pos.dtype, device=pos.device)
    return out.index_add_(0, recv * st.num_rel + rel, rep).reshape(n, st.num_rel * m)


def _g2_drep_dr(st: G2Static, r: Tensor) -> Tensor:
    """(E, m) d rep_s / d r at the distances ``r`` (E, 1)."""
    eta, rs, rc, pi_rc = _g2_consts(st, r)
    g = torch.exp(-eta * (r - rs) ** 2)
    return -2.0 * eta * (r - rs) * g * _cutoff(r, rc, pi_rc) + g * _cutoff_d(r, rc, pi_rc)


def g2_vjp_plain(pos: Tensor, z: Tensor, senders: Tensor, receivers: Tensor,
                 edge_mask: Tensor, ct: Tensor, st: G2Static) -> Tensor:
    """The G2 vjp kernel's plain PyTorch version: ct -> dpos (N, 3)."""
    n, m = pos.shape[0], len(st.sets)
    recv, send, vij, r = _g2_geometry(pos, senders, receivers)
    r = r[:, None]
    ctr = ct.reshape(n, st.num_rel, m)[recv, g2_relation(z[send], st)]
    ctr = ctr * edge_mask[:, None].to(ctr.dtype)
    d = (ctr * _g2_drep_dr(st, r)).sum(1)[:, None] * vij / r
    dpos = torch.zeros(n, 3, dtype=pos.dtype, device=pos.device)
    dpos.index_add_(0, recv, -d)
    return dpos.index_add_(0, send, d)


def g2_jvp_plain(pos: Tensor, z: Tensor, senders: Tensor, receivers: Tensor,
                 edge_mask: Tensor, dpos: Tensor, st: G2Static) -> Tensor:
    """The G2 jvp kernel's plain PyTorch version: dpos (N, 3) -> dG (N, R*m),
    ``d rep_s / d r * dr`` pooled as the forward pools ``rep_s``."""
    n, m = pos.shape[0], len(st.sets)
    recv, send, vij, r = _g2_geometry(pos, senders, receivers)
    dr = ((vij * (dpos[send] - dpos[recv])).sum(-1) / r)[:, None]
    drep = _g2_drep_dr(st, r[:, None]) * dr
    drep = drep * edge_mask[:, None].to(drep.dtype)
    rel = g2_relation(z[send], st)
    out = torch.zeros(n * st.num_rel, m, dtype=pos.dtype, device=pos.device)
    return out.index_add_(0, recv * st.num_rel + rel, drep).reshape(n, st.num_rel * m)


# ------------------------------------------------------------ kernels

class _G4Params(ctypes.Structure):
    """``AcsfG4Params`` of ``csrc/acsf.cu``, field for field."""
    _fields_ = [("m", ctypes.c_int), ("n_eta", ctypes.c_int), ("n_zl", ctypes.c_int),
                ("n_rc", ctypes.c_int), ("num_rel", ctypes.c_int),
                ("num_el", ctypes.c_int), ("scale", ctypes.c_float),
                ("eta", ctypes.c_float * MAX_UNIQ), ("zeta", ctypes.c_float * MAX_UNIQ),
                ("lam", ctypes.c_float * MAX_UNIQ), ("pow2", ctypes.c_float * MAX_UNIQ),
                ("rc", ctypes.c_float * MAX_UNIQ), ("pi_rc", ctypes.c_float * MAX_UNIQ),
                ("eta_inv", ctypes.c_int * MAX_SETS), ("zl_inv", ctypes.c_int * MAX_SETS),
                ("rc_inv", ctypes.c_int * MAX_SETS), ("slot_of_z", ctypes.c_int * MAX_Z),
                ("pair_rel", ctypes.c_int * (MAX_ELEMENTS * MAX_ELEMENTS))]


class _G2Params(ctypes.Structure):
    """``AcsfG2Params`` of ``csrc/acsf.cu``, field for field."""
    _fields_ = [("m", ctypes.c_int), ("num_rel", ctypes.c_int),
                ("eta", ctypes.c_float * MAX_SETS), ("rs", ctypes.c_float * MAX_SETS),
                ("rc", ctypes.c_float * MAX_SETS), ("pi_rc", ctypes.c_float * MAX_SETS),
                ("slot_of_z", ctypes.c_int * MAX_Z)]


def g4_kernel_limits(st: G4Static) -> list:
    """What keeps ``st`` off the G4 kernels; empty when they take it."""
    m = len(st.eta_inv)
    reasons = []
    if m > MAX_SETS:
        reasons.append(f"m={m} > {MAX_SETS} sets")
    if max(len(st.uniq_eta), len(st.uniq_zl), len(st.uniq_rc)) > MAX_UNIQ:
        reasons.append(f"more than {MAX_UNIQ} unique eta, (zeta, lambda) or rc values")
    if len(st.elements) > MAX_ELEMENTS:
        reasons.append(f"{len(st.elements)} > {MAX_ELEMENTS} elements")
    if any(not 0 <= z < MAX_Z for z in st.elements):
        reasons.append(f"an element outside atomic numbers 0..{MAX_Z - 1}")
    if st.num_rel * m > MAX_COLUMNS:
        reasons.append(f"R*m={st.num_rel * m} > {MAX_COLUMNS}")
    return reasons


def g2_kernel_limits(st: G2Static) -> list:
    """What keeps ``st`` off the G2 kernels; empty when they take it."""
    m = len(st.sets)
    reasons = []
    if m > MAX_SETS:
        reasons.append(f"m={m} > {MAX_SETS} sets")
    if any(not 0 <= z < MAX_Z for z in st.elements):
        reasons.append(f"an element outside atomic numbers 0..{MAX_Z - 1}")
    if st.num_rel * m > MAX_COLUMNS:
        reasons.append(f"R*m={st.num_rel * m} > {MAX_COLUMNS}")
    return reasons


@functools.lru_cache(maxsize=None)
def _g4_params(st: G4Static) -> _G4Params:
    reasons = g4_kernel_limits(st)
    if reasons:
        raise ValueError("G4 kernels cannot take this table: " + "; ".join(reasons))
    zeta = [zt for zt, _ in st.uniq_zl]
    p = _G4Params(m=len(st.eta_inv), n_eta=len(st.uniq_eta), n_zl=len(st.uniq_zl),
                  n_rc=len(st.uniq_rc), num_rel=st.num_rel, num_el=len(st.elements),
                  scale=st.scale)
    for name, vals in (("eta", st.uniq_eta), ("zeta", zeta),
                       ("lam", [la for _, la in st.uniq_zl]),
                       ("pow2", [2.0 ** (1.0 - zt) for zt in zeta]),
                       ("rc", st.uniq_rc), ("pi_rc", [math.pi / rc for rc in st.uniq_rc]),
                       ("eta_inv", st.eta_inv), ("zl_inv", st.zl_inv),
                       ("rc_inv", st.rc_inv), ("slot_of_z", slot_of_z(st.elements)),
                       ("pair_rel", pair_relation_table(
                           len(st.elements), st.keep_pair_order).ravel())):
        getattr(p, name)[:len(vals)] = [v.item() if hasattr(v, "item") else v
                                        for v in vals]
    return p


@functools.lru_cache(maxsize=None)
def _g2_params(st: G2Static) -> _G2Params:
    reasons = g2_kernel_limits(st)
    if reasons:
        raise ValueError("G2 kernels cannot take this table: " + "; ".join(reasons))
    p = _G2Params(m=len(st.sets), num_rel=st.num_rel)
    slots = np.maximum(slot_of_z(st.elements), 0)  # unknown element -> slot 0
    for name, vals in (("eta", [s[0] for s in st.sets]), ("rs", [s[1] for s in st.sets]),
                       ("rc", [s[2] for s in st.sets]),
                       ("pi_rc", [math.pi / s[2] for s in st.sets]),
                       ("slot_of_z", [int(v) for v in slots])):
        getattr(p, name)[:len(vals)] = vals
    return p


_SIGNATURES = {
    # pos, z, index rows, mask, [ct or dpos,] out, n_node, n_rows, params, stream
    "g4_fwd": 4, "g4_vjp": 5, "g4_jvp": 5, "g2_fwd": 5, "g2_vjp": 6, "g2_jvp": 6,
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``gcnn_acsf_<name>_f32`` of ``csrc/acsf.cu``, built
    and loaded on first use."""
    fn = getattr(load_library("acsf"), f"gcnn_acsf_{name}_f32")
    params = _G4Params if name.startswith("g4") else _G2Params
    fn.argtypes = ([ctypes.c_void_p] * (_SIGNATURES[name] + 1)
                   + [ctypes.c_int, ctypes.c_int, ctypes.POINTER(params),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def g4_range() -> int:
    """Angles of a block's range in the G4 fwd and jvp kernels (``kG4Range``
    of ``csrc/acsf.cu``), read from the loaded library."""
    return int(load_library("acsf").gcnn_acsf_g4_range())


def g2_range() -> int:
    """Edges of a block's range in the G2 fwd kernel (``kG2Range`` of
    ``csrc/acsf.cu``), read from the loaded library."""
    return int(load_library("acsf").gcnn_acsf_g2_range())


def vjp_window() -> int:
    """Nodes of the G2 and G4 vjp kernels' shared window (``kVjpWindow`` of
    ``csrc/acsf.cu``), read from the loaded library: a block whose edges or
    angles touch a wider range of node ids adds its shares to dpos
    directly."""
    return int(load_library("acsf").gcnn_acsf_vjp_window())


def _check(pos: Tensor, z: Tensor, rows, mask: Tensor, width: int, ct=None,
           dpos=None) -> None:
    """Shapes and devices; ``rows`` is ``(angles,)`` (A, 3) or ``(senders,
    receivers)`` (E,) each, ``ct`` is (N, width) and ``dpos`` (N, 3)."""
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {tuple(pos.shape)}")
    if z.shape != pos.shape[:1]:
        raise ValueError(f"z must be ({pos.shape[0]},), got {tuple(z.shape)}")
    for t in (z, *rows, mask) + tuple(t for t in (ct, dpos) if t is not None):
        if t.device != pos.device:
            raise ValueError(f"inputs on {t.device} and {pos.device}")
    n_rows = rows[0].shape[0]
    shapes = [(n_rows, 3)] if len(rows) == 1 else [(n_rows,), (n_rows,)]
    if [tuple(r.shape) for r in rows] != shapes:
        raise ValueError(f"index rows must be {shapes}, got "
                         f"{[tuple(r.shape) for r in rows]}")
    if mask.shape != (n_rows,):
        raise ValueError(f"mask must be ({n_rows},), got {tuple(mask.shape)}")
    if ct is not None and tuple(ct.shape) != (pos.shape[0], width):
        raise ValueError(f"ct must be ({pos.shape[0]}, {width}), got {tuple(ct.shape)}")
    if dpos is not None and dpos.shape != pos.shape:
        raise ValueError(f"dpos must be {tuple(pos.shape)}, got {tuple(dpos.shape)}")


def _width(st) -> int:
    """R*m, the width of the descriptor rows."""
    return st.num_rel * (len(st.eta_inv) if isinstance(st, G4Static) else len(st.sets))


def _launch(name: str, st, pos: Tensor, z: Tensor, ints, mask: Tensor,
            extra=None) -> Tensor:
    """Launch kernel ``name`` on the card; ``extra`` is the cotangent (vjp)
    or the position tangent (jvp). Returns the kernel's output."""
    if pos.device.type != "cuda":
        raise ValueError(f"no ACSF kernel for device {pos.device}")
    if pos.dtype != torch.float32 or (extra is not None and extra.dtype != torch.float32):
        raise TypeError("the ACSF kernels take float32 positions, cotangents and tangents")
    if z.dtype != torch.int32 or any(t.dtype != torch.int32 for t in ints):
        raise TypeError("the ACSF kernels take int32 atomic numbers and indices")
    if mask.dtype != torch.bool:
        raise TypeError(f"the mask must be bool, got {mask.dtype}")
    tensors = (pos, z, *ints, mask) + (() if extra is None else (extra,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the ACSF kernels take contiguous tensors")
    params = _g4_params(st) if name.startswith("g4") else _g2_params(st)
    n = pos.shape[0]
    if name.endswith("vjp"):  # the kernel adds onto dpos
        out = torch.zeros(n, 3, dtype=torch.float32, device=pos.device)
    else:  # the kernel writes every row
        out = torch.empty(n, _width(st), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    fn = _entry(name)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), n,
                ints[0].shape[0], ctypes.byref(params), stream)
    if rc != 0:
        raise RuntimeError(f"ACSF {name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return out


def g4_forward(pos: Tensor, z: Tensor, angles: Tensor, angle_mask: Tensor,
               st: G4Static) -> Tensor:
    """G4 descriptors (N, R*m) over CENTRE-SORTED angles (A, 3); masked
    angles contribute nothing."""
    _check(pos, z, (angles,), angle_mask, _width(st))
    if pos.device.type == "cpu":
        return g4_forward_plain(pos, z, angles, angle_mask, st)
    return _launch("g4_fwd", st, pos, z, (angles,), angle_mask)


def g4_vjp(pos: Tensor, z: Tensor, angles: Tensor, angle_mask: Tensor,
           ct: Tensor, st: G4Static) -> Tensor:
    """Cotangent (N, R*m) of :func:`g4_forward` -> position cotangent (N, 3)."""
    _check(pos, z, (angles,), angle_mask, _width(st), ct)
    if pos.device.type == "cpu":
        return g4_vjp_plain(pos, z, angles, angle_mask, ct, st)
    return _launch("g4_vjp", st, pos, z, (angles,), angle_mask, ct)


def g4_jvp(pos: Tensor, z: Tensor, angles: Tensor, angle_mask: Tensor,
           dpos: Tensor, st: G4Static) -> Tensor:
    """Position tangent (N, 3) -> tangent (N, R*m) of :func:`g4_forward`."""
    _check(pos, z, (angles,), angle_mask, _width(st), dpos=dpos)
    if pos.device.type == "cpu":
        return g4_jvp_plain(pos, z, angles, angle_mask, dpos, st)
    return _launch("g4_jvp", st, pos, z, (angles,), angle_mask, dpos)


def g2_forward(pos: Tensor, z: Tensor, senders: Tensor, receivers: Tensor,
               edge_mask: Tensor, st: G2Static) -> Tensor:
    """G2 descriptors (N, R*m) over RECEIVER-SORTED edges; masked edges
    contribute nothing."""
    _check(pos, z, (senders, receivers), edge_mask, _width(st))
    if pos.device.type == "cpu":
        return g2_forward_plain(pos, z, senders, receivers, edge_mask, st)
    return _launch("g2_fwd", st, pos, z, (senders, receivers), edge_mask)


def g2_vjp(pos: Tensor, z: Tensor, senders: Tensor, receivers: Tensor,
           edge_mask: Tensor, ct: Tensor, st: G2Static) -> Tensor:
    """Cotangent (N, R*m) of :func:`g2_forward` -> position cotangent (N, 3)."""
    _check(pos, z, (senders, receivers), edge_mask, _width(st), ct)
    if pos.device.type == "cpu":
        return g2_vjp_plain(pos, z, senders, receivers, edge_mask, ct, st)
    return _launch("g2_vjp", st, pos, z, (senders, receivers), edge_mask, ct)


def g2_jvp(pos: Tensor, z: Tensor, senders: Tensor, receivers: Tensor,
           edge_mask: Tensor, dpos: Tensor, st: G2Static) -> Tensor:
    """Position tangent (N, 3) -> tangent (N, R*m) of :func:`g2_forward`."""
    _check(pos, z, (senders, receivers), edge_mask, _width(st), dpos=dpos)
    if pos.device.type == "cpu":
        return g2_jvp_plain(pos, z, senders, receivers, edge_mask, dpos, st)
    return _launch("g2_jvp", st, pos, z, (senders, receivers), edge_mask, dpos)


# ------------------------------------------------------------ autograd
#
# G*Fn: pos -> G, backward G*VjpFn.
# G*VjpFn: ct -> dpos, linear in ct, backward G*JvpFn.
# G*JvpFn: dpos -> dG, linear in dpos, backward G*VjpFn.
#
# Each Function of the pair takes ``pos`` as an input so that its backward
# can mark positions constant again, and returns no gradient for it: the
# derivative along positions is what ``_held_constant`` refuses. In forward
# mode G*Fn's jvp is G*JvpFn on the position tangent; the pair's jvp is the
# Function itself on its first argument's tangent and raises on a tangent
# along positions (``_linear_jvp``).

_POSITION_HESSIAN = (
    "the ACSF kernels' autograd Functions hold positions constant, as the JAX "
    "package's linear_call holds its residual: the derivative of the force pass "
    "(or of its transpose) along positions, a position Hessian, is not computed. "
    "Ask for gradients along parameters only (torch.autograd.grad(loss, "
    "parameters)), or build the ACSF layer with fused=False")


class _PositionsHeldConstant(torch.autograd.Function):
    """A zero on ``pos`` whose backward raises ``NotImplementedError``; its
    tangent is zero."""

    @staticmethod
    def forward(ctx, pos):
        return pos.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_POSITION_HESSIAN)

    @staticmethod
    def jvp(ctx, dpos):
        return dpos.new_zeros(())


def _forward_saves(ctx, pos, *rest) -> None:
    """Save for a G*Fn's or the pair's ``jvp``: its constants. An input
    without a tangent then reaches the ``jvp`` as None, not as zeros, and
    so does an output without a cotangent the backward."""
    ctx.save_for_forward(pos, *rest)
    ctx.set_materialize_grads(False)


def _linear_jvp(fn, ctx, dt, dpos):
    """The tangent of a Function of the pair, linear in its first argument
    ``t``: ``fn`` on ``dt``. A tangent along positions raises."""
    if dpos is not None:
        raise NotImplementedError(_POSITION_HESSIAN)
    return fn.apply(dt.contiguous(), *ctx.saved_tensors, ctx.st)


def _held_constant(out: Tensor, pos: Tensor) -> Tensor:
    """``out``; in a graph that records derivatives, plus a zero node on
    ``pos`` whose backward raises. A gradient along parameters alone never
    runs that node: the autograd engine runs only the nodes on a path to the
    inputs it was asked for. A derivative along positions runs it."""
    if torch.is_grad_enabled() and pos.requires_grad:
        return out + _PositionsHeldConstant.apply(pos)
    return out


class G4Fn(torch.autograd.Function):
    """pos (N, 3) -> G4 (N, R*m); backward :class:`G4VjpFn` (the vjp
    kernel). Differentiable to any order along its cotangents; a second
    derivative along positions raises (see ``_POSITION_HESSIAN``)."""

    @staticmethod
    def forward(ctx, pos, z, angles, angle_mask, st):
        ctx.save_for_backward(pos, z, angles, angle_mask)
        _forward_saves(ctx, pos, z, angles, angle_mask)
        ctx.st = st
        return g4_forward(pos, z, angles, angle_mask, st)

    @staticmethod
    def backward(ctx, ct):
        if ct is None:  # materialize_grads is off
            return (None,) * 5
        pos, z, angles, angle_mask = ctx.saved_tensors
        dpos = G4VjpFn.apply(ct.contiguous(), pos, z, angles, angle_mask, ctx.st)
        return _held_constant(dpos, pos), None, None, None, None

    @staticmethod
    def jvp(ctx, dpos, *_):
        return G4JvpFn.apply(dpos.contiguous(), *ctx.saved_tensors, ctx.st)


class G4VjpFn(torch.autograd.Function):
    """ct (N, R*m) -> dpos (N, 3) at constant ``pos``; backward
    :class:`G4JvpFn` (the jvp kernel)."""

    @staticmethod
    def forward(ctx, ct, pos, z, angles, angle_mask, st):
        ctx.save_for_backward(pos, z, angles, angle_mask)
        _forward_saves(ctx, pos, z, angles, angle_mask)
        ctx.st = st
        return g4_vjp(pos, z, angles, angle_mask, ct, st)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:  # materialize_grads is off
            return (None,) * 6
        pos, z, angles, angle_mask = ctx.saved_tensors
        dct = G4JvpFn.apply(grad.contiguous(), pos, z, angles, angle_mask, ctx.st)
        return _held_constant(dct, pos), None, None, None, None, None

    @staticmethod
    def jvp(ctx, dct, dpos, *_):
        return _linear_jvp(G4VjpFn, ctx, dct, dpos)


class G4JvpFn(torch.autograd.Function):
    """dpos (N, 3) -> dG (N, R*m) at constant ``pos``; backward
    :class:`G4VjpFn` (the vjp kernel)."""

    @staticmethod
    def forward(ctx, dpos, pos, z, angles, angle_mask, st):
        ctx.save_for_backward(pos, z, angles, angle_mask)
        _forward_saves(ctx, pos, z, angles, angle_mask)
        ctx.st = st
        return g4_jvp(pos, z, angles, angle_mask, dpos, st)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:  # materialize_grads is off
            return (None,) * 6
        pos, z, angles, angle_mask = ctx.saved_tensors
        ddpos = G4VjpFn.apply(grad.contiguous(), pos, z, angles, angle_mask, ctx.st)
        return _held_constant(ddpos, pos), None, None, None, None, None

    @staticmethod
    def jvp(ctx, ddpos, dpos, *_):
        return _linear_jvp(G4JvpFn, ctx, ddpos, dpos)


class G2Fn(torch.autograd.Function):
    """pos (N, 3) -> G2 (N, R*m); backward :class:`G2VjpFn`, as
    :class:`G4Fn`."""

    @staticmethod
    def forward(ctx, pos, z, senders, receivers, edge_mask, st):
        ctx.save_for_backward(pos, z, senders, receivers, edge_mask)
        _forward_saves(ctx, pos, z, senders, receivers, edge_mask)
        ctx.st = st
        return g2_forward(pos, z, senders, receivers, edge_mask, st)

    @staticmethod
    def backward(ctx, ct):
        if ct is None:  # materialize_grads is off
            return (None,) * 6
        pos, z, senders, receivers, edge_mask = ctx.saved_tensors
        dpos = G2VjpFn.apply(ct.contiguous(), pos, z, senders, receivers,
                             edge_mask, ctx.st)
        return _held_constant(dpos, pos), None, None, None, None, None

    @staticmethod
    def jvp(ctx, dpos, *_):
        return G2JvpFn.apply(dpos.contiguous(), *ctx.saved_tensors, ctx.st)


class G2VjpFn(torch.autograd.Function):
    """ct (N, R*m) -> dpos (N, 3) at constant ``pos``; backward
    :class:`G2JvpFn`."""

    @staticmethod
    def forward(ctx, ct, pos, z, senders, receivers, edge_mask, st):
        ctx.save_for_backward(pos, z, senders, receivers, edge_mask)
        _forward_saves(ctx, pos, z, senders, receivers, edge_mask)
        ctx.st = st
        return g2_vjp(pos, z, senders, receivers, edge_mask, ct, st)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:  # materialize_grads is off
            return (None,) * 7
        pos, z, senders, receivers, edge_mask = ctx.saved_tensors
        dct = G2JvpFn.apply(grad.contiguous(), pos, z, senders, receivers,
                            edge_mask, ctx.st)
        return _held_constant(dct, pos), None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, dct, dpos, *_):
        return _linear_jvp(G2VjpFn, ctx, dct, dpos)


class G2JvpFn(torch.autograd.Function):
    """dpos (N, 3) -> dG (N, R*m) at constant ``pos``; backward
    :class:`G2VjpFn`."""

    @staticmethod
    def forward(ctx, dpos, pos, z, senders, receivers, edge_mask, st):
        ctx.save_for_backward(pos, z, senders, receivers, edge_mask)
        _forward_saves(ctx, pos, z, senders, receivers, edge_mask)
        ctx.st = st
        return g2_jvp(pos, z, senders, receivers, edge_mask, dpos, st)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:  # materialize_grads is off
            return (None,) * 7
        pos, z, senders, receivers, edge_mask = ctx.saved_tensors
        ddpos = G2VjpFn.apply(grad.contiguous(), pos, z, senders, receivers,
                              edge_mask, ctx.st)
        return _held_constant(ddpos, pos), None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, ddpos, dpos, *_):
        return _linear_jvp(G2JvpFn, ctx, ddpos, dpos)
