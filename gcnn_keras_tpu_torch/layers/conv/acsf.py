"""Atom-centred symmetry functions (ACSF) G2/G4, Behler's descriptors;
counterpart of ``gcnn_keras_tpu/layers/conv/acsf.py``.

G2:  G_i = sum_{j != i} exp(-eta (r_ij - Rs)^2) * f_c(r_ij)   per (elem_j, set)
G4:  G_i = sum_{j,k} 2^{1-zeta} (1 + lambda cos theta_ijk)^zeta
           * exp(-eta (r_ij^2+r_ik^2+r_jk^2)) * f_c(r_ij) f_c(r_ik) f_c(r_jk)
           per (pair(elem_j, elem_k), set)

Neither layer has parameters. Each has two paths:

- the kernels (``ops/cuda/acsf.py``): the fwd kernel, with the vjp kernel as
  its backward, for a shared grid-constant table with sorted element slots
  (and, for G4, the default pair mapping; for G2, no periodic images);
- the plain path: the JAX package's unfused code, with autograd.

``fused``: ``None`` takes the kernels when the configuration is one they
cover, and otherwise the plain path on the CPU; on a CUDA tensor an
uncovered configuration raises ``NotImplementedError`` rather than running
plain operations on the card, but for a shard of an edge-partitioned batch,
which no kernel takes and which runs plain on any device, as in the JAX
package (its neighbour ids index the halo-exchanged node table,
``batch.sender_node_table``). ``True`` raises ``ValueError`` for an
uncovered configuration. ``False`` runs the plain path on any device.
On a CPU tensor the kernels' autograd Functions run their plain versions.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...batch import GraphBatch, sender_node_table
from ...ops.cuda import acsf as kacsf

Tensor = torch.Tensor

_MAX_Z = 96
# the reason a shard of an edge-partitioned batch gives (JAX's wording)
PARTITIONED = "edge-partitioned batch"


def _relational_pool(rep: Tensor, target: Tensor, relation: Tensor,
                     num_rel: int, n_node: int) -> Tensor:
    """``out[n, r*m + s] = sum_{e: target=n, rel=r} rep[e, s]`` -> (N, R*m),
    one unsorted sum over the combined id ``target * R + relation``."""
    m = rep.shape[-1]
    out = torch.zeros(n_node * num_rel, m, dtype=rep.dtype, device=rep.device)
    out = out.index_add_(0, target.long() * num_rel + relation.long(), rep)
    return out.reshape(n_node, num_rel * m)


def _reverse_mapping(element_mapping: np.ndarray) -> np.ndarray:
    rev = np.zeros(_MAX_Z, dtype=np.int64)
    for i, z in enumerate(element_mapping):
        rev[int(z)] = i
    return rev


def _cutoff_fc(r: Tensor, rc: Tensor) -> Tensor:
    """Cosine cutoff; r clipped to [-rc, rc], so f_c(r > rc) = 0."""
    r, rc = torch.broadcast_tensors(r, rc)
    rclip = torch.minimum(torch.maximum(r, -rc), rc)
    return 0.5 * (torch.cos(rclip * math.pi / rc) + 1.0)


def _node_inputs(batch: GraphBatch, z: Optional[Tensor],
                 positions: Optional[Tensor]):
    z = z if z is not None else batch.nodes["node_number"].to(torch.int32)
    pos = positions if positions is not None else batch.nodes["node_coordinates"]
    return z, pos


def _dispatch(layer: str, fused: Optional[bool], reasons: List[str],
              device: torch.device) -> bool:
    """True to take the kernels; raises where the ``fused`` contract says."""
    if fused is False:
        return False
    if reasons and fused:
        raise ValueError(f"{layer}(fused=True) but the configuration is not "
                         "eligible for the CUDA kernels: " + "; ".join(reasons))
    if reasons and device.type == "cuda" and PARTITIONED not in reasons:
        raise NotImplementedError(
            f"{layer}: the CUDA kernels do not cover this configuration ("
            + "; ".join(reasons) + "); pass fused=False to run plain "
            "PyTorch operations on the card")
    return not reasons


class ACSFG2(nn.Module):
    """Radial symmetry functions. Output ``(N, num_relations * m)``.

    ``eta_rs_rc``: (R, m, 3) shared or (R, R, m, 3) per-target-element table;
    ``element_mapping``: atomic numbers for the R element slots.
    """

    def __init__(self, eta_rs_rc: Any, element_mapping: Any,
                 add_eps: bool = False, fused: Optional[bool] = None):
        super().__init__()
        self.table = np.asarray(eta_rs_rc, dtype=np.float32)
        self.element_mapping = np.asarray(element_mapping)
        self.add_eps = add_eps
        self.fused = fused
        self.per_target = self.table.ndim == 4
        self.num_rel = self.table.shape[1] if self.per_target else self.table.shape[0]
        self.out_features = self.num_rel * self.table.shape[-2]
        self._static, self._table_reasons = None, []
        table, elems = self.table, self.element_mapping
        if self.per_target:
            self._table_reasons.append("per-target parameter table")
        elif not bool(np.all(table == table[0:1])):
            self._table_reasons.append("non-grid-constant parameter table")
        else:
            self._static = kacsf.make_static_g2(table, elems)
            self._table_reasons += kacsf.g2_kernel_limits(self._static)
        if not bool(np.all(np.diff(elems) > 0)):
            self._table_reasons.append("unsorted element_mapping")

    @staticmethod
    def make_param_table(eta: Sequence[float], rs: Sequence[float], rc: float,
                         elements: Sequence[int], **kwargs):
        """Grid of (eta, Rs) pairs shared by every element."""
        table = [(et, r, rc) for r in rs for et in eta]
        elements = np.sort(np.array(elements))
        params = np.broadcast_to(np.array(table), (len(elements), len(table), 3))
        return {"eta_rs_rc": np.array(params), "element_mapping": elements, **kwargs}

    def kernel_reasons(self, batch: GraphBatch) -> List[str]:
        """Why the kernels cannot take this layer on ``batch``; empty if
        they can."""
        reasons = list(self._table_reasons)
        if batch.part_axis is not None:
            reasons.insert(0, PARTITIONED)
        if "range_image" in batch.edges and "graph_lattice" in batch.globals:
            reasons.append("periodic batch (range_image shifts)")
        if "sender_perm" not in batch.edges:
            reasons.append("edges not sorted by receiver")
        return reasons

    def forward(self, batch: GraphBatch, z: Optional[Tensor] = None,
                positions: Optional[Tensor] = None) -> Tensor:
        z, pos = _node_inputs(batch, z, positions)
        if _dispatch("ACSFG2", self.fused, self.kernel_reasons(batch), pos.device):
            return kacsf.G2Fn.apply(pos, z.to(torch.int32), batch.senders,
                                    batch.receivers, batch.edge_mask, self._static)
        return self.forward_plain(batch, z, pos)

    def forward_plain(self, batch: GraphBatch, z: Tensor, pos: Tensor) -> Tensor:
        """The JAX package's unfused ACSFG2. On a shard of an
        edge-partitioned batch the senders index the halo-exchanged tables
        of ``z`` and ``pos``."""
        dev = pos.device
        tab = torch.as_tensor(self.table, device=dev)
        rev = torch.as_tensor(_reverse_mapping(self.element_mapping), device=dev)
        recv, send = batch.receivers.long(), batch.senders.long()
        z_tab, pos_tab = sender_node_table(batch, z), sender_node_table(batch, pos)
        zi = z[recv].long().clamp(0, _MAX_Z - 1)
        zj = z_tab[send].long().clamp(0, _MAX_Z - 1)
        zi_map, zj_map = rev[zi], rev[zj]
        params = tab[zi_map, zj_map] if self.per_target else tab[zj_map]  # (E, m, 3)
        eta, rs, rc = params[..., 0], params[..., 1], params[..., 2]

        vec = pos[recv] - pos_tab[send]
        if "range_image" in batch.edges and "graph_lattice" in batch.globals:
            image = batch.edges["range_image"].to(pos.dtype)
            lat_e = batch.globals["graph_lattice"].to(pos.dtype)[batch.edge_graph_id.long()]
            vec = vec + torch.einsum("ei,eij->ej", image, lat_e)
        r2 = (vec * vec).sum(-1, keepdim=True)
        rij = torch.sqrt(torch.clamp(r2, min=1e-12))  # (E, 1)

        rep = torch.exp(-eta * (rij - rs) ** 2) * _cutoff_fc(rij, rc)  # (E, m)
        rep = rep * batch.edge_mask[:, None].to(rep.dtype)
        return _relational_pool(rep, recv, zj_map.clamp(0, self.num_rel - 1),
                                self.num_rel, batch.n_node)


class ACSFG4(nn.Module):
    """Angular symmetry functions over (i, j, k) node triples.
    Output ``(N, num_pair_relations * m)``.

    ``eta_zeta_lambda_rc``: (M, m, 4) shared or (R, M, m, 4) per-target table
    with M element-pair slots; pair index from (elem_j, elem_k), unordered
    unless ``keep_pair_order``.
    """

    def __init__(self, eta_zeta_lambda_rc: Any, element_mapping: Any,
                 element_pair_mapping: Any = None, keep_pair_order: bool = False,
                 multiplicity: Optional[float] = None, add_eps: bool = False,
                 fused: Optional[bool] = None):
        super().__init__()
        self.table = np.asarray(eta_zeta_lambda_rc, dtype=np.float32)
        self.element_mapping = np.asarray(element_mapping)
        self.element_pair_mapping = element_pair_mapping
        self.keep_pair_order = keep_pair_order
        self.multiplicity = multiplicity
        self.add_eps = add_eps
        self.fused = fused
        self.per_target = self.table.ndim == 4
        self.num_rel = self.table.shape[1] if self.per_target else self.table.shape[0]
        self.out_features = self.num_rel * self.table.shape[-2]
        table, elems = self.table, self.element_mapping
        grid = table.reshape(-1, table.shape[-2], 4)
        self._static, self._reasons = None, []
        if self.per_target:
            self._reasons.append("per-target parameter table")
        if element_pair_mapping is not None:
            self._reasons.append("custom element_pair_mapping")
        if not bool(np.all(grid == grid[0:1])):
            self._reasons.append("non-grid-constant parameter table")
        elif not self.per_target:
            self._static = kacsf.make_static(table, elems, keep_pair_order,
                                             multiplicity)
            self._reasons += kacsf.g4_kernel_limits(self._static)
        if not bool(np.all(np.diff(elems) > 0)):
            # the kernels' pair-slot table assumes sorted element slots
            self._reasons.append("unsorted element_mapping")
        pairs, self._rev_pair = self._pair_maps()
        if pairs.shape[0] != self.num_rel:
            raise ValueError(f"pair table {pairs.shape[0]} != param relations "
                             f"{self.num_rel}")

    @staticmethod
    def make_param_table(eta: Sequence[float], zeta: Sequence[float],
                         lamda: Sequence[float], rc: float,
                         elements: Sequence[int], **kwargs):
        tab = [[et, zt, la, rc] for et in eta for zt in zeta for la in lamda]
        elements = np.sort(np.array(elements))
        n_pairs = len(elements) * (len(elements) + 1) // 2
        params = np.broadcast_to(np.array(tab), (n_pairs, len(tab), 4))
        return {"eta_zeta_lambda_rc": np.array(params), "element_mapping": elements,
                "element_pair_mapping": None, **kwargs}

    def _pair_maps(self):
        elements = self.element_mapping
        if self.element_pair_mapping is None:
            idx = elements[:, None]
            pairs = np.concatenate([
                np.repeat(idx[None, :, :], len(elements), axis=0),
                np.repeat(idx[:, None, :], len(elements), axis=1)], axis=-1
            ).reshape(-1, 2)
            if not self.keep_pair_order:
                pairs = np.sort(pairs, axis=-1)
                pairs = pairs[np.sort(np.unique(pairs, axis=0, return_index=True)[1])]
        else:
            pairs = np.asarray(self.element_pair_mapping)
        rev_pair = np.zeros((_MAX_Z, _MAX_Z), dtype=np.int64)
        for i, (a, b) in enumerate(pairs):
            rev_pair[a, b] = i
            if not self.keep_pair_order:
                rev_pair[b, a] = i
        return pairs, rev_pair

    def kernel_reasons(self, batch: GraphBatch) -> List[str]:
        """Why the kernels cannot take this layer; empty if they can (angles
        are centre-sorted by every batch)."""
        return ([PARTITIONED] if batch.part_axis is not None else []) + self._reasons

    def forward(self, batch: GraphBatch, z: Optional[Tensor] = None,
                positions: Optional[Tensor] = None) -> Tensor:
        if batch.angles is None:
            raise ValueError("ACSFG4 needs angle triples in the batch")
        z, pos = _node_inputs(batch, z, positions)
        if _dispatch("ACSFG4", self.fused, self.kernel_reasons(batch), pos.device):
            return kacsf.G4Fn.apply(pos, z.to(torch.int32), batch.angles,
                                    batch.angle_mask, self._static)
        return self.forward_plain(batch, z, pos)

    def forward_plain(self, batch: GraphBatch, z: Tensor, pos: Tensor) -> Tensor:
        """The JAX package's unfused ACSFG4. A shared grid-constant table
        with the default pair mapping over sorted elements takes the G4
        kernel's plain version: each transcendental once per unique value.
        On a shard of an edge-partitioned batch an angle's centre ``i`` is
        local and its neighbours ``j``, ``k`` index the halo-exchanged
        tables of ``z`` and ``pos``."""
        z_tab, pos_tab = sender_node_table(batch, z), sender_node_table(batch, pos)
        if self._static is not None and not (
                {"custom element_pair_mapping", "unsorted element_mapping"}
                & set(self._reasons)):
            return kacsf.g4_forward_plain(pos, z, batch.angles, batch.angle_mask,
                                          self._static, nbr_pos=pos_tab, nbr_z=z_tab)
        dev = pos.device
        rev = torch.as_tensor(_reverse_mapping(self.element_mapping), device=dev)
        rev_pair = torch.as_tensor(self._rev_pair, device=dev)
        tab = torch.as_tensor(self.table, device=dev)

        i, j, k = batch.angles.long().unbind(1)
        zi = z[i].long().clamp(0, _MAX_Z - 1)
        zj = z_tab[j].long().clamp(0, _MAX_Z - 1)
        zk = z_tab[k].long().clamp(0, _MAX_Z - 1)
        zi_map = rev[zi]
        zjk_map = rev_pair[zj, zk]
        params = tab[zi_map, zjk_map] if self.per_target else tab[zjk_map]  # (A, m, 4)
        eta, zeta, lamda, rc = (params[..., 0], params[..., 1], params[..., 2],
                                params[..., 3])

        pj, pk = pos_tab[j], pos_tab[k]
        vij, vik, vjk = pj - pos[i], pk - pos[i], pk - pj

        def dist(v):
            return torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-12))

        rij, rik, rjk = dist(vij), dist(vik), dist(vjk)
        cos_theta = (vij * vik).sum(-1, keepdim=True) / rij / rik

        fij, fik, fjk = _cutoff_fc(rij, rc), _cutoff_fc(rik, rc), _cutoff_fc(rjk, rc)
        gij = torch.exp(-eta * rij ** 2)
        gik = torch.exp(-eta * rik ** 2)
        gjk = torch.exp(-eta * rjk ** 2)
        cos_term = torch.pow(torch.clamp(cos_theta * lamda + 1.0, min=1e-30), zeta)
        cos_term = torch.pow(2.0, 1.0 - zeta) * cos_term
        if self.multiplicity is not None:
            cos_term = cos_term / self.multiplicity
        rep = cos_term * gij * gik * gjk * fij * fik * fjk             # (A, m)
        rep = rep * batch.angle_mask[:, None].to(rep.dtype)
        return _relational_pool(rep, i, zjk_map.clamp(0, self.num_rel - 1),
                                self.num_rel, batch.n_node)


class ACSFConstNormalization(nn.Module):
    """(x - mean) / std with constant tables."""

    def __init__(self, std: Any = 1.0, mean: Any = 0.0):
        super().__init__()
        self.std = np.asarray(std, dtype=np.float32)
        self.mean = np.asarray(mean, dtype=np.float32)

    def forward(self, x: Tensor) -> Tensor:
        mean = torch.as_tensor(self.mean, dtype=x.dtype, device=x.device)
        std = torch.as_tensor(self.std, dtype=x.dtype, device=x.device)
        return (x - mean) / std
