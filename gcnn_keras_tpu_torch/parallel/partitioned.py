"""The model zoo on an edge-partitioned giant graph; counterpart of
``gcnn_keras_tpu/parallel/partitioned.py``.

A partitioned graph is a batch of which each rank holds one shard: graph
slot 0 of a 2-slot batch of its ``N_loc`` nodes, its edges those whose
receiver it owns. The batch's ``part_axis`` (the mesh), ``halo_size`` and
``n_shards`` make every sender-side gather in ``layers/aggr.py`` and
``layers/geometry.py`` read the halo-exchanged node table
(``batch.sender_node_table``), so SchNet and PAiNN run unchanged on it.

The host half (``PartitionedInputs``, ``fit_halo``, ``prepare_partitioned``
with angles, ``build_partitioned_batch``, ``shard_node_array``,
``unshard_node_array``, ``single_graph_batch``) is a numpy copy of the JAX
package's and gives its arrays bit for bit.

The execution half: ``make_partitioned_energy_force`` gives the energy and
this rank's forces, the gradient of ``E / n_shards`` (the graph readout is
summed over the shards, a sum that is its own transpose, so each shard's
cotangent arrives once: JAX's recipe). ``make_partitioned_train_step`` takes
an optimizer step on ``w_e (E - E_ref)^2 + w_f mean (F - F_ref)^2``: the
energy term through the surrogate ``coeff * E / n_shards`` with ``coeff =
2 w_e (E - E_ref)`` held constant, the force term reverse over reverse
through the collectives (their backward passes are collectives too), the
parameter gradients summed over the ranks. The JAX package takes the
force term reverse over forward because its distributed CG solve was wrong
at second order; no CG solve is on this path. The charge term and any model
that reaches ACSF or ``CENTCharge`` on a partitioned batch (the partitioned
HDNNP4th) raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..batch import GraphBatch, batch_graphs
from ..utils.devices import DeviceLike
from .collectives import all_gather_tiled, broadcast_tensors_, psum, psum_tensors
from .edge_partition import (PartitionedGraph, encode_halo_senders,
                             partition_graph, required_halo_size)
from .mesh import Mesh, shard_stacked_batch

Tensor = torch.Tensor


# --------------------------------------------------------- partitioning ---

class PartitionedInputs(NamedTuple):
    z: np.ndarray                # (D, N_loc) int32
    pos: np.ndarray              # (D, N_loc, 3) f32
    senders_idx: np.ndarray      # (D, E_loc) int32: halo-table or GLOBAL ids
    receivers_local: np.ndarray  # (D, E_loc) int32, sorted per shard
    edge_mask: np.ndarray        # (D, E_loc) bool
    node_mask: np.ndarray        # (D, N_loc) bool
    order: np.ndarray            # new_id -> old_id permutation
    halo_size: int               # 0 => all-gather strategy
    remote_fraction: float       # share of real edges whose sender is off-shard
    # optional angle triples (ACSF): centre i a LOCAL id, j/k encoded as the
    # senders; sorted by centre per shard
    angles_idx: Optional[np.ndarray] = None    # (D, A_loc, 3) int32
    angle_mask: Optional[np.ndarray] = None    # (D, A_loc) bool


def fit_halo(part: PartitionedGraph, round_to: int = 64,
             max_fraction: float = 0.5) -> int:
    """The halo size of the partition: 0 (the all-gather) where senders lie
    beyond the ring neighbours or the halo would pass ``max_fraction`` of
    the local block, else the need rounded up to ``round_to``."""
    need = required_halo_size(part)
    if need < 0 or need > max_fraction * part.n_local:
        return 0
    return min(max(((need + round_to - 1) // round_to) * round_to, round_to),
               part.n_local)


def _angle_halo_need(new_ang: np.ndarray, n_loc: int) -> int:
    """Smallest halo covering every angle's j/k from the centre's shard, or
    -1 if some neighbour lies beyond the ring neighbours."""
    if len(new_ang) == 0:
        return 0
    owner = new_ang[:, 0] // n_loc
    need = 0
    for col in (1, 2):
        rel = new_ang[:, col] - owner * n_loc
        if np.any(rel < -n_loc) or np.any(rel >= 2 * n_loc):
            return -1
        need = max(need, int(np.max(np.maximum(-rel, rel - n_loc + 1),
                                    initial=0)))
    return need


def prepare_partitioned(z: np.ndarray, pos: np.ndarray, senders: np.ndarray,
                        receivers: np.ndarray, n_devices: int,
                        locality_sort: bool = True,
                        angles: Optional[np.ndarray] = None
                        ) -> PartitionedInputs:
    """The locality-sorted block partition with its strategy: the halo
    where the partition allows it, else the all-gather. ``angles``:
    optional (A, 3) (i, j, k) node triples (centre i), each on its centre's
    shard with j/k encoded as the senders."""
    part = partition_graph(pos.astype(np.float32), senders, receivers,
                           n_devices, locality_sort=locality_sort,
                           positions=pos)
    n_loc = part.n_local
    n = len(z)
    z_pad = np.zeros(n_loc * n_devices, dtype=np.int32)
    z_pad[:n] = np.asarray(z, dtype=np.int32)[part.order]

    inv = np.empty(n, dtype=np.int64)
    inv[part.order] = np.arange(n)
    new_ang = (inv[np.asarray(angles, dtype=np.int64)]
               if angles is not None and len(angles) else
               np.zeros((0, 3), dtype=np.int64))

    remote = 0
    total = 0
    for d in range(n_devices):
        s = part.senders_global[d][part.edge_mask[d]].astype(np.int64)
        lo = d * n_loc
        remote += int(np.sum((s < lo) | (s >= lo + n_loc)))
        total += len(s)
    remote_fraction = remote / max(total, 1)

    halo = fit_halo(part)
    if halo > 0 and angles is not None:
        need_a = _angle_halo_need(new_ang, n_loc)
        need_e = required_halo_size(part)
        if need_a < 0 or max(need_a, need_e) > 0.5 * n_loc:
            halo = 0
        else:
            halo = min(max(((max(need_a, need_e) + 63) // 64) * 64, 64),
                       n_loc)
    if halo > 0:
        senders_idx, ok = encode_halo_senders(part, halo, n_devices)
        if not ok:
            # never run with clipped (wrong) sender ids
            halo, senders_idx = 0, part.senders_global
    else:
        senders_idx = part.senders_global

    angles_idx = angle_mask = None
    if angles is not None:
        owner = (new_ang[:, 0] // n_loc if len(new_ang) else
                 np.zeros((0,), dtype=np.int64))
        per_shard = []
        a_loc = 128
        for d in range(n_devices):
            sel = new_ang[owner == d]
            i_loc = sel[:, 0] - d * n_loc
            if halo > 0:
                jk = sel[:, 1:] - d * n_loc + halo
            else:
                jk = sel[:, 1:]
            o = np.argsort(i_loc, kind="stable")
            per_shard.append((i_loc[o], jk[o]))
            a_loc = max(a_loc, len(sel))
        a_loc = ((a_loc + 127) // 128) * 128
        angles_idx = np.zeros((n_devices, a_loc, 3), dtype=np.int32)
        angle_mask = np.zeros((n_devices, a_loc), dtype=bool)
        for d, (i_loc, jk) in enumerate(per_shard):
            m = len(i_loc)
            angles_idx[d, :m, 0] = i_loc
            angles_idx[d, :m, 1:] = jk
            angle_mask[d, :m] = True
            # padding rows keep the centre sort and point j/k at slot 0
            angles_idx[d, m:, 0] = n_loc - 1
    return PartitionedInputs(
        z=z_pad.reshape(n_devices, n_loc),
        pos=part.node_feats.astype(np.float32),
        senders_idx=senders_idx.astype(np.int32),
        receivers_local=part.receivers_local.astype(np.int32),
        edge_mask=part.edge_mask, node_mask=part.node_mask,
        order=part.order, halo_size=halo, remote_fraction=remote_fraction,
        angles_idx=angles_idx, angle_mask=angle_mask)


def build_partitioned_batch(pin: PartitionedInputs, axis: str = "data",
                            node_props: Optional[Dict[str, np.ndarray]] = None,
                            global_props: Optional[Dict[str, np.ndarray]] = None
                            ) -> GraphBatch:
    """The stacked (leading dim D) host batch of one partitioned graph, its
    arrays numpy; ``shard_stacked_batch`` gives each rank its shard.

    Each shard is graph slot 0 of a 2-slot batch (slot 1 takes the padding
    nodes); padding edges point at the last local slot, which may be real,
    so ``pool_edges_to_nodes`` masks them. ``node_props``: per-node arrays
    in the ORIGINAL node order (``shard_node_array``); ``global_props``:
    per-graph values, in graph slot 0 of every shard."""
    D, n_loc = pin.z.shape
    graph_id = np.where(pin.node_mask, 0, 1).astype(np.int32)
    node_loc = np.broadcast_to(
        np.arange(n_loc, dtype=np.int32)[None], (D, n_loc)).copy()
    graph_mask = np.broadcast_to(np.array([True, False])[None], (D, 2)).copy()
    nodes = {"node_number": pin.z, "node_coordinates": pin.pos}
    for k, v in (node_props or {}).items():
        nodes[k] = shard_node_array(pin, np.asarray(v))
    globals_ = {"graph_mask": graph_mask}
    for k, v in (global_props or {}).items():
        arr = np.zeros((D, 2) + np.shape(np.atleast_1d(v))[1:],
                       dtype=np.asarray(v, dtype=np.float32).dtype)
        arr[:, 0] = np.asarray(v)
        globals_[k] = arr
    return GraphBatch(
        nodes=nodes,
        edges={},
        globals=globals_,
        senders=pin.senders_idx,
        receivers=pin.receivers_local,
        graph_id=graph_id,
        node_loc=node_loc,
        node_mask=pin.node_mask,
        edge_mask=pin.edge_mask,
        angles=pin.angles_idx,
        angle_mask=pin.angle_mask,
        n_graphs=2,
        max_nodes=n_loc,
        part_axis=axis,
        halo_size=pin.halo_size,
        n_shards=D,
    )


def shard_node_array(pin: PartitionedInputs, arr: np.ndarray) -> np.ndarray:
    """A per-node array ``(N, ...)`` permuted and padded into the partition
    layout ``(D, N_loc, ...)``."""
    D, n_loc = pin.z.shape
    out = np.zeros((D * n_loc,) + arr.shape[1:], dtype=arr.dtype)
    out[:len(pin.order)] = np.asarray(arr)[pin.order]
    return out.reshape((D, n_loc) + arr.shape[1:])


def unshard_node_array(pin: PartitionedInputs, arr: np.ndarray) -> np.ndarray:
    """Inverse of ``shard_node_array``: ``(D, N_loc, ...) -> (N, ...)`` in
    the ORIGINAL node order."""
    flat = np.asarray(arr).reshape((-1,) + arr.shape[2:])
    n = len(pin.order)
    out = np.zeros((n,) + flat.shape[1:], dtype=flat.dtype)
    out[pin.order] = flat[:n]
    return out


def single_graph_batch(z: np.ndarray, pos: np.ndarray, senders: np.ndarray,
                       receivers: np.ndarray, device: DeviceLike = None, **kw) -> GraphBatch:
    """The single-device oracle's input: the same graph as one ordinary
    batch on ``device`` (``edge_indices[:, 0]`` the receiver)."""
    g = {"node_number": np.asarray(z, np.int32),
         "node_coordinates": np.asarray(pos, np.float32),
         "edge_indices": np.stack([np.asarray(receivers),
                                   np.asarray(senders)], axis=1)}
    return batch_graphs([g], device=device, **kw)


# ------------------------------------------------------------ execution ---

def rank_shard(pin: PartitionedInputs, mesh: Mesh, **props) -> GraphBatch:
    """This rank's shard of ``pin`` as a batch on its device
    (``build_partitioned_batch``'s keywords in ``props``)."""
    if pin.z.shape[0] != mesh.size:
        raise ValueError(f"a graph partitioned for {pin.z.shape[0]} shards on a mesh of "
                         f"{mesh.size} ranks")
    return shard_stacked_batch(build_partitioned_batch(pin, mesh.axis, **props), mesh)


def _energy_scaled(model, lb: GraphBatch, pos: Tensor, energy_key: str) -> Tensor:
    """``E / n_shards``, the differentiable share of each shard: the
    readout is summed over the shards, so differentiating the replicated
    ``E`` itself would count every path before the readout ``n_shards``
    times."""
    out = model(lb.replace_nodes(node_coordinates=pos))
    return out[energy_key][0, 0] / lb.n_shards


def make_partitioned_energy_force(model, mesh: Mesh, energy_key: str = "output") -> Callable:
    """``fn(batch) -> (energy, forces (N_loc, 3))`` on this rank's shard:
    the energy of the whole graph (the same on every rank) and the forces
    on this rank's nodes, the transposed collectives having brought each
    neighbour's share home."""
    def fn(batch: GraphBatch) -> Tuple[Tensor, Tensor]:
        pos = batch.nodes["node_coordinates"].detach().requires_grad_(True)
        with torch.enable_grad():
            e_s = _energy_scaled(model, batch, pos, energy_key)
            (g,) = torch.autograd.grad(e_s, pos)
        return (e_s * batch.n_shards).detach(), -g
    return fn


def run_partitioned_energy_force(model, pin: PartitionedInputs, mesh: Mesh,
                                 energy_key: str = "output") -> Tuple[float, np.ndarray]:
    """This rank's shard of ``pin`` through ``make_partitioned_energy_force``;
    returns ``(energy, forces (N, 3) in the ORIGINAL node order)``, the
    forces gathered from every rank."""
    e, f = make_partitioned_energy_force(model, mesh, energy_key)(rank_shard(pin, mesh))
    return float(e), unshard_node_array(pin, all_gather_tiled(f, mesh).cpu().numpy()
                                        .reshape(pin.z.shape + (3,)))


@dataclasses.dataclass
class PartitionedTrainState:
    """The parameters (rank 0's on every rank), their optimizer and the
    steps taken."""
    params: list
    optimizer: torch.optim.Optimizer
    step: int = 0


class PartitionedTrainStep:
    """``state, metrics = step(state, batch, e_ref, f_ref)`` on this rank's
    shard ``batch``: ``e_ref`` the whole graph's energy, ``f_ref (N_loc, 3)``
    this shard's reference forces (``shard_node_array``). The loss is
    ``w_energy (E - E_ref)^2 + w_force mean_{n, xyz} (F - F_ref)^2`` (the
    module docstring); ``metrics`` holds ``loss``, ``energy`` and
    ``force_loss``. ``init_state()`` starts from rank 0's parameters."""

    def __init__(self, model, mesh: Mesh, optimizer: Callable, energy_key: str = "output",
                 w_energy: float = 1.0, w_force: float = 1.0, w_charge: float = 0.0):
        if w_charge:
            raise NotImplementedError(
                "make_partitioned_train_step(w_charge > 0): the charge loss of the partitioned "
                "HDNNP4th is not ported yet (ROADMAP.md, 'Parallel')")
        self.model, self.mesh, self.optimizer = model, mesh, optimizer
        self.energy_key, self.w_energy, self.w_force = energy_key, w_energy, w_force

    def init_state(self) -> PartitionedTrainState:
        params = [p for p in self.model.parameters() if p.requires_grad]
        broadcast_tensors_(params, self.mesh)
        return PartitionedTrainState(params=params, optimizer=self.optimizer(params))

    def grads(self, state: PartitionedTrainState, batch: GraphBatch, e_ref, f_ref):
        """``(parameter gradients summed over the ranks, metrics, this
        shard's forces)``: the step without its update."""
        mesh = self.mesh
        mask = batch.node_mask.to(f_ref.dtype)[:, None]
        n_tot3 = 3.0 * psum(mask.sum().detach(), mesh)
        pos = batch.nodes["node_coordinates"].detach().requires_grad_(True)
        with torch.enable_grad():
            e_s = _energy_scaled(self.model, batch, pos, self.energy_key)
            (g,) = torch.autograd.grad(e_s, pos, create_graph=self.w_force != 0)
            f_pred = -g
            e = (e_s * batch.n_shards).detach()
            coeff = 2.0 * self.w_energy * (e - e_ref)
            df = (f_pred - f_ref) * mask
            lf_loc = self.w_force * torch.sum(df * df) / n_tot3
            surrogate = coeff * e_s + (lf_loc if self.w_force else 0.0)
            grads = torch.autograd.grad(surrogate, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(state.params, grads)]
        grads = psum_tensors(grads, mesh)
        lf = psum(lf_loc.detach(), mesh)
        metrics = {"loss": self.w_energy * (e - e_ref) ** 2 + lf, "energy": e,
                   "force_loss": lf}
        return grads, metrics, f_pred.detach()

    def __call__(self, state: PartitionedTrainState, batch: GraphBatch, e_ref, f_ref,
                 q_ref=None):
        if q_ref is not None:
            raise NotImplementedError(
                "a partitioned charge loss (q_ref) is not ported yet (ROADMAP.md, 'Parallel')")
        grads, metrics, _ = self.grads(state, batch, e_ref, f_ref)
        for p, gr in zip(state.params, grads):
            p.grad = gr
        state.optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), metrics


def make_partitioned_train_step(model, mesh: Mesh, optimizer: Callable,
                                energy_key: str = "output", w_energy: float = 1.0,
                                w_force: float = 1.0, w_charge: float = 0.0
                                ) -> PartitionedTrainStep:
    """An optimizer step over the sharded graph (``PartitionedTrainStep``).
    ``optimizer`` makes the optimizer from the parameters, e.g.
    ``functools.partial(torch.optim.SGD, lr=1.0)``; ``w_charge > 0``
    raises."""
    return PartitionedTrainStep(model, mesh, optimizer, energy_key, w_energy, w_force,
                                w_charge)
