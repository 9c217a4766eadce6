"""Segmented MD on one device; counterpart of
``gcnn_keras_tpu/moldyn/trajectory.py`` (``ScannedMD``).

A trajectory is a run of segments. Within a segment the topology is fixed
and ``segment_steps`` integrator steps run on the device (a loop of the
steps of ``moldyn/integrate.py``; the JAX package scans them in one jitted
call); between segments the host re-neighbours the positions with
``set_range`` and rebuilds the batch with bucketed pads, as
``moldyn/base.py`` does, so that the batch shapes of successive segments
repeat. A ``skin`` widens the neighbour cutoff at build time, so that pairs
entering the model's cutoff mid-segment are already edges.

Many replicas run in one disjoint batch (``run_ensemble``): one reverse
pass over the summed energies gives every replica's forces. A periodic
system (one with ``graph_lattice``) is wrapped into its cell before each
segment and re-neighboured with ``set_range_periodic``; the model's
``range_image`` path carries the shifts.

``run_ensemble(n_devices=D)`` is replica parallelism over the D ranks of
this process's group (``parallel/mesh.py``): each rank integrates its
contiguous chunk of the replicas, with no collective in the loop, and the
results are gathered in replica order. Rank r's Langevin noise in segment
k comes from a ``torch.Generator`` seeded with
``SeedSequence([seed, k, r])`` (the JAX package splits the segment's key
over the devices).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..batch import GraphBatch, batch_graphs
from ..graph.preprocess import set_angle, set_range, set_range_periodic
from ..utils.constants import masses_from_numbers
from ..utils.devices import DeviceLike, resolve_device
from .integrate import baoab_step, ou_coefficients, verlet_step

Tensor = torch.Tensor


class ScannedMD:
    """Segmented MD for one molecule or an ensemble of replicas.

    Parameters
    ----------
    model: the energy module over a GraphBatch (it holds its weights);
        each graph's energy is read from ``out[energy_key][:, 0]``.
    dt: integrator time step (units are the caller's, as in
        ``moldyn/integrate.py``).
    segment_steps: steps per segment (the re-neighbouring period).
    max_distance / max_neighbours: the neighbour list (the model cutoff).
    skin: extra cutoff margin at build time.
    thermostat: None (NVE velocity Verlet) or "langevin" (BAOAB; ``kT`` in
        model energy units, ``friction`` in 1/time).
    seed: seeds the ``torch.Generator`` of the Langevin noise.
    with_angles: also build angle triples (``set_angle``) at every
        re-neighbouring, for ACSF models.
    graph_extras: host properties merged into every graph dict at every
        rebuild; names in ``global_keys`` become per-graph globals.
    device: where the model and the trajectory run (the CUDA card unless
        ``device="cpu"``).
    """

    def __init__(self, model: torch.nn.Module, dt: float,
                 segment_steps: int = 100, max_distance: float = 4.0,
                 max_neighbours: int = 25, skin: float = 0.0,
                 thermostat: Optional[str] = None, kT: float = 0.0,
                 friction: float = 1.0, energy_key: str = "output",
                 seed: int = 0, with_angles: bool = False,
                 graph_extras: Optional[Dict[str, np.ndarray]] = None,
                 global_keys: tuple = (), device: DeviceLike = None):
        if thermostat not in (None, "langevin"):
            raise ValueError(f"unknown thermostat {thermostat!r}")
        if thermostat == "langevin" and kT <= 0:
            raise ValueError("langevin thermostat needs kT > 0")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dt = float(dt)
        self.segment_steps = int(segment_steps)
        self.max_distance = float(max_distance)
        self.max_neighbours = int(max_neighbours)
        self.skin = float(skin)
        self.thermostat = thermostat
        self.kT = float(kT)
        self.friction = float(friction)
        self.energy_key = energy_key
        self.with_angles = with_angles
        self.graph_extras = dict(graph_extras or {})
        self.global_keys = tuple(global_keys)
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._shapes_seen = set()

    # -- one segment on the device ---------------------------------------
    def _segment(self, batch: GraphBatch, pos: Tensor, vel: Tensor, m: Tensor,
                 generator: torch.Generator):
        """``segment_steps`` steps; returns the final positions and
        velocities and the per-step, per-graph ``e_pot`` and ``e_kin``
        (steps, G), all on the device."""
        dt, steps, G = self.dt, self.segment_steps, batch.n_graphs
        mask = batch.node_mask[:, None].to(pos.dtype)
        gmask = batch.globals["graph_mask"].to(pos.dtype)
        graph_id = batch.graph_id.long()

        def efn(p):
            with torch.enable_grad():
                p = p.detach().requires_grad_(True)
                e = self.model(batch.replace_nodes(node_coordinates=p))[self.energy_key]
                e = e.reshape(e.shape[0], -1)[:, 0] * gmask  # (G,)
                # disjoint graphs: one reverse pass over the sum gives every
                # replica's forces
                (g,) = torch.autograd.grad(e.sum(), p)
            return e.detach(), -g

        def kinetic(v):
            ke = 0.5 * torch.sum(m * mask * v * v, dim=1)  # (N,)
            return torch.zeros(G, dtype=ke.dtype, device=ke.device).index_add_(0, graph_id, ke)

        if self.thermostat == "langevin":
            c1, c2 = ou_coefficients(self.friction, dt, self.kT, pos)

            def step(p, v, f):
                return baoab_step(efn, p, v, f, m, mask, dt, c1, c2, generator)
        else:
            def step(p, v, f):
                return verlet_step(efn, p, v, f, m, mask, dt)

        e_pot = pos.new_empty((steps, G))
        e_kin = pos.new_empty((steps, G))
        p, v = pos, vel * mask
        _, f = efn(p)
        f = f * mask
        for i in range(steps):
            p, v, f, e_pot[i] = step(p, v, f)
            e_kin[i] = kinetic(v)
        return p, v, e_pot, e_kin

    # -- host loop ---------------------------------------------------------
    def run(self, node_number: np.ndarray, positions: np.ndarray,
            n_segments: int, velocities: Optional[np.ndarray] = None,
            masses: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Single-molecule trajectory (``e_pot``/``e_kin`` shape (steps,))."""
        system = {"node_number": np.asarray(node_number),
                  "node_coordinates": np.asarray(positions, np.float32)}
        if velocities is not None:
            system["velocities"] = np.asarray(velocities, np.float32)
        if masses is not None:
            system["masses"] = np.asarray(masses, np.float32)
        out = self.run_ensemble([system], n_segments)
        return {"pos": out["pos"][0], "vel": out["vel"][0],
                "e_pot": out["e_pot"][:, 0], "e_kin": out["e_kin"][:, 0],
                "edge_counts": out["edge_counts"],
                "n_shapes_compiled": out["n_shapes_compiled"]}

    def run_ensemble(self, systems, n_segments: int,
                     n_devices: Optional[int] = None) -> Dict[str, Any]:
        """Independent replicas integrated in the same segments, in one
        disjoint batch. ``systems``: dicts with ``node_number``,
        ``node_coordinates`` and optional ``velocities`` / ``masses`` (any
        other key is merged into the graph dict). Returns per-replica
        ``pos``/``vel`` lists (numpy), ``e_pot``/``e_kin`` of shape
        (steps, S), the real edge count of each segment, and
        ``n_shapes_compiled``: the distinct padded batch shapes seen (the
        JAX ScannedMD compiles one runner per shape; nothing compiles here).
        ``n_devices``: the replicas shared over the ranks of this process's
        group of that size (the module docstring); S must divide by it."""
        S = len(systems)
        D = int(n_devices) if n_devices else 1
        if S % D != 0:
            raise ValueError(f"{S} replicas not divisible by n_devices={D}")
        if D == 1:
            return self._run(systems, n_segments, lambda seg: self.generator)
        from ..parallel.collectives import all_gather_object
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(D, device=self.device)
        chunk = S // D

        def generator(seg):
            seed = np.random.SeedSequence([self.seed, seg, mesh.rank]).generate_state(1)[0]
            return torch.Generator(device=self.device).manual_seed(int(seed))

        outs = all_gather_object(self._run(
            systems[mesh.rank * chunk:(mesh.rank + 1) * chunk], n_segments, generator), mesh)
        return {"pos": [p for o in outs for p in o["pos"]],
                "vel": [v for o in outs for v in o["vel"]],
                "e_pot": np.concatenate([o["e_pot"] for o in outs], axis=1),
                "e_kin": np.concatenate([o["e_kin"] for o in outs], axis=1),
                "edge_counts": [int(sum(c)) for c in zip(*(o["edge_counts"] for o in outs))],
                "n_shapes_compiled": max(o["n_shapes_compiled"] for o in outs)}

    def _run(self, systems, n_segments: int, generator) -> Dict[str, Any]:
        """``run_ensemble`` on this device; ``generator(k)`` is segment k's
        generator of the Langevin noise."""
        zs = [np.asarray(s["node_number"]) for s in systems]
        ns = [z.shape[0] for z in zs]
        pos = [np.asarray(s["node_coordinates"], np.float32) for s in systems]
        vel = [np.asarray(s.get("velocities", np.zeros((n, 3), np.float32)), np.float32)
               for s, n in zip(systems, ns)]
        masses = [np.asarray(s.get("masses", masses_from_numbers(z)), np.float32)
                  for s, z in zip(systems, zs)]
        extras = [{k: v for k, v in s.items()
                   if k not in ("node_number", "node_coordinates", "velocities", "masses")}
                  for s in systems]
        offs = np.concatenate([[0], np.cumsum(ns)]).astype(int)

        e_pot, e_kin, edge_counts = [], [], []
        for seg in range(n_segments):
            gs = []
            for i, (z, p, ex) in enumerate(zip(zs, pos, extras)):
                g = {"node_number": z, "node_coordinates": p}
                g.update(self.graph_extras)
                g.update(ex)
                if "graph_lattice" in g:
                    # wrap into the cell before the neighbour build; the
                    # images carry the rest
                    lat = np.asarray(g["graph_lattice"], np.float32)
                    frac = np.asarray(p, np.float64) @ np.linalg.inv(lat)
                    pos[i] = g["node_coordinates"] = (np.mod(frac, 1.0) @ lat).astype(np.float32)
                    g = set_range_periodic(g, max_distance=self.max_distance + self.skin,
                                           max_neighbours=self.max_neighbours)
                else:
                    g = set_range(g, max_distance=self.max_distance + self.skin,
                                  max_neighbours=self.max_neighbours)
                g["edge_indices"] = g.pop("range_indices")
                if self.with_angles:
                    g = set_angle(g, range_indices="edge_indices")
                gs.append(g)
            batch = batch_graphs(gs, global_keys=self.global_keys, device=self.device)
            edge_counts.append(int(batch.edge_mask.sum().item()))
            self._shapes_seen.add((batch.n_node, batch.n_edge))

            m_pad = np.ones((batch.n_node, 1), np.float32)
            pos_pad = np.zeros((batch.n_node, 3), np.float32)
            vel_pad = np.zeros((batch.n_node, 3), np.float32)
            for i, (o, n) in enumerate(zip(offs[:-1], ns)):
                m_pad[o:o + n, 0] = masses[i]
                pos_pad[o:o + n] = pos[i]
                vel_pad[o:o + n] = vel[i]
            p, v, ep, ek = self._segment(
                batch, *(torch.from_numpy(a).to(self.device) for a in (pos_pad, vel_pad, m_pad)),
                generator(seg))
            p, v = p.cpu().numpy(), v.cpu().numpy()
            pos = [p[o:o + n] for o, n in zip(offs[:-1], ns)]
            vel = [v[o:o + n] for o, n in zip(offs[:-1], ns)]
            e_pot.append(ep[:, :len(systems)].cpu().numpy())
            e_kin.append(ek[:, :len(systems)].cpu().numpy())

        return {"pos": pos, "vel": vel,
                "e_pot": np.concatenate(e_pot), "e_kin": np.concatenate(e_kin),
                "edge_counts": edge_counts,
                "n_shapes_compiled": len(self._shapes_seen)}
