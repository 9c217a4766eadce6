"""Molecular-dynamics integrators on the model's device; counterpart of
``gcnn_keras_tpu/moldyn/integrate.py``.

The JAX package runs each trajectory inside one jitted ``lax.scan``. Here a
trajectory is a plain loop over steps: positions, velocities and forces
stay on the device, each force is ``-grad`` of the energy by
``torch.autograd.grad``, and the per-step series (``e_pot``, ``e_kin``) are
written into device buffers and copied to the host once, at the end. The
topology is fixed over a trajectory; ``moldyn/trajectory.py`` re-neighbours
between segments.

Units are the caller's: masses, energies, coordinates and ``dt`` must be
consistent (with eV, Angstrom and amu the time unit is 10.1805 fs, as in
ASE).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..batch import GraphBatch

Tensor = torch.Tensor


def make_energy_force_fn(model: torch.nn.Module, batch: GraphBatch,
                         energy_key: str = "output") -> Callable:
    """``fn(pos (N, 3)) -> (e_pot, forces (N, 3))`` for a fixed-topology
    batch holding one molecule in graph slot 0; ``model`` is the energy
    module (it holds its weights). One reverse pass gives every force."""

    def fn(pos: Tensor):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e = model(batch.replace_nodes(node_coordinates=p))[energy_key][0, 0]
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g

    return fn


def verlet_step(energy_force_fn: Callable, pos: Tensor, vel: Tensor, force: Tensor,
                m: Tensor, mask: Tensor, dt: float):
    """One velocity-Verlet step from ``(pos, vel, force)``; ``m`` and
    ``mask`` are (N, 1) columns. Returns ``(pos, vel, force, e_pot)`` after
    it."""
    vel_half = vel + 0.5 * dt * force / m
    pos = pos + dt * vel_half * mask
    e_pot, force = energy_force_fn(pos)
    force = force * mask
    return pos, vel_half + 0.5 * dt * force / m, force, e_pot


def baoab_step(energy_force_fn: Callable, pos: Tensor, vel: Tensor, force: Tensor,
               m: Tensor, mask: Tensor, dt: float, c1: Tensor, c2: Tensor,
               generator: torch.Generator):
    """One BAOAB step (half kick, half drift, the exact Ornstein-Uhlenbeck
    refresh ``v <- c1 v + c2 / sqrt(m) xi``, half drift, half kick).
    Returns ``(pos, vel, force, e_pot)`` after it."""
    vel = vel + 0.5 * dt * force / m                          # B
    pos = pos + 0.5 * dt * vel * mask                         # A
    xi = torch.randn(pos.shape, generator=generator, dtype=pos.dtype, device=pos.device)
    vel = (c1 * vel + c2 / torch.sqrt(m) * xi) * mask         # O
    pos = pos + 0.5 * dt * vel * mask                         # A
    e_pot, force = energy_force_fn(pos)
    force = force * mask
    return pos, vel + 0.5 * dt * force / m, force, e_pot     # B


def ou_coefficients(friction: float, dt: float, kT: float, like: Tensor):
    """``c1 = exp(-friction dt)`` and ``c2 = sqrt((1 - c1^2) kT)`` of the
    Ornstein-Uhlenbeck refresh, in ``like``'s dtype and device."""
    c1 = torch.tensor(np.exp(-friction * dt), dtype=like.dtype, device=like.device)
    return c1, torch.sqrt((1.0 - c1 * c1) * kT)


def _masks(pos0: Tensor, masses: Tensor, node_mask: Optional[Tensor]):
    m = masses[:, None].to(pos0.dtype)
    mask = node_mask[:, None].to(pos0.dtype) if node_mask is not None \
        else torch.ones_like(m)
    return m, mask


def _result(pos, vel, e_pot, e_kin, e0, k0) -> Dict:
    return {"pos": pos, "vel": vel, "e_pot": e_pot.cpu().numpy(),
            "e_kin": e_kin.cpu().numpy(), "e_pot0": float(e0), "e_kin0": float(k0)}


def velocity_verlet(energy_force_fn: Callable, pos0: Tensor, vel0: Tensor,
                    masses: Tensor, dt: float, steps: int,
                    node_mask: Optional[Tensor] = None) -> Dict:
    """NVE velocity-Verlet trajectory of ``steps`` steps.

    Returns the per-step series ``e_pot`` and ``e_kin`` (numpy, shape
    (steps,)), the final ``pos``/``vel`` (tensors on the device) and the
    starting ``e_pot0``/``e_kin0``. ``masses`` (N,): padding atoms get mass
    1 and zero velocity and force through ``node_mask``."""
    m, mask = _masks(pos0, masses, node_mask)

    def kinetic(vel):
        return 0.5 * torch.sum(m * mask * vel * vel)

    e_pot, e_kin = pos0.new_empty(steps), pos0.new_empty(steps)
    pos, vel = pos0, vel0 * mask
    e0, force = energy_force_fn(pos)
    force = force * mask
    k0 = kinetic(vel)
    for i in range(steps):
        pos, vel, force, e_pot[i] = verlet_step(energy_force_fn, pos, vel, force, m, mask, dt)
        e_kin[i] = kinetic(vel)
    return _result(pos, vel, e_pot, e_kin, e0, k0)


def nve_drift(traj: Dict) -> Dict[str, float]:
    """Energy-conservation metrics of a velocity-Verlet trajectory.

    - ``max_abs_drift``: max |E_tot(t) - E_tot(0)|
    - ``rel_drift``: that over the mean kinetic energy
    - ``drift_per_step``: the slope of a linear fit of E_tot, which tells a
      secular leak (wrong forces) from the bounded oscillation velocity
      Verlet is allowed
    """
    e_tot = np.asarray(traj["e_pot"]) + np.asarray(traj["e_kin"])
    e_ref = float(traj["e_pot0"]) + float(traj["e_kin0"])
    scale = max(float(np.mean(np.asarray(traj["e_kin"]))), 1e-30)
    t = np.arange(len(e_tot), dtype=np.float64)
    slope = float(np.polyfit(t, np.asarray(e_tot, np.float64), 1)[0])
    max_abs = float(np.max(np.abs(e_tot - e_ref)))
    return {"max_abs_drift": max_abs,
            "rel_drift": max_abs / scale,
            "drift_per_step": slope,
            "rel_drift_per_step": abs(slope) / scale,
            "e_kin_mean": scale}


def langevin_baoab(energy_force_fn: Callable, pos0: Tensor, vel0: Tensor,
                   masses: Tensor, dt: float, steps: int, kT: float,
                   friction: float, generator: torch.Generator,
                   node_mask: Optional[Tensor] = None) -> Dict:
    """NVT Langevin trajectory, BAOAB splitting (Leimkuhler-Matthews,
    :func:`baoab_step`). ``kT`` in the model's energy units, ``friction``
    in inverse time units of ``dt``. The noise is drawn from ``generator``
    (on the positions' device), where the JAX package takes a key: the two
    give different numbers from one seed. Returns what
    :func:`velocity_verlet` returns."""
    m, mask = _masks(pos0, masses, node_mask)
    c1, c2 = ou_coefficients(friction, dt, kT, pos0)

    def kinetic(vel):
        return 0.5 * torch.sum(m * mask * vel * vel)

    e_pot, e_kin = pos0.new_empty(steps), pos0.new_empty(steps)
    pos, vel = pos0, vel0 * mask
    e0, force = energy_force_fn(pos)
    force = force * mask
    k0 = kinetic(vel)
    for i in range(steps):
        pos, vel, force, e_pot[i] = baoab_step(energy_force_fn, pos, vel, force, m, mask, dt,
                                               c1, c2, generator)
        e_kin[i] = kinetic(vel)
    return _result(pos, vel, e_pot, e_kin, e0, k0)
