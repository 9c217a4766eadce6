"""Energy -> force wrapper via autograd; counterpart of
``gcnn_keras_tpu/model/force.py`` (``EnergyForceModel.apply`` and
``apply_multistate``).

Per-graph energies are scalars, so one reverse pass over ``sum_g E_g``
yields all forces at once. With ``use_esp_coupling`` the ESP force term
``F_i += -(dE/dPhi_i) * dPhi_i/dr_i`` is added, the ESP gradient being a
node input.

Training a force loss differentiates the forces along the parameters
(``apply(batch, create_graph=True)``, then ``torch.autograd.grad(loss,
parameters)``). Ask for the parameters' gradients alone: through the ACSF
kernels a derivative along the coordinates raises (``ops/cuda/acsf.py``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..batch import GraphBatch
from ..utils.devices import DeviceLike, resolve_device

Tensor = torch.Tensor


class EnergyForceModel:
    """Wraps an energy model (an ``nn.Module`` over GraphBatch) and moves it
    to ``device`` (the CUDA card unless ``device="cpu"``).

    ``apply(batch)`` returns a dict with ``energy`` (G, S) and ``force``
    (N, 3), passing through all other outputs of the inner model;
    ``apply_multistate`` the forces of each of S states, (S, N, 3). Other
    keywords of either (``train``) go to the energy model, as the JAX
    package's ``**kwargs`` do.
    """

    def __init__(self, energy_model: nn.Module, energy_output_key: str = "output",
                 coordinates_key: str = "node_coordinates",
                 esp_key: str = "esp", esp_grad_key: str = "esp_grad",
                 use_esp_coupling: bool = False,
                 is_physical_force: bool = True, device: DeviceLike = None):
        self.energy_model = energy_model.to(resolve_device(device))
        self.energy_output_key = energy_output_key
        self.coordinates_key = coordinates_key
        self.esp_key = esp_key
        self.esp_grad_key = esp_grad_key
        self.use_esp_coupling = use_esp_coupling
        self.sign = -1.0 if is_physical_force else 1.0

    def apply(self, batch: GraphBatch, create_graph: bool = False,
              **kwargs) -> Dict[str, Tensor]:
        """Energies and forces. ``create_graph=False`` (serving) takes the
        forces without a graph through them; ``True`` (training) keeps the
        graph through ``dE/dr`` and ``dE/dPhi``, so that a loss on the forces
        can be differentiated along the parameters."""
        use_esp = self.use_esp_coupling and self.esp_key in batch.nodes
        with torch.enable_grad():
            coords = batch.nodes[self.coordinates_key].detach().requires_grad_(True)
            new_nodes = {self.coordinates_key: coords}
            wrt = [coords]
            if use_esp:
                esp = batch.nodes[self.esp_key].detach().requires_grad_(True)
                new_nodes[self.esp_key] = esp
                wrt.append(esp)
            out = self.energy_model(batch.replace_nodes(**new_nodes), **kwargs)
            e = out[self.energy_output_key]
            gmask = batch.globals["graph_mask"].to(e.dtype)
            total_e = torch.sum(e * gmask.reshape(gmask.shape + (1,) * (e.dim() - 1)))
            grads = torch.autograd.grad(total_e, wrt, allow_unused=True,
                                        create_graph=create_graph)
        de_dr = grads[0] if grads[0] is not None else torch.zeros_like(coords)
        force = self.sign * de_dr
        if use_esp and grads[1] is not None:
            esp_grad = batch.nodes[self.esp_grad_key]  # (N, 3) = dPhi_i/dr_i
            de_desp = grads[1]
            de_desp = de_desp.reshape(de_desp.shape + (1,) * (esp_grad.dim() - de_desp.dim()))
            force = force + self.sign * de_desp * esp_grad
        nmask = batch.node_mask
        force = force * nmask.reshape(nmask.shape + (1,) * (force.dim() - 1)).to(force.dtype)

        result = dict(out)
        result["energy"] = out[self.energy_output_key]
        result["force"] = force
        return result

    def apply_multistate(self, batch: GraphBatch, num_states: int,
                         create_graph: bool = False, **kwargs) -> Dict[str, Tensor]:
        """S > 1 energy states (``energy`` (G, S)): the forces of each,
        ``force`` (S, N, 3), the Jacobian of the state energies summed over
        the graphs along the coordinates, one reverse pass a state (the
        JAX package's ``jacrev``). ``num_states`` names S, as the JAX
        signature does; the energy output's width is what counts. With
        ``create_graph`` the forces keep their graph for a force loss. No
        ESP coupling, as in the JAX package."""
        with torch.enable_grad():
            coords = batch.nodes[self.coordinates_key].detach().requires_grad_(True)
            out = self.energy_model(batch.replace_nodes(**{self.coordinates_key: coords}),
                                    **kwargs)
            e = out[self.energy_output_key]
            gmask = batch.globals["graph_mask"].to(e.dtype)
            energies = torch.sum(e * gmask[:, None], dim=0)  # (S,)
            rows = []
            for s in range(energies.shape[0]):
                (g,) = torch.autograd.grad(energies[s], coords, allow_unused=True,
                                           retain_graph=True, create_graph=create_graph)
                rows.append(torch.zeros_like(coords) if g is None else g)
        jac = torch.stack(rows)  # (S, N, 3)
        force = self.sign * jac * batch.node_mask[None, :, None].to(jac.dtype)
        result = dict(out)
        result["energy"] = e
        result["force"] = force
        return result

    __call__ = apply
