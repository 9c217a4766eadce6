"""ML/MM energy-force wrapper; counterpart of
``gcnn_keras_tpu/model/mlmm.py`` (``MLMMEnergyForceModel``).

Adds the QM/MM point-charge electrostatic energy and force around an
:class:`EnergyForceModel` whose inner model predicts charges, from those
charges and the MM electrostatic potential (ESP) and its gradient given as
node inputs. The coupling sits outside the learned model, so a potential
trained in vacuum can be embedded in an MM environment.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..batch import GraphBatch
from ..layers.conv.hdnnp_electro import electrostatic_qmmm_energy, electrostatic_qmmm_force
from .force import EnergyForceModel

Tensor = torch.Tensor


class MLMMEnergyForceModel:
    """Wraps ``energy_force_model``; it has no parameters of its own and runs
    on the inner model's device.

    ``apply(batch, create_graph=False)`` returns the inner dict with
    ``energy += E_qmmm`` (``sum_i q_i Phi_i`` per graph), ``force +=
    -q_i dPhi_i/dr_i`` on real atoms where the batch has ``esp_grad`` and
    the inner output has forces, and ``qmmm_energy_correction`` = E_qmmm.
    Without charges in the inner output or without ``esp`` in the batch it
    returns the inner dict unchanged.
    """

    def __init__(self, energy_force_model: EnergyForceModel,
                 esp_key: str = "esp", esp_grad_key: str = "esp_grad",
                 charge_key: str = "charge"):
        self.inner = energy_force_model
        self.esp_key = esp_key
        self.esp_grad_key = esp_grad_key
        self.charge_key = charge_key

    def apply(self, batch: GraphBatch, create_graph: bool = False) -> Dict[str, Tensor]:
        out = self.inner.apply(batch, create_graph=create_graph)
        q = out.get(self.charge_key)
        if q is None or self.esp_key not in batch.nodes:
            return out
        e_qmmm = electrostatic_qmmm_energy(batch, q, batch.nodes[self.esp_key])
        result = dict(out)
        result["energy"] = out["energy"] + e_qmmm
        if self.esp_grad_key in batch.nodes and "force" in out:
            f_qmmm = electrostatic_qmmm_force(q, batch.nodes[self.esp_grad_key])
            result["force"] = out["force"] + f_qmmm * batch.node_mask[:, None].to(f_qmmm.dtype)
        result["qmmm_energy_correction"] = e_qmmm
        return result

    __call__ = apply
