"""The system under test: the port's ``EnergyForceModel`` as a
configuration's adapter builds it, its batches from the port's
``batch_graphs``, and for training the port's engine (``Trainer``, the
force loss of ``training/force_script.py``, Adam).

The weights are the benchmark's: every parameter drawn from the seed on
the device in one call (``make_weights``), loaded into the port's model
with ``load_state_dict`` and handed as they are to the plain reference.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

Tensor = torch.Tensor

ADAM_BETA1 = 0.9  # torch.optim.Adam's default, as the port's Trainer takes it


def make_weights(shapes: Sequence[Tuple[str, Tuple[int, ...], float]], seed: int,
                 device) -> Dict[str, Tensor]:
    """``{name: tensor}``: one uniform draw in [-1, 1) for all parameters
    from a generator on ``device`` seeded with ``seed``, split in order and
    each part scaled by its limit. float32, as the configurations serve."""
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape, limit in shapes:
        n = math.prod(shape)
        out[name] = (flat[off:off + n] * limit).reshape(shape).contiguous()
        off += n
    return out


def glorot(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


class Program:
    """The port's model (``adapter.build``) with the benchmark's weights,
    and with ``train`` the port's ``Trainer`` and its state."""

    def __init__(self, adapter, cfg: dict, weights: Dict[str, Tensor], device, train: bool):
        self.cfg, self.device = cfg, torch.device(device)
        self.fmodel = adapter.build(cfg, device)
        self.fmodel.energy_model.load_state_dict(weights, strict=True)
        self.names = [n for n, p in self.fmodel.energy_model.named_parameters()
                      if p.requires_grad]
        self.trainer = self.state = None
        if train:
            from gcnn_keras_tpu_torch.training.force_script import (force_loss_fn,
                                                                    normalized_loss_weights)
            from gcnn_keras_tpu_torch.training.trainer import Trainer
            self.trainer = Trainer(force_loss_fn(self.fmodel, normalized_loss_weights(cfg)),
                                   functools.partial(torch.optim.Adam, lr=cfg["learning_rate"]))
            self.state = self.trainer.init_state(self.fmodel.energy_model.parameters())

    def batch(self, graphs: List[dict]):
        """One padded batch on the device, built by the port's batcher."""
        from gcnn_keras_tpu_torch.batch import batch_graphs
        return batch_graphs(graphs, global_keys=tuple(self.cfg["global_keys"]),
                            device=self.device)

    def step(self, batch) -> Tensor:
        """One ``Trainer.step``; returns its loss, still on the device."""
        self.state, metrics = self.trainer.step(self.state, batch)
        return metrics["loss"]

    def evaluate(self, batch) -> Dict[str, Tensor]:
        """One energy+force evaluation, the serving call (no graph kept)."""
        return self.fmodel.apply(batch)

    def params(self) -> Dict[str, Tensor]:
        return {n: p.detach().clone() for n, p in zip(self.names, self.state.params)}

    def first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's norm of the first gradient Adam took, worked out from
        its state after one step: ``exp_avg = (1 - beta1) g``; 0 for a leaf
        that Adam holds no state of (it never stepped)."""
        opt = self.state.optimizer
        return {n: float(opt.state[p]["exp_avg"].norm()) / (1.0 - ADAM_BETA1)
                if "exp_avg" in opt.state[p] else 0.0
                for n, p in zip(self.names, self.state.params)}
