"""What the plain references share: the molecules as flat tensors, the
activations, a matmul that can compute in TF32 (the control's precision),
and training steps with Adam by its own formula.

Plain PyTorch. The references compute in float64 (``REFERENCE_DTYPE``),
from the benchmark's float32 weights and graphs, so that what they judge
is the program's float32 error and not their own; the control computes in
float32 with TF32 matmuls. It imports nothing of ``gcnn_keras_tpu_torch``
and takes nothing the port made: the graphs and weights are the
benchmark's own.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


class Molecules:
    """A list of graph dicts as flat tensors on ``device``: ``z``, ``pos``,
    ``mol`` (each atom's molecule), ``recv``/``send`` (every edge, global
    atom ids), ``angles`` (global (i, j, k)), the per-molecule ``sizes``
    and ``offsets``, and whichever of ``esp``, ``esp_grad``,
    ``total_charge``, ``energy``, ``force``, ``charge`` the graphs hold;
    coordinates and labels in ``dtype``."""

    def __init__(self, graphs: Sequence[dict], device, dtype=torch.float64):
        sizes = [len(g["node_number"]) for g in graphs]
        off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.n_mol, self.sizes, self.offsets = len(graphs), sizes, off.tolist()

        def cat(key, shift=False, dtype=None):
            parts = [np.asarray(g[key]) + (o if shift else 0) for g, o in zip(graphs, off)]
            t = torch.as_tensor(np.concatenate(parts), device=device)
            return t.to(dtype) if dtype is not None else t

        self.z = cat("node_number", dtype=torch.long)
        self.pos = cat("node_coordinates", dtype=dtype)
        self.mol = torch.as_tensor(np.repeat(np.arange(len(graphs)), sizes), device=device)
        ei = cat("edge_indices", shift=True, dtype=torch.long)
        self.recv, self.send = ei[:, 0], ei[:, 1]
        if "angle_indices_nodes" in graphs[0]:
            self.angles = cat("angle_indices_nodes", shift=True, dtype=torch.long)
        for key in ("esp", "esp_grad", "charge", "force"):
            if key in graphs[0]:
                setattr(self, key, cat(key, dtype=dtype))
        for key in ("energy", "total_charge"):
            if key in graphs[0]:
                setattr(self, key, cat(key, dtype=dtype).reshape(len(graphs)))

    @property
    def n_atoms(self) -> int:
        return self.z.shape[0]


def shifted_softplus(x: Tensor) -> Tensor:
    """``log(1 + e^x) - log 2``, written so that every derivative is finite."""
    return torch.relu(x) + torch.log1p(torch.exp(-x.abs())) - math.log(2.0)


REFERENCE_DTYPE = torch.float64


def as_reference(weights: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The benchmark's float32 weights in the reference's precision."""
    return {k: v.to(REFERENCE_DTYPE) for k, v in weights.items()}


def to_tf32(x: Tensor) -> Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even),
    as the tensor cores read a float32 matmul's inputs; the rounding passes
    gradients through unchanged."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x).detach()


def matmul_exact(a: Tensor, b: Tensor) -> Tensor:
    return torch.matmul(a, b)


def matmul_tf32(a: Tensor, b: Tensor) -> Tensor:
    """A forward matmul in TF32 on any device: inputs rounded to 10
    mantissa bits, products summed in float32. Its reverse passes stay
    float32, so it errs less than the card's TF32 mode, which rounds those
    too; on the card the control takes that mode itself
    (``control_precision``)."""
    return torch.matmul(to_tf32(a), to_tf32(b))


MATMULS = {"exact": matmul_exact, "tf32": matmul_tf32}


@contextlib.contextmanager
def control_precision(device):
    """The control's precision, the nearest below the configurations'
    float32 with TF32 off: float32 inputs and weights, and on a CUDA device
    TF32 switched on for every matmul, forward and reverse (yields
    ``matmul_exact``); elsewhere the emulation ``matmul_tf32``."""
    if torch.device(device).type != "cuda":
        yield matmul_tf32
        return
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield matmul_exact
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def mae(pred: Tensor, target: Tensor) -> Tensor:
    return (pred - target).abs().mean()


def force_loss(out: Dict[str, Tensor], mols: Molecules, cfg: dict) -> Tensor:
    """The fork's loss: the charge, energy and force MAEs weighted by the
    configuration's weights, each divided by their sum."""
    w = {k: cfg[f"{k}_loss_weight"] for k in ("charge", "energy", "force")}
    total = sum(w.values())
    loss = w["energy"] / total * mae(out["energy"], mols.energy) \
        + w["force"] / total * mae(out["force"], mols.force)
    if w["charge"] > 0:
        loss = loss + w["charge"] / total * mae(out["charge"], mols.charge)
    return loss


def follow_steps(loss_fn: Callable[[Dict[str, Tensor], Molecules], Tensor],
                 weights: Dict[str, Tensor], batches: List[Molecules], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam steps from ``weights``, one a batch, by Adam's formula:
    ``m = b1 m + (1-b1) g``, ``v = b2 v + (1-b2) g^2``, ``p -= lr mhat /
    (sqrt(vhat) + eps)``. Returns ``(losses, first gradients' norms by leaf,
    the first gradients, the parameters after the last step)``."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, g1 = [], None
    for t, mols in enumerate(batches, start=1):
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        loss = loss_fn(leaves, mols)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            new = {}
            for k, p in leaves.items():
                m[k] = betas[0] * m[k] + (1 - betas[0]) * grads[k]
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * grads[k] ** 2
                mhat = m[k] / (1 - betas[0] ** t)
                vhat = v2[k] / (1 - betas[1] ** t)
                new[k] = p.detach() - lr * mhat / (vhat.sqrt() + eps)
        params = new
        del loss, grads, leaves
    return losses, {k: float(g.norm()) for k, g in g1.items()}, g1, params
