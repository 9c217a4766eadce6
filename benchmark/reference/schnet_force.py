"""Plain reference of the ``schnet-force`` configuration: SchNet (Schuett et
al. 2017) as the fork's ``force_schnet.py`` builds it, its forces by
autograd, and the fork's force loss.

Per molecule: an embedding of the atomic numbers, a dense map to the
interaction width, then ``depth`` interactions, each
``x + post_2(ssp(post_1(cfconv(pre(x)))))`` with ``cfconv`` summing, over a
receiver's neighbours j, ``x_j * filter_2(ssp(filter_1(gauss(d_ij))))``;
the last MLP on every atom, the sum over the molecule's atoms, the output
MLP. ``gauss(d) = exp(-(d - offset - c_k)^2 / (2 sigma^2))`` with centres
``c_k = k / bins * distance_max``. Forces are ``-dE/dr``. The size of an
energy, against which its gap is judged, is that of the terms the output
layer sums: ``sum_k |h_k w_k| + |b|``.

Plain PyTorch, in float64 for the check and float32 for the control
(``common``); ``mm`` is the matmul (``common.MATMULS``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from benchmark.reference.common import Molecules, force_loss, shifted_softplus

Tensor = torch.Tensor


def _dense(w: Dict[str, Tensor], name: str, x: Tensor, mm: Callable, act=None) -> Tensor:
    y = mm(x, w[f"{name}.weight"].t())
    if f"{name}.bias" in w:
        y = y + w[f"{name}.bias"]
    return act(y) if act is not None else y


def energies(w: Dict[str, Tensor], mols: Molecules, pos: Tensor, cfg: dict,
             mm: Callable) -> Tuple[Tensor, Tensor]:
    """``(n_mol,)`` energies at positions ``pos``, and the size of each: the
    sum of the magnitudes of the terms that the output layer sums."""
    m = cfg["model"]
    vec = pos[mols.recv] - pos[mols.send]
    d = torch.sqrt((vec * vec).sum(-1, keepdim=True))
    centres = torch.arange(m["gauss_bins"], dtype=pos.dtype, device=pos.device) \
        / m["gauss_bins"] * m["gauss_distance_max"]
    basis = torch.exp(-0.5 / m["gauss_sigma"] ** 2 * (d - m["gauss_offset"] - centres) ** 2)
    x = _dense(w, "embed_to_units", w["embedding.weight"][mols.z], mm)
    for i in range(m["depth"]):
        p = f"interaction_{i}"
        filt = _dense(w, f"{p}.cfconv.filter_2",
                      _dense(w, f"{p}.cfconv.filter_1", basis, mm, shifted_softplus), mm)
        h = _dense(w, f"{p}.pre", x, mm)
        agg = torch.zeros_like(h).index_add_(0, mols.recv, h[mols.send] * filt)
        x = x + _dense(w, f"{p}.post_2", _dense(w, f"{p}.post_1", agg, mm, shifted_softplus), mm)
    for k in range(len(m["last_mlp"])):
        x = _dense(w, f"last_mlp.dense_{k}", x, mm, shifted_softplus)
    pooled = torch.zeros(mols.n_mol, x.shape[1], dtype=x.dtype, device=x.device) \
        .index_add_(0, mols.mol, x)
    last = len(m["output_mlp"]) - 1
    for k in range(last):
        pooled = _dense(w, f"output_mlp.dense_{k}", pooled, mm, shifted_softplus)
    kern, bias = w[f"output_mlp.dense_{last}.weight"], w[f"output_mlp.dense_{last}.bias"]
    scale = pooled.detach().abs() @ kern.detach().abs().t() + bias.detach().abs()
    return _dense(w, f"output_mlp.dense_{last}", pooled, mm)[:, 0], scale[:, 0]


def predict(w: Dict[str, Tensor], mols: Molecules, cfg: dict, mm: Callable,
            create_graph: bool = False) -> Dict[str, Tensor]:
    """``{"energy" (n_mol,), "force" (n_atoms, 3), "energy_scale" (n_mol,)}``."""
    with torch.enable_grad():
        pos = mols.pos.detach().requires_grad_(True)
        e, scale = energies(w, mols, pos, cfg, mm)
        (de_dr,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph)
    return {"energy": e, "force": -de_dr, "energy_scale": scale}


def loss(w: Dict[str, Tensor], mols: Molecules, cfg: dict, mm: Callable) -> Tensor:
    return force_loss(predict(w, mols, cfg, mm, create_graph=True), mols, cfg)
