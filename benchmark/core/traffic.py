"""The one traffic generator: every traffic mix is a JSON file of
parameters that this module reads.

A mix is a pool of batches of molecular frames, all made from ``--seed``:
one molecule of a fixed composition (the elements permuted by the seed) in
a base geometry, then each frame the base jittered by a normal draw, as
the frames of an MD trajectory (rMD17) are. Every seed gives the same
sizes: the atom count, the composition and the geometry's rule are the
mix's, and only positions and labels move. Base geometries:

- ``packed``: the first ``atoms`` points of a cubic grid of ``spacing``,
  each moved by a uniform draw of up to ``placement`` (a copy of the
  synthetic MD dataset's ``_packed_positions``);
- ``chain``: a gently curved chain, atoms ``spacing`` apart, moved by a
  normal draw of ``placement`` (a copy of ``chip_smoke.large_mol_graph``'s
  geometry).

Neighbours and angles are this module's own plain numpy lists, built with
the configuration's rule: receivers closer than ``cutoff``, at most
``max_neighbours`` each (the nearest, ties by index), and for every centre
the ordered pairs of distinct neighbours. With ``need_esp`` every frame
carries an ESP and its gradient and a total charge of 0. A training mix
adds labels: the energy and exact forces of a Morse-like pair potential (a
copy of the synthetic MD dataset's ``_pair_potential``) and, with
``need_esp``, charges summing to 0.

Keys of a mix: ``mode`` (``train`` or ``eval``), ``molecule``
(``shape``, ``atoms``, ``composition`` {atomic number: count},
``spacing``, ``placement``), ``frame_jitter``, ``frames_per_batch``,
``pool_batches``, ``trace_batches`` (steps or evaluations in the traced
window).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# the streams of one seed: the molecule, the frames, the labels
_MOLECULE, _FRAMES, _LABELS = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """One of the seed's independent streams; any whole number is a seed."""
    return np.random.default_rng([stream, int(seed) % 2**64])


def molecule(mol: dict, seed: int):
    """``(z (n,), base positions (n, 3))`` of the mix's molecule."""
    r = rng(seed, _MOLECULE)
    n = int(mol["atoms"])
    z = np.concatenate([np.full(int(c), int(el), dtype=np.int64)
                        for el, c in sorted(mol["composition"].items(), key=lambda kv: int(kv[0]))])
    if len(z) != n:
        raise ValueError(f"composition has {len(z)} atoms, the molecule {n}")
    z = r.permutation(z)
    s = float(mol["spacing"])
    if mol["shape"] == "packed":
        side = int(np.ceil(n ** (1 / 3)))
        grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                        axis=-1).reshape(-1, 3)[:n]
        pos = grid * s + r.random((n, 3)) * float(mol["placement"])
    elif mol["shape"] == "chain":
        t = np.arange(n) * s
        pos = np.stack([t, 2.0 * np.sin(t * 0.05), 2.0 * np.cos(t * 0.03)], axis=1)
        pos = pos + r.normal(size=(n, 3)) * float(mol["placement"])
    else:
        raise ValueError(f"unknown molecule shape {mol['shape']!r}")
    return z, pos


def neighbour_mask(d: np.ndarray, cutoff: float, max_neighbours: int) -> np.ndarray:
    """``(F, n, n)`` receiver-by-sender mask of frames' distances ``d``:
    senders closer than ``cutoff``, at most ``max_neighbours`` a receiver
    (the nearest; the self entry at distance 0 is among the
    ``max_neighbours + 1`` smallest and is then dropped)."""
    f, n, _ = d.shape
    keep = d < cutoff
    if max_neighbours + 1 < n:
        near = np.argpartition(d, max_neighbours, axis=2)[:, :, :max_neighbours + 1]
        capped = np.zeros_like(keep)
        np.put_along_axis(capped, near, True, axis=2)
        keep &= capped
    keep[:, np.arange(n), np.arange(n)] = False
    return keep


def angles(edges: np.ndarray) -> np.ndarray:
    """``(A, 3)`` (i, j, k): for each centre i the ordered pairs of its
    distinct neighbours j != k, centres ascending."""
    order = np.argsort(edges[:, 0], kind="stable")
    recv, send = edges[order, 0], edges[order, 1]
    centres, starts, counts = np.unique(recv, return_index=True, return_counts=True)
    per = counts * (counts - 1)
    grp = np.repeat(np.arange(len(centres)), per)
    # pair p of a centre with m neighbours: j at p // (m-1), k at the
    # (p % (m-1))-th of the others
    p = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    m = counts[grp]
    a = p // np.maximum(m - 1, 1)
    b = p % np.maximum(m - 1, 1)
    b = b + (b >= a)
    return np.stack([centres[grp], send[starts[grp] + a], send[starts[grp] + b]],
                    axis=1).astype(np.int64)


def distances(pos: np.ndarray) -> np.ndarray:
    """``(F, n, n)`` pair distances of frames ``pos (F, n, 3)``, float64."""
    pos = pos.astype(np.float64)
    sq = (pos * pos).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * pos @ pos.transpose(0, 2, 1)
    return np.sqrt(np.maximum(d2, 0.0))


def pair_potential(pos: np.ndarray, d: np.ndarray, z: np.ndarray):
    """Energy and exact forces of a Morse-like pair potential weighted by
    ``sqrt(z_i z_j)``, for frames ``pos (F, n, 3)`` with distances ``d``:
    ``(F,), (F, n, 3)``."""
    n = pos.shape[1]
    eye = np.eye(n, dtype=bool)
    d = np.where(eye, 1.0, d)
    w = np.sqrt(np.outer(z, z).astype(np.float64))
    ex = np.exp(-1.2 * (d - 1.5))
    e_mat = np.where(eye, 0.0, w * (ex ** 2 - 2 * ex))
    # F_i = -sum_j dE/dr_ij (r_i - r_j) / r_ij
    c = np.where(eye, 0.0, w * (-2.4 * ex ** 2 + 2.4 * ex) / d)
    pos = pos.astype(np.float64)
    forces = -(c.sum(axis=2)[..., None] * pos - c @ pos)
    return 0.5 * e_mat.sum(axis=(1, 2)), forces


def make_pool(traffic: dict, cfg: dict, seed: int) -> List[List[Dict[str, np.ndarray]]]:
    """The mix's pool: ``pool_batches`` batches of ``frames_per_batch``
    frames, each a dict of numpy arrays in the port's graph format."""
    z, base = molecule(traffic["molecule"], seed)
    n = len(z)
    nb, nf = int(traffic["pool_batches"]), int(traffic["frames_per_batch"])
    frames = base[None] + rng(seed, _FRAMES).normal(size=(nb * nf, n, 3)) \
        * float(traffic["frame_jitter"])
    frames = frames.astype(np.float32)
    lab = rng(seed, _LABELS)
    train = traffic["mode"] == "train"
    graphs = []
    chunk = max(1, (1 << 22) // (n * n))  # frames whose pair tables are made at once
    for f0 in range(0, nb * nf, chunk):
        pos = frames[f0:f0 + chunk]
        d = distances(pos)
        mask = neighbour_mask(d, float(cfg["cutoff"]), int(cfg["max_neighbours"]))
        if train:
            energy, force = pair_potential(pos, d, z)
        for f in range(pos.shape[0]):
            recv, send = np.nonzero(mask[f])
            ei = np.stack([recv, send], axis=1).astype(np.int64)
            g = {"node_number": z, "node_coordinates": pos[f], "edge_indices": ei}
            if train:
                g["energy"] = energy[f:f + 1].astype(np.float32)
                g["force"] = force[f].astype(np.float32)
            if cfg.get("need_angles"):
                g["angle_indices_nodes"] = angles(ei)
            if cfg.get("need_esp"):
                q = lab.normal(size=n) * 0.1
                if train:
                    g["charge"] = (q - q.mean()).astype(np.float32)
                g["esp"] = (lab.normal(size=n) * 0.01).astype(np.float32)
                g["esp_grad"] = (lab.normal(size=(n, 3)) * 0.01).astype(np.float32)
                g["total_charge"] = np.zeros((1,), dtype=np.float32)
            graphs.append(g)
    return [graphs[b * nf:(b + 1) * nf] for b in range(nb)]


def real_counts(graphs: List[Dict[str, np.ndarray]]) -> Dict[str, object]:
    """The real sizes of one batch, for the FLOP counts: graphs, atoms a
    graph, edges and angles."""
    return {"graphs": len(graphs),
            "atoms": [int(len(g["node_number"])) for g in graphs],
            "edges": int(sum(len(g["edge_indices"]) for g in graphs)),
            "angles": int(sum(len(g.get("angle_indices_nodes", ())) for g in graphs))}
