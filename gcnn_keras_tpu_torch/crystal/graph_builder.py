"""Crystal graph builders; counterpart of
``gcnn_keras_tpu/crystal/graph_builder.py``, copied so that the port
imports nothing of the JAX package (kgcnn's ``crystal/graph_builder.py``:
add_knn_bonds, add_radius_bonds, add_voronoi_bonds, remove_duplicate_edges,
to_supercell_graph, to_asymmetric_unit_graph, add_edge_information; and
the hashable preprocessors of its ``crystal/base.py``).

Works on a plain dict {``frac_coords`` or ``node_coordinates``,
``graph_lattice`` (3,3) rows = lattice vectors, ``node_number``}; a
pymatgen ``Structure`` is read by duck typing (``cart_coords``,
``frac_coords``, ``lattice.matrix``, the sites' ``specie.Z``), so pymatgen
need not be installed. Edge conventions are the batch's:
``range_indices`` rows are ``[receiver, sender]``, ``range_image`` is the
integer lattice image of the SENDER, the distance ``|x_r - (x_s + image @
L)|``. The neighbour lists are ``set_range_periodic``'s dense numpy path;
the Voronoi bonds come from scipy. Full space-group symmetrization needs
pyxtal (gated, like kgcnn's own import); without it ``symmetrize_graph``
gives kgcnn's documented fallback: spacegroup 1 with identity symmops.
"""
from __future__ import annotations

from hashlib import md5
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from ..graph.preprocess import set_range_periodic


def _as_struct_dict(structure) -> Dict[str, np.ndarray]:
    if isinstance(structure, dict):
        d = dict(structure)
        lat = np.asarray(d.get("graph_lattice", d.get("lattice")))
        d["graph_lattice"] = lat
        if "frac_coords" not in d:
            cart = np.asarray(d.get("node_coordinates", d.get("cart_coords")))
            d["frac_coords"] = cart @ np.linalg.inv(lat)
        if "node_coordinates" not in d:
            d["node_coordinates"] = np.asarray(d["frac_coords"]) @ lat
        if "node_number" not in d:
            d["node_number"] = np.asarray(d["atomic_numbers"])
        return d
    # pymatgen Structure duck-typing
    return {
        "node_coordinates": np.array(structure.cart_coords),
        "frac_coords": np.array(structure.frac_coords),
        "graph_lattice": np.array(structure.lattice.matrix),
        "node_number": np.array([s.specie.Z for s in structure.sites]),
    }


def _to_unit_cell(frac: np.ndarray) -> np.ndarray:
    """Fractional coordinates into [0, 1) (kgcnn's ``_to_unit_cell``)."""
    return frac % 1.0 % 1.0


def structure_to_graph(structure, symmetrize: bool = False) -> Dict[str, np.ndarray]:
    """Structure -> GraphDict properties, no bonds yet
    (``structure_to_empty_graph``, kgcnn graph_builder.py:95)."""
    s = _as_struct_dict(structure)
    frac = _to_unit_cell(np.asarray(s["frac_coords"], dtype=np.float64))
    lat = np.asarray(s["graph_lattice"], dtype=np.float64)
    g = {
        "node_number": np.asarray(s["node_number"], dtype=np.int64),
        "node_frac_coordinates": frac.astype(np.float32),
        "node_coordinates": (frac @ lat).astype(np.float32),
        "graph_lattice": lat.astype(np.float32),
    }
    if symmetrize:
        g = symmetrize_graph(g)
    return g


def symmetrize_graph(graph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Attach symmetry info (``get_symmetrized_graph``, kgcnn graph_builder.py:13).

    With pyxtal installed, detects the space group and Wyckoff orbits; the
    gated fallback (kgcnn's except-branch, :18-33) assigns
    trivial spacegroup 1: every site is its own asymmetric-unit
    representative with an identity symmop and multiplicity 1.
    """
    g = dict(graph)
    n = len(g["node_number"])
    try:  # pragma: no cover - pyxtal is optional
        from pyxtal import pyxtal
        from pymatgen.core.structure import Structure
        lat = np.asarray(g["graph_lattice"], dtype=np.float64)
        struct = Structure(lat, [int(z) for z in g["node_number"]],
                           np.asarray(g["node_frac_coordinates"]))
        cell = pyxtal()
        cell.from_seed(struct)
        numbers, fracs, amap, ops, mult = [], [], [], [], []
        from pymatgen.core.periodic_table import Element
        for site in cell.atom_sites:
            numbers += site.multiplicity * [Element(site.specie).Z]
            amap += site.multiplicity * [len(amap)]
            fracs.append(site.coords)
            ops += [op.affine_matrix for op in site.wp.ops]
            mult += site.multiplicity * [site.multiplicity]
        frac = _to_unit_cell(np.vstack(fracs))
        lat2 = cell.lattice.matrix
        g.update({
            "node_number": np.asarray(numbers, dtype=np.int64),
            "node_frac_coordinates": frac.astype(np.float32),
            "node_coordinates": (frac @ lat2).astype(np.float32),
            "graph_lattice": np.asarray(lat2, dtype=np.float32),
            "node_asymmetric_mapping": np.asarray(amap, dtype=np.int64),
            "node_symmop": np.asarray(ops, dtype=np.float32),
            "node_multiplicity": np.asarray(mult, dtype=np.int64),
            "spacegroup": np.array([cell.group.number], dtype=np.int64),
        })
        return g
    except ImportError:
        pass
    g["node_asymmetric_mapping"] = np.arange(n, dtype=np.int64)
    g["node_symmop"] = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    g["node_multiplicity"] = np.ones(n, dtype=np.int64)
    g["spacegroup"] = np.array([1], dtype=np.int64)
    return g


def add_radius_bonds(graph: Dict[str, np.ndarray], radius: float = 5.0,
                     max_neighbours: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Periodic radius neighbor list -> range_indices/range_image
    (kgcnn graph_builder.py:112)."""
    g = _as_struct_dict(graph)
    return set_range_periodic(g, max_distance=radius,
                              max_neighbours=max_neighbours)


def add_knn_bonds(graph: Dict[str, np.ndarray], k: int = 12,
                  search_radius: float = 8.0) -> Dict[str, np.ndarray]:
    """k-nearest periodic neighbors (kgcnn graph_builder.py:79); doubles the
    search radius until every node has k neighbors, like kgcnn."""
    g = _as_struct_dict(graph)
    radius = search_radius
    for _ in range(8):
        out = set_range_periodic(g, max_distance=radius, max_neighbours=k)
        ei = out["range_indices"]
        counts = np.bincount(ei[:, 0], minlength=len(g["node_number"]))
        if counts.min() >= min(k, len(g["node_number"])):
            return out
        radius *= 2.0
    return out


def add_voronoi_bonds(graph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Voronoi-ridge bonds (kgcnn graph_builder.py:142): atoms are neighbors iff
    their Voronoi cells share a ridge, computed on the 3x3x3 supercell and
    restricted to edges ENDING at a center-cell atom."""
    from scipy.spatial import Voronoi

    g = _as_struct_dict(graph)
    lat = np.asarray(g["graph_lattice"], dtype=np.float64)
    frac = _to_unit_cell(np.asarray(g["frac_coords"], dtype=np.float64))
    n = frac.shape[0]

    offs = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                    axis=-1).reshape(-1, 3)          # (27, 3)
    center = int(np.argwhere(np.all(offs == 0, axis=1))[0, 0])
    expanded = (frac[None, :, :] + offs[:, None, :]).reshape(-1, 3)  # (27n, 3)
    vor = Voronoi(expanded @ lat)
    rp = vor.ridge_points                              # (R, 2) flat indices
    cell = rp // n
    atom = rp % n

    tgt_center = cell[:, 1] == center  # edges p0 -> p1(center)
    src_center = cell[:, 0] == center  # swapped: p1 -> p0(center)
    senders = np.concatenate([atom[tgt_center, 0], atom[src_center, 1]])
    sender_cells = np.concatenate([cell[tgt_center, 0], cell[src_center, 1]])
    receivers = np.concatenate([atom[tgt_center, 1], atom[src_center, 0]])
    images = offs[sender_cells]

    cart = frac @ lat
    vec = cart[receivers] - (cart[senders] + images @ lat)
    dist = np.linalg.norm(vec, axis=-1)

    order = np.lexsort((senders, receivers))
    out = dict(g)
    out["range_indices"] = np.stack([receivers, senders], axis=1)[order] \
        .astype(np.int64)
    out["range_image"] = images[order].astype(np.int64)
    out["range_attributes"] = dist[order, None].astype(np.float32)
    return out


def remove_duplicate_edges(graph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop repeated (receiver, sender, image) rows (kgcnn graph_builder.py:183)."""
    ei = np.asarray(graph["range_indices"])
    img = np.asarray(graph.get("range_image",
                               np.zeros((len(ei), 3), dtype=np.int64)))
    key = np.concatenate([ei, img], axis=1)
    _, keep = np.unique(key, axis=0, return_index=True)
    keep = np.sort(keep)
    out = dict(graph)
    out["range_indices"] = ei[keep]
    if "range_image" in graph:
        out["range_image"] = img[keep]
    if "range_attributes" in graph:
        out["range_attributes"] = np.asarray(graph["range_attributes"])[keep]
    return out


def add_edge_information(graph: Dict[str, np.ndarray], frac_offset: bool = False,
                         offset: bool = True, distance: bool = True) -> Dict[str, np.ndarray]:
    """Compute frac_offset/offset/distance per edge from the stored
    coordinates + images (kgcnn graph_builder.py:275)."""
    g = _as_struct_dict(graph)
    lat = np.asarray(g["graph_lattice"], dtype=np.float64)
    frac = np.asarray(g["frac_coords"], dtype=np.float64)
    ei = np.asarray(g["range_indices"])
    img = np.asarray(g.get("range_image", np.zeros((len(ei), 3))))
    recv, send = ei[:, 0], ei[:, 1]
    # kgcnn: frac_offset = frac(target) - (frac(source) + translation)
    foff = frac[recv] - (frac[send] + img)
    off = foff @ lat
    out = dict(graph)
    if frac_offset:
        out["range_frac_offset"] = foff.astype(np.float32)
    if offset:
        out["range_offset"] = off.astype(np.float32)
    if distance:
        out["range_attributes"] = np.linalg.norm(off, axis=-1)[:, None] \
            .astype(np.float32)
    return out


def to_supercell_graph(graph: Dict[str, np.ndarray],
                       size: Sequence[int]) -> Dict[str, np.ndarray]:
    """Unroll a periodic unit-cell graph into an explicit supercell graph
    (kgcnn graph_builder.py:311): node (c1,c2,c3,a) for every cell in ``size``;
    an edge maps into every cell where its translated source cell stays in
    bounds (so the supercell graph is open-boundary, like kgcnn's)."""
    g = _as_struct_dict(graph)
    size = list(size)
    n = len(g["node_number"])
    dims = size + [n]
    lat = np.asarray(g["graph_lattice"], dtype=np.float64)
    frac = np.asarray(g["frac_coords"], dtype=np.float64)

    cells = np.stack(np.meshgrid(*[np.arange(s) for s in size],
                                 indexing="ij"), axis=-1).reshape(-1, 3)
    new_frac = (frac[None, :, :] + cells[:, None, :]).reshape(-1, 3)
    out: Dict[str, np.ndarray] = {
        "node_number": np.tile(np.asarray(g["node_number"]), len(cells)),
        "node_frac_coordinates": new_frac.astype(np.float32),
        "node_coordinates": (new_frac @ lat).astype(np.float32),
        "graph_lattice": lat.astype(np.float32),
    }

    ei = np.asarray(g["range_indices"])
    img = np.asarray(g.get("range_image", np.zeros((len(ei), 3), np.int64)))
    recv, send = ei[:, 0], ei[:, 1]
    # for each base cell c: sender cell = c + image; keep if in bounds
    c_exp = cells[:, None, :]                       # (C, 1, 3)
    s_cell = c_exp + img[None, :, :]                # (C, E, 3)
    ok = np.all((s_cell >= 0) & (s_cell < np.asarray(size)[None, None, :]),
                axis=-1)                            # (C, E)
    ci, eidx = np.nonzero(ok)
    new_recv = np.ravel_multi_index(
        tuple(cells[ci].T) + (recv[eidx],), dims)
    new_send = np.ravel_multi_index(
        tuple(s_cell[ci, eidx].T.astype(np.int64)) + (send[eidx],), dims)
    order = np.lexsort((new_send, new_recv))
    out["range_indices"] = np.stack([new_recv, new_send], axis=1)[order] \
        .astype(np.int64)
    if "range_attributes" in g:
        out["range_attributes"] = np.asarray(g["range_attributes"])[eidx][order]
    return out


def to_asymmetric_unit_graph(graph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Collapse symmetry-equivalent nodes to Wyckoff representatives
    (kgcnn graph_builder.py:341): keep edges whose RECEIVER is a representative;
    each kept edge records the sender's symmop so the model can reconstruct
    equivalent positions."""
    if "node_asymmetric_mapping" not in graph:
        raise ValueError(
            "Graph does not contain symmetry informations. Build it with "
            "structure_to_graph(symmetrize=True).")
    amap = np.asarray(graph["node_asymmetric_mapping"])
    reps, inv = np.unique(amap, return_inverse=True)
    rep_index = {int(r): i for i, r in enumerate(reps)}

    out: Dict[str, np.ndarray] = {
        "node_number": np.asarray(graph["node_number"])[reps],
        "node_frac_coordinates":
            np.asarray(graph["node_frac_coordinates"])[reps],
        "node_coordinates": np.asarray(graph["node_coordinates"])[reps],
        "node_unit_cell_index": reps.astype(np.int64),
        "node_multiplicity": np.asarray(graph["node_multiplicity"])[reps],
        "graph_lattice": np.asarray(graph["graph_lattice"]),
        "spacegroup": np.asarray(graph.get("spacegroup", [1])),
    }
    if "range_indices" in graph:
        ei = np.asarray(graph["range_indices"])
        keep = np.isin(ei[:, 0], reps)
        recv = np.asarray([rep_index[int(r)] for r in ei[keep, 0]],
                          dtype=np.int64)
        send_orig = ei[keep, 1]
        send = inv[send_orig].astype(np.int64)
        out["range_indices"] = np.stack([recv, send], axis=1)
        if "range_image" in graph:
            out["range_image"] = np.asarray(graph["range_image"])[keep]
        if "range_attributes" in graph:
            out["range_attributes"] = \
                np.asarray(graph["range_attributes"])[keep]
        out["range_symmop"] = np.asarray(graph["node_symmop"])[send_orig]
    return out


# ------------------------------------------------------- preprocessors ----

class CrystalPreprocessor:
    """Hashable preprocessor config (``kgcnn/crystal/base.py:12``):
    equal configs hash equal — used to cache preprocessed datasets."""

    node_attributes: Sequence[str] = ()
    edge_attributes: Sequence[str] = ()
    graph_attributes: Sequence[str] = ()

    def __call__(self, structure) -> Dict[str, np.ndarray]:
        raise NotImplementedError()

    def get_config(self) -> Dict[str, Any]:
        config = {k: v for k, v in vars(self).items()
                  if not k.startswith("_")}
        config["preprocessor"] = self.__class__.__name__
        return config

    def hash(self) -> str:
        return md5(str(self.get_config()).encode()).hexdigest()

    def __hash__(self):
        return int(self.hash(), 16)

    def __eq__(self, other):
        return hash(self) == hash(other)


class RadiusUnitCell(CrystalPreprocessor):
    def __init__(self, radius: float = 3.0):
        self.radius = radius

    def __call__(self, structure):
        g = structure_to_graph(structure)
        g = add_radius_bonds(g, radius=self.radius)
        return add_edge_information(g)


class KNNUnitCell(CrystalPreprocessor):
    def __init__(self, k: int = 12):
        self.k = k

    def __call__(self, structure):
        g = structure_to_graph(structure)
        g = add_knn_bonds(g, k=self.k)
        return add_edge_information(g)


class VoronoiUnitCell(CrystalPreprocessor):
    def __call__(self, structure):
        g = structure_to_graph(structure)
        g = add_voronoi_bonds(g)
        return add_edge_information(g)


class RadiusSuperCell(CrystalPreprocessor):
    def __init__(self, radius: float = 3.0, size=(3, 3, 3)):
        self.radius = radius
        self.size = list(size)

    def __call__(self, structure):
        g = structure_to_graph(structure)
        g = add_radius_bonds(g, radius=self.radius)
        return to_supercell_graph(g, self.size)


class KNNSuperCell(CrystalPreprocessor):
    def __init__(self, k: int = 12, size=(3, 3, 3)):
        self.k = k
        self.size = list(size)

    def __call__(self, structure):
        g = structure_to_graph(structure)
        g = add_knn_bonds(g, k=self.k)
        return to_supercell_graph(g, self.size)


class VoronoiSuperCell(CrystalPreprocessor):
    def __init__(self, size=(3, 3, 3)):
        self.size = list(size)

    def __call__(self, structure):
        g = structure_to_graph(structure)
        g = add_voronoi_bonds(g)
        return to_supercell_graph(g, self.size)


class RadiusAsymmetricUnitCell(CrystalPreprocessor):
    def __init__(self, radius: float = 3.0):
        self.radius = radius

    def __call__(self, structure):
        g = structure_to_graph(structure, symmetrize=True)
        g = add_radius_bonds(g, radius=self.radius)
        return to_asymmetric_unit_graph(g)


class KNNAsymmetricUnitCell(CrystalPreprocessor):
    def __init__(self, k: int = 12):
        self.k = k

    def __call__(self, structure):
        g = structure_to_graph(structure, symmetrize=True)
        g = add_knn_bonds(g, k=self.k)
        return to_asymmetric_unit_graph(g)


class VoronoiAsymmetricUnitCell(CrystalPreprocessor):
    def __call__(self, structure):
        g = structure_to_graph(structure, symmetrize=True)
        g = add_voronoi_bonds(g)
        return to_asymmetric_unit_graph(g)
