"""ACSF on a periodic batch: the port's ``ACSFG2``/``ACSFG4`` against the JAX
layers and an explicit-image numpy oracle, on the crystal cells of
``train_crystal`` (``chip_smoke.py`` phase 27's structures, their radius
bonds with ``range_image``), on the CPU.

The oracle places each neighbour explicitly at its lattice image and sums
the symmetry functions in float64. It pins what both packages compute:

- ``ACSFG2`` measures an edge as ``x_i - x_j + image @ L``
  (``layers/conv/acsf.py``, JAX ``acsf.py:170-171``): the distance to the
  sender's image at ``-image``. ``edge_vectors`` (JAX ``geometry.py:49-57``)
  and ``set_range_periodic`` take the sender at ``+image``; the two agree
  only where the image is 0 or the edge joins an atom to itself.
- ``ACSFG4`` applies no image (JAX ``acsf.py:330-333``): each angle's
  neighbours sit in the home cell, and a neighbour that is the centre's
  own image lies on the centre (length ``sqrt(1e-12)``, the layers'
  guard).

Both are the reference's behaviour, which the port keeps; the oracle with
the sender at ``+image`` (the lengths the neighbour list cut at its radius)
differs from them on these cells.
"""
import numpy as np
import torch

import jax

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers.conv.acsf import ACSFG2 as JACSFG2, ACSFG4 as JACSFG4
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers.conv.acsf import ACSFG2, ACSFG4
from gcnn_keras_tpu_torch.scripts import train_crystal

torch.set_num_threads(1)

ELEMENTS = [3, 8, 13, 14, 26]  # train_crystal's elements
G2_KW = dict(eta=[0.0, 0.3], rs=[0.0, 3.0], rc=4.0)
G4_KW = dict(eta=[0.0, 0.3], zeta=[1.0, 8.0], lamda=[-1.0, 1.0], rc=4.0, multiplicity=2.0)
TOL = 1e-5  # float32 against float64: max|a - b| <= TOL * (1 + max|b|)


def _fc(r, rc):
    return 0.5 * (np.cos(np.minimum(r, rc) * np.pi / rc) + 1.0)


def _g2_oracle(g, table, sign):
    """G2 of every atom, each neighbour at ``x_j + sign * image @ L``."""
    x, z = np.float64(g["node_coordinates"]), np.asarray(g["node_number"])
    lat = np.float64(g["graph_lattice"])
    m = table.shape[1]
    out = np.zeros((len(z), len(ELEMENTS) * m))
    for (i, j), img in zip(g["edge_indices"], g["range_image"]):
        r = np.linalg.norm(x[i] - (x[j] + sign * img @ lat))
        rel = ELEMENTS.index(z[j])
        eta, rs, rc = np.float64(table[rel]).T
        out[i, rel * m:(rel + 1) * m] += np.exp(-eta * (r - rs) ** 2) * _fc(r, rc)
    return out


def _g4_oracle(g, table, rev_pair, multiplicity, sign):
    """G4 of every atom over the ordered pairs of its edges to two other
    atoms (``set_angle``'s triples), each neighbour at ``x + sign * image @
    L``."""
    x, z = np.float64(g["node_coordinates"]), np.asarray(g["node_number"])
    lat = np.float64(g["graph_lattice"])
    n_pairs, m = table.shape[:2]
    out = np.zeros((len(z), n_pairs * m))
    ei, images = np.asarray(g["edge_indices"]), np.asarray(g["range_image"])
    for i in range(len(z)):
        mine = np.nonzero(ei[:, 0] == i)[0]
        for e1 in mine:
            for e2 in mine:
                j, k = ei[e1, 1], ei[e2, 1]
                if e1 == e2 or j == k:
                    continue
                pj = x[j] + sign * images[e1] @ lat
                pk = x[k] + sign * images[e2] @ lat
                vij, vik, vjk = pj - x[i], pk - x[i], pk - pj
                # the layers' guarded length: an edge to the centre's own image
                # is 0 long without its image
                rij, rik, rjk = (np.sqrt(max(v @ v, 1e-12)) for v in (vij, vik, vjk))
                pair = rev_pair[z[j], z[k]]
                eta, zeta, lam, rc = np.float64(table[pair]).T
                cos = vij @ vik / rij / rik
                rep = (2.0 ** (1.0 - zeta) * np.maximum(cos * lam + 1.0, 1e-30) ** zeta
                       * np.exp(-eta * (rij ** 2 + rik ** 2 + rjk ** 2))
                       * _fc(rij, rc) * _fc(rik, rc) * _fc(rjk, rc)) / multiplicity
                out[i, pair * m:(pair + 1) * m] += rep
    return out


def _close(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.abs(a - b).max() <= TOL * (1.0 + np.abs(b).max())


def test_acsf_on_periodic_cells_matches_jax_and_the_image_oracle():
    graphs = [jpre.set_angle(g, range_indices="edge_indices")
              for g in train_crystal.synthetic_crystals(6, 42)]
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    assert "range_image" in tb.edges and any(np.abs(g["range_image"]).sum() for g in graphs)
    n_real = [len(g["node_number"]) for g in graphs]

    def per_graph(out):
        out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        return np.split(out[:sum(n_real)], np.cumsum(n_real)[:-1])

    kw2 = JACSFG2.make_param_table(**G2_KW, elements=ELEMENTS)
    jlayer = JACSFG2(**kw2)
    ref = np.asarray(jlayer.apply(jlayer.init(jax.random.PRNGKey(0), jb), jb))
    ours = ACSFG2(**kw2)(tb)
    assert _close(ours, ref)
    table2 = np.asarray(kw2["eta_rs_rc"])
    for g, got in zip(graphs, per_graph(ours)):
        assert _close(got, _g2_oracle(g, table2, sign=-1.0))  # the sender at -image
    physical = np.concatenate([_g2_oracle(g, table2, sign=1.0) for g in graphs])
    assert not _close(np.concatenate(per_graph(ours)), physical)

    kw4 = JACSFG4.make_param_table(**G4_KW, elements=ELEMENTS)
    jlayer = JACSFG4(**kw4)
    ref = np.asarray(jlayer.apply(jlayer.init(jax.random.PRNGKey(0), jb), jb))
    layer = ACSFG4(**kw4)
    ours = layer(tb)
    assert _close(ours, ref)
    table4, rev_pair = np.asarray(kw4["eta_zeta_lambda_rc"]), layer._pair_maps()[1]
    for g, got in zip(graphs, per_graph(ours)):
        assert _close(got, _g4_oracle(g, table4, rev_pair, G4_KW["multiplicity"], sign=0.0))
    physical = np.concatenate([_g4_oracle(g, table4, rev_pair, G4_KW["multiplicity"], 1.0)
                               for g in graphs])
    assert not _close(np.concatenate(per_graph(ours)), physical)
