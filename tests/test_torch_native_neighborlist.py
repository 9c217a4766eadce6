"""The port's C++ neighbour list (``gcnn_keras_tpu_torch/native``, the
repository's ``native/neighborlist.cpp``) and the ``set_range`` /
``set_range_periodic`` switch to it, against the JAX package's dense
(``backend="numpy"``) lists on the CPU.

The JAX package's own native loader is never called here: it builds into
a directory shared by every process, and the JAX ``ScannedMD`` below is
pointed at its dense path. Indices and images are equal (both paths sort
by receiver and sender, then image), distances within ``DIST_RTOL``;
where a neighbour cap cuts through a tie the per-receiver distance sets
agree. MD positions and kinetic energies within ``MD_ATOL`` (float32
through a trajectory, as ``tests/test_torch_moldyn.py``), the potential
energy of 264 atoms within ``E_RTOL`` of itself (a float32 sum of 264
terms in another order).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu import native as jnative
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.moldyn.trajectory import ScannedMD as JScannedMD
from gcnn_keras_tpu_torch import native
from gcnn_keras_tpu_torch.graph import preprocess as pre
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIST_RTOL = 1e-6
MD_ATOL = 1e-5
E_RTOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def library():
    if not native.available():
        pytest.skip("no C++ compiler: the native neighbour list cannot be built")


def molecule(n, seed=None):
    """``tests/test_native_neighborlist.py``'s random cloud of ``n`` atoms."""
    rs = np.random.RandomState(n if seed is None else seed)
    return {"node_coordinates": rs.rand(n, 3) * (n / 20.0) ** (1 / 3) * 3}


def crystal(n):
    rs = np.random.RandomState(n)
    lat = np.diag([8.0, 9.0, 10.0]) + rs.rand(3, 3) * 0.5  # triclinic
    return {"node_coordinates": rs.rand(n, 3) @ lat, "graph_lattice": lat}


def same_lists(got, ref, keys):
    assert sorted(got) == sorted(ref)
    for key in keys:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["range_attributes"].dtype == ref["range_attributes"].dtype == np.float32
    np.testing.assert_allclose(got["range_attributes"], ref["range_attributes"],
                               rtol=DIST_RTOL, atol=0)


@pytest.mark.parametrize("n,cutoff,k", [(50, 2.5, 50), (300, 2.0, 12), (1200, 1.5, 25)])
@pytest.mark.parametrize("invert", [False, True], ids=["distance", "inverse"])
def test_native_matches_the_jax_dense_path(n, cutoff, k, invert):
    g = molecule(n)
    kw = dict(max_distance=cutoff, max_neighbours=k, do_invert_distance=invert)
    same_lists(pre.set_range(dict(g), backend="native", **kw),
               jpre.set_range(dict(g), backend="numpy", **kw), ("range_indices",))


@pytest.mark.parametrize("n,cutoff", [(20, 3.0), (60, 4.5), (250, 2.5)])
def test_periodic_native_matches_the_jax_dense_path(n, cutoff):
    g = crystal(n)
    same_lists(pre.set_range_periodic(dict(g), max_distance=cutoff, backend="native"),
               jpre.set_range_periodic(dict(g), max_distance=cutoff, backend="numpy"),
               ("range_indices", "range_image"))


def test_periodic_small_cell_keeps_self_images():
    """A cell smaller than the cutoff: many images, an atom's own images
    among its neighbours."""
    g = {"node_coordinates": np.array([[0.5, 0.5, 0.5], [1.2, 0.7, 0.3]]),
         "graph_lattice": np.diag([2.0, 2.0, 2.0])}
    got = pre.set_range_periodic(dict(g), max_distance=4.2, backend="native")
    same_lists(got, jpre.set_range_periodic(dict(g), max_distance=4.2, backend="numpy"),
               ("range_indices", "range_image"))
    assert (got["range_indices"][:, 0] == got["range_indices"][:, 1]).any()


@pytest.mark.parametrize("periodic", [False, True], ids=["molecule", "periodic"])
def test_cap_keeps_the_closest(periodic):
    """Where the cap bites, each receiver keeps its closest neighbours: the
    per-receiver distance sets agree even where a tie is cut another way."""
    rs = np.random.RandomState(7 if not periodic else 11)
    if periodic:
        n, cap, lat = 80, 8, np.diag([7.0, 7.0, 7.0])
        g = {"node_coordinates": rs.rand(n, 3) @ lat, "graph_lattice": lat}
        got = pre.set_range_periodic(dict(g), max_distance=5.0, max_neighbours=cap,
                                     backend="native")
        ref = jpre.set_range_periodic(dict(g), max_distance=5.0, max_neighbours=cap,
                                      backend="numpy")
    else:
        n, cap = 400, 5
        g = {"node_coordinates": rs.rand(n, 3) * 4.0}
        got = pre.set_range(dict(g), max_distance=3.0, max_neighbours=cap, backend="native")
        ref = jpre.set_range(dict(g), max_distance=3.0, max_neighbours=cap, backend="numpy")
    assert (np.bincount(got["range_indices"][:, 0], minlength=n) == cap).all()
    for r in range(n):
        d_got = np.sort(got["range_attributes"][got["range_indices"][:, 0] == r, 0])
        d_ref = np.sort(ref["range_attributes"][ref["range_indices"][:, 0] == r, 0])
        np.testing.assert_allclose(d_got, d_ref, rtol=DIST_RTOL, atol=0)


def test_openmp_runs_are_deterministic():
    """The list is sorted after the parallel scan, so two runs (whatever
    the threads did) give the same arrays."""
    xyz = molecule(1200)["node_coordinates"]
    a, b = native.neighbor_list(xyz, 1.5, 25), native.neighbor_list(xyz, 1.5, 25)
    g = crystal(250)
    c, d = (native.neighbor_list_periodic(g["node_coordinates"], g["graph_lattice"], 2.5)
            for _ in range(2))
    for x, y in zip((*a, *c), (*b, *d)):
        np.testing.assert_array_equal(x, y)


def spy(monkeypatch, name):
    calls = []
    real = getattr(native, name)

    def counted(*args):
        calls.append(args[0].shape[0])
        return real(*args)
    monkeypatch.setattr(native, name, counted)
    return calls


@pytest.mark.parametrize("n", [255, 256, 300])
def test_auto_takes_the_native_list_from_256_atoms(n, monkeypatch):
    calls = spy(monkeypatch, "neighbor_list")
    g = molecule(n, seed=3)
    kw = dict(max_distance=2.0, max_neighbours=20)
    same_lists(pre.set_range(dict(g), **kw), jpre.set_range(dict(g), backend="numpy", **kw),
               ("range_indices",))
    assert calls == ([n] if n >= 256 else [])
    # what the C++ list does not cover takes the dense path at every size
    for other in (dict(exclusive=False), dict(self_loops=True), dict(max_neighbours=None)):
        kw2 = {**kw, **other}
        same_lists(pre.set_range(dict(g), **kw2),
                   jpre.set_range(dict(g), backend="numpy", **kw2), ("range_indices",))
    assert calls == ([n] if n >= 256 else [])


@pytest.mark.parametrize("n", [191, 192])
def test_auto_takes_the_periodic_native_list_from_192_atoms(n, monkeypatch):
    calls = spy(monkeypatch, "neighbor_list_periodic")
    g = crystal(n)
    kw = dict(max_distance=2.0)
    same_lists(pre.set_range_periodic(dict(g), **kw),
               jpre.set_range_periodic(dict(g), backend="numpy", **kw),
               ("range_indices", "range_image"))
    pre.set_range_periodic(dict(g), exclusive=False, **kw)
    assert calls == ([n] if n >= 192 else [])


def test_without_a_library_native_raises_and_auto_falls_back(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    g, c = molecule(300), crystal(250)
    with pytest.raises(RuntimeError, match="unavailable"):
        pre.set_range(dict(g), backend="native")
    with pytest.raises(RuntimeError, match="unavailable"):
        pre.set_range_periodic(dict(c), backend="native")
    kw = dict(max_distance=2.0, max_neighbours=12)
    same_lists(pre.set_range(dict(g), **kw), jpre.set_range(dict(g), backend="numpy", **kw),
               ("range_indices",))
    same_lists(pre.set_range_periodic(dict(c), max_distance=2.5),
               jpre.set_range_periodic(dict(c), max_distance=2.5, backend="numpy"),
               ("range_indices", "range_image"))


_BUILD_AND_LOAD = """
import sys
from pathlib import Path
import numpy as np
import gcnn_keras_tpu_torch.native as native
native.BUILD_DIR = Path(sys.argv[1])
pairs, dist = native.neighbor_list(np.random.RandomState(0).rand(40, 3) * 3, 1.5, 10)
print(native.available(), native.library_path().parent == native.BUILD_DIR, len(pairs))
"""


def test_two_interpreters_building_at_once_both_load(tmp_path):
    """Two fresh interpreters build into one empty directory at the same
    time: each compiles to a file of its own and renames it into place, so
    both load a whole library and no temporary file is left."""
    env = {k: v for k, v in os.environ.items() if k != "GCNN_TPU_NATIVE_LIB"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[:2] == ["True", "True"], out
    assert outs[0][0] == outs[1][0]
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]


MD_KW = dict(depth=1, interaction_args={"units": 16},
             gauss_args={"bins": 10, "distance_max": 4.0},
             last_mlp={"units": [16], "activation": ["shifted_softplus"]},
             output_mlp={"units": [1], "activation": ["linear"]})


def test_scanned_md_over_the_native_list_matches_jax(monkeypatch):
    """A 264-atom molecule (a jittered grid) in 2 segments of 4 steps: the
    port re-neighbours each segment through ``"auto"`` and so the C++
    list; the JAX ``ScannedMD`` (its native loader replaced by the
    unavailable answer) through its dense path. The port's run over its
    own dense path is the same bit for bit."""
    monkeypatch.setattr(jnative, "neighbor_list", lambda *args: None)
    calls = spy(monkeypatch, "neighbor_list")
    rs = np.random.RandomState(1)
    grid = np.stack(np.meshgrid(*[np.arange(6) * 1.5] * 2, np.arange(8) * 1.5),
                    -1).reshape(-1, 3)[:264]
    system = {"node_number": rs.choice([1, 6, 8], size=264),
              "node_coordinates": (grid + rs.randn(264, 3) * 0.05).astype(np.float32),
              "velocities": (rs.randn(264, 3) * 0.02).astype(np.float32)}
    g = jpre.set_range(dict(system), max_distance=4.0, max_neighbours=25, backend="numpy")
    g["edge_indices"] = g.pop("range_indices")
    from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
    jm = jmake_model(**MD_KW)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jbatch_graphs([{k: g[k] for k in (
            "node_number", "node_coordinates", "edge_indices")}])))
    tm = params_from_jax(make_model(device="cpu", **MD_KW), params)
    kw = dict(dt=5e-4, segment_steps=4, max_distance=4.0, max_neighbours=25)
    ref = JScannedMD(jm, params, **kw).run_ensemble([system], 2)
    out = ScannedMD(tm, device="cpu", **kw).run_ensemble([system], 2)
    assert calls == [264, 264]
    assert out["edge_counts"] == ref["edge_counts"]
    np.testing.assert_allclose(out["e_pot"], ref["e_pot"], rtol=E_RTOL, atol=0)
    np.testing.assert_allclose(out["e_kin"], ref["e_kin"], rtol=0, atol=MD_ATOL)
    np.testing.assert_allclose(out["pos"][0], ref["pos"][0], rtol=0, atol=MD_ATOL)
    monkeypatch.setattr(native, "_load", lambda: None)
    dense = ScannedMD(tm, device="cpu", **kw).run_ensemble([system], 2)
    for key in ("e_pot", "e_kin"):
        np.testing.assert_array_equal(dense[key], out[key], err_msg=key)
    np.testing.assert_array_equal(dense["pos"][0], out["pos"][0])
