"""The port's MD integrators (``moldyn/integrate.py``) and segmented MD
(``moldyn/trajectory.py`` ``ScannedMD``) against the JAX package, on the
CPU, on shared SchNet weights (``params_from_jax``).

Tolerances: energy series within 1e-5 (absolute, energies of order 0.1-1,
float32 through a trajectory, the bound of
``tests/test_nve_conservation.py``'s f32-against-f64 test); drift metrics of
equal series exactly equal. The Langevin noise of the two packages differs
(a ``torch.Generator`` against a JAX key), so BAOAB is compared at
``friction=0`` (no noise) and its thermostat is held to equipartition on a
harmonic well, within four standard errors of the run's own block means.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph.preprocess import set_range as jset_range
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.moldyn import integrate as jint
from gcnn_keras_tpu.moldyn.trajectory import ScannedMD as JScannedMD
from gcnn_keras_tpu.utils.constants import masses_from_numbers as jmasses_from_numbers
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.moldyn.integrate import (
    langevin_baoab, make_energy_force_fn, nve_drift, velocity_verlet)
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
from gcnn_keras_tpu_torch.utils.constants import atomic_masses, masses_from_numbers
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-5
# tests/test_nve_conservation.py's model and masses
KW = dict(depth=2, interaction_args={"units": 32},
          gauss_args={"bins": 16, "distance_max": 6.0, "sigma": 0.4},
          last_mlp={"units": [32, 16], "activation": ["shifted_softplus"] * 2},
          output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]})
_MASS = np.array([0, 1.0, 0, 0, 0, 0, 12.0, 14.0, 16.0, 19.0])


def _shared_models(jb, kw=KW, seed=0):
    jm = jmake_model(**kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed), jb))
    return jm, params, params_from_jax(make_model(device="cpu", **kw), params)


@pytest.fixture(scope="module")
def nve_system():
    """``tests/test_nve_conservation.py``'s 16-atom system: the batches,
    both models on one set of weights, masses and starting velocities."""
    grid = np.stack(np.meshgrid(*[np.arange(4) * 1.6] * 2, [0.0, 1.6]), -1).reshape(-1, 3)[:16]
    rs = np.random.RandomState(0)  # the JAX test's draws: positions, elements, velocities
    pos = (grid + rs.randn(16, 3) * 0.05).astype(np.float32)
    g = {"node_number": rs.choice([1, 6, 8], size=16), "node_coordinates": pos}
    g = jset_range(g, max_distance=6.0, max_neighbours=25)
    g["edge_indices"] = g.pop("range_indices")
    jb, tb = jbatch_graphs([g]), batch_graphs([g], device="cpu")
    jm, params, tm = _shared_models(jb)
    z = np.clip(np.asarray(jb.nodes["node_number"]).astype(int), 0, 9)
    masses = np.where(np.asarray(jb.node_mask), _MASS[z], 1.0).astype(np.float32)
    vel0 = (rs.randn(jb.n_node, 3) * 0.02).astype(np.float32)
    return dict(jb=jb, tb=tb, jm=jm, params=params, tm=tm, masses=masses, vel0=vel0)


def _tethered(base_fn, pos0, k=0.5):
    """``tests/test_nve_conservation.py``'s harmonic tether to the start."""
    def ef(p):
        e, f = base_fn(p)
        d = p - pos0
        return e + 0.5 * k * (d * d).sum(), f - k * d
    return ef


def _trajectories(s, integrator, steps, **kw):
    jpos0 = s["jb"].nodes["node_coordinates"]
    tpos0 = s["tb"].nodes["node_coordinates"]
    jef = _tethered(jint.make_energy_force_fn(s["jm"], s["params"], s["jb"]), jpos0)
    tef = _tethered(make_energy_force_fn(s["tm"], s["tb"]), tpos0)
    jkw = {k: v for k, v in kw.items() if k != "generator"}
    if integrator == "baoab":
        jkw["rng"] = jax.random.PRNGKey(0)
    jfn, tfn = {"verlet": (jint.velocity_verlet, velocity_verlet),
                "baoab": (jint.langevin_baoab, langevin_baoab)}[integrator]
    ref = jfn(jef, jpos0, jnp.asarray(s["vel0"]), jnp.asarray(s["masses"]), 0.01, steps,
              node_mask=s["jb"].node_mask, **jkw)
    out = tfn(tef, tpos0, torch.from_numpy(s["vel0"]), torch.from_numpy(s["masses"]), 0.01,
              steps, node_mask=s["tb"].node_mask, **kw)
    return out, ref


def test_velocity_verlet_matches_jax(nve_system):
    out, ref = _trajectories(nve_system, "verlet", 200)
    for key in ("e_pot", "e_kin"):
        assert out[key].shape == (200,)
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out["pos"].numpy(), np.asarray(ref["pos"]), rtol=0, atol=ATOL)
    assert abs(out["e_pot0"] - float(ref["e_pot0"])) <= ATOL
    assert out["e_kin0"] == pytest.approx(float(ref["e_kin0"]), rel=1e-6)


def test_langevin_without_friction_matches_jax(nve_system):
    """BAOAB at ``friction=0`` draws noise but scales it by 0: both packages
    integrate the same deterministic trajectory."""
    out, ref = _trajectories(nve_system, "baoab", 100, kT=0.5, friction=0.0,
                             generator=torch.Generator().manual_seed(0))
    for key in ("e_pot", "e_kin"):
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), rtol=0, atol=ATOL)


def test_nve_drift_is_equal_on_equal_series():
    rs = np.random.RandomState(3)
    traj = {"e_pot": rs.randn(300).astype(np.float32) * 0.01,
            "e_kin": rs.rand(300).astype(np.float32) + 1.0,
            "e_pot0": np.float32(0.02), "e_kin0": np.float32(1.1)}
    assert nve_drift(traj) == jint.nve_drift(traj)


def test_langevin_is_reproducible_and_equipartitions_on_a_harmonic_well():
    """Free particles of unit mass in a harmonic well, kT 0.8, friction 1,
    dt 0.05: the same seed gives the same trajectory, and the mean kinetic
    energy of the second half is 3/2 N kT within four standard errors of
    its 20 block means (the seed is fixed, so the test cannot flake)."""
    n, kT, steps = 32, 0.8, 4000
    pos0 = torch.from_numpy(np.random.RandomState(1).randn(n, 3).astype(np.float32))

    def well(p):
        return 0.5 * (p * p).sum(), -p

    runs = [langevin_baoab(well, pos0, torch.zeros(n, 3), torch.ones(n), 0.05, steps, kT, 1.0,
                           torch.Generator().manual_seed(7)) for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["e_kin"], runs[1]["e_kin"])
    blocks = runs[0]["e_kin"][steps // 2:].astype(np.float64).reshape(20, -1).mean(axis=1)
    sem = blocks.std(ddof=1) / np.sqrt(len(blocks))
    assert abs(blocks.mean() - 1.5 * n * kT) <= 4 * sem, (blocks.mean(), 1.5 * n * kT, sem)


def _small_systems(n_mols=4):
    """Helical molecules of 5-8 atoms (``tests/test_scanned_md.py``'s
    ``_mol``) with small starting velocities."""
    systems = []
    for s in range(n_mols):
        rs = np.random.RandomState(s)
        n = 5 + s
        t = np.arange(n) * 1.2
        pos = np.stack([t, 1.3 * np.sin(t), 1.3 * np.cos(t)], axis=1)
        systems.append({"node_number": rs.choice([1, 6, 7, 8], size=n),
                        "node_coordinates": (pos + rs.randn(n, 3) * 0.05).astype(np.float32),
                        "velocities": (rs.randn(n, 3) * 0.05).astype(np.float32)})
    return systems


@pytest.fixture(scope="module")
def md_models():
    systems = _small_systems()
    g = jset_range(dict(systems[0]), max_distance=4.0, max_neighbours=25)
    g["edge_indices"] = g.pop("range_indices")
    kw = dict(KW, gauss_args={"bins": 16, "distance_max": 4.0, "sigma": 0.4})
    return systems, _shared_models(jbatch_graphs([g]), kw=kw, seed=2)


def test_scanned_md_ensemble_matches_jax(md_models):
    """4 molecules, 2 segments of 20 steps, re-neighboured between them."""
    systems, (jm, params, tm) = md_models
    kw = dict(dt=1e-3, segment_steps=20, max_distance=4.0, max_neighbours=25)
    ref = JScannedMD(jm, params, **kw).run_ensemble(systems, 2)
    out = ScannedMD(tm, device="cpu", **kw).run_ensemble(systems, 2)
    assert out["edge_counts"] == ref["edge_counts"]
    for key in ("e_pot", "e_kin"):
        assert out[key].shape == ref[key].shape == (40, 4)
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=ATOL)
    for p, r in zip(out["pos"], ref["pos"]):
        np.testing.assert_allclose(p, r, rtol=0, atol=ATOL)


def test_scanned_md_single_molecule_and_langevin(md_models):
    systems, (jm, params, tm) = md_models
    s = systems[1]
    kw = dict(dt=1e-3, segment_steps=10, max_distance=4.0, max_neighbours=25)
    ref = JScannedMD(jm, params, **kw).run(s["node_number"], s["node_coordinates"], 2,
                                           velocities=s["velocities"])
    out = ScannedMD(tm, device="cpu", **kw).run(s["node_number"], s["node_coordinates"], 2,
                                                velocities=s["velocities"])
    np.testing.assert_allclose(out["e_pot"], ref["e_pot"], rtol=0, atol=ATOL)
    assert out["n_shapes_compiled"] == ref["n_shapes_compiled"] == 1
    runs = [ScannedMD(tm, device="cpu", thermostat="langevin", kT=0.1, friction=5.0, seed=3,
                      **kw).run_ensemble(systems[:2], 2) for _ in range(2)]
    assert np.isfinite(runs[0]["e_kin"]).all()
    np.testing.assert_array_equal(runs[0]["e_kin"], runs[1]["e_kin"])


def test_scanned_md_refuses_what_is_not_ported(md_models):
    """Replica parallelism runs on a group of ranks
    (``tests/test_torch_parallel.py``); outside one, ``n_devices=2`` raises
    naming both counts, and replicas that do not divide over the devices
    raise as in JAX."""
    systems, (_, _, tm) = md_models
    md = ScannedMD(tm, dt=1e-3, device="cpu")
    with pytest.raises(ValueError, match=r"make_mesh\(n_devices=2\).*1 rank"):
        md.run_ensemble(systems[:2], 1, n_devices=2)
    with pytest.raises(ValueError, match="not divisible by n_devices=2"):
        md.run_ensemble(systems[:3], 1, n_devices=2)
    with pytest.raises(ValueError):
        ScannedMD(tm, dt=1e-3, thermostat="langevin", device="cpu")


def test_masses_from_numbers_equal():
    z = np.arange(0, 90)
    np.testing.assert_array_equal(masses_from_numbers(z), jmasses_from_numbers(z))
    assert masses_from_numbers(z).dtype == np.float32
    assert atomic_masses[6] == 12.011
