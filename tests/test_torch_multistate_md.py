"""``EnergyForceModel.apply_multistate``, PAiNN under ``ScannedMD`` and the
``force_inverse_distances`` script in the port against the JAX package, on
the CPU; and ``chip_smoke.py`` phase 21's MD, multistate and script parts
at small sizes.

Tolerances: energies and forces within ``1e-5`` and ``1e-4`` of the largest
reference value; force-loss gradients within ``1e-4`` of each tensor's
largest entry; MD energy series within ``1e-5`` absolute
(``tests/test_torch_moldyn.py``'s); the NVE bound of
``tests/test_scanned_md.py::test_scanned_md_painn``, total energy within
``1e-3`` of its start (``chip_smoke.PAINN_MAX_DRIFT``).
"""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs  # noqa: E402
from gcnn_keras_tpu.graph.preprocess import set_range as jset_range  # noqa: E402
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel  # noqa: E402
from gcnn_keras_tpu.models.painn import make_model as jmake_painn  # noqa: E402
from gcnn_keras_tpu.models.schnet import make_model as jmake_schnet  # noqa: E402
from gcnn_keras_tpu.moldyn.trajectory import ScannedMD as JScannedMD  # noqa: E402
from gcnn_keras_tpu.training import force_script as jfs  # noqa: E402
from gcnn_keras_tpu_torch.batch import batch_graphs  # noqa: E402
from gcnn_keras_tpu_torch.model.force import EnergyForceModel  # noqa: E402
from gcnn_keras_tpu_torch.models.painn import make_model as make_painn  # noqa: E402
from gcnn_keras_tpu_torch.models.schnet import make_model as make_schnet  # noqa: E402
from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD  # noqa: E402
from gcnn_keras_tpu_torch.training import force_script  # noqa: E402
from gcnn_keras_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

E_TOL, F_TOL, GRAD_TOL, MD_ATOL = 1e-5, 1e-4, 1e-4, 1e-5
STATES = 3
SMALL = dict(depth=2, interaction_args={"units": 32},
             gauss_args={"bins": 8, "distance_max": 4.0},
             input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
             last_mlp={"units": [32, 16]}, output_mlp={"units": [16, STATES]})


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(out, ref, tol):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -------------------------------------------------------- apply_multistate


@pytest.fixture(scope="module")
def multistate():
    graphs = [{k: v for k, v in g.items() if k != "energy"}
              for g in chip_smoke.labelled_mols(3, 4)]
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    jm = JEnergyForceModel(jmake_schnet(**SMALL))
    params = _tree(jm.init(jax.random.PRNGKey(6), jb))
    fm = EnergyForceModel(params_from_jax(make_schnet(device="cpu", **SMALL), params),
                          device="cpu")
    return jm, params, jb, tb, fm


def test_apply_multistate_matches_jax(multistate):
    """(G, S) energies and (S, N, 3) forces against ``jacrev`` in JAX."""
    jm, params, jb, tb, fm = multistate
    ref = jm.apply_multistate(params, jb, STATES)
    out = fm.apply_multistate(tb, STATES)
    assert out["force"].shape == (STATES, tb.n_node, 3)
    _close(out["energy"], ref["energy"], E_TOL)
    _close(out["force"], ref["force"], F_TOL)
    for s in range(STATES):  # each state's forces are its own
        _close(out["force"][s], ref["force"][s], F_TOL)


def test_apply_multistate_create_graph_gives_the_force_loss_gradients(multistate):
    """With ``create_graph`` the (S, N, 3) forces stay differentiable: a
    loss on every state's forces has JAX's parameter gradients."""
    jm, params, jb, tb, fm = multistate
    target = np.random.RandomState(9).randn(STATES, jb.n_node, 3).astype(np.float32) * 0.1
    mask = np.array(jb.node_mask, np.float32)[None, :, None]

    def jloss(p):
        f = jm.apply_multistate(p, jb, STATES)["force"]
        return jnp.sum(jnp.abs(f - target) * mask)
    ref_grads = jax.grad(jloss)(params)
    f = fm.apply_multistate(tb, STATES, create_graph=True)["force"]
    loss = ((f - torch.from_numpy(target)).abs() * torch.from_numpy(mask)).sum()
    model = fm.energy_model
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    ref = dict(params_from_jax(make_schnet(device="cpu", **SMALL),
                               _tree(ref_grads)).named_parameters())
    for (n, p), g in zip(model.named_parameters(), grads):
        if g is None:  # the output bias moves no force
            assert not ref[n].any(), n
        else:
            _close(g, ref[n], GRAD_TOL)


# -------------------------------------------------------------- PAiNN MD


def test_scanned_md_painn_matches_jax():
    """``tests/test_scanned_md.py::test_scanned_md_painn``'s setup (depth 2,
    32 units, a 6-atom helix, two 20-step segments at dt 1e-3): energies
    against JAX's on the same weights, and the total energy's drift under
    1e-3."""
    from tests.test_scanned_md import _mol
    z, pos = _mol(n=6, seed=21)
    g = jset_range({"node_number": z, "node_coordinates": pos,
                    "energy": np.array([0.0], dtype=np.float32)},
                   max_distance=4.0, max_neighbours=25)
    g["edge_indices"] = g.pop("range_indices")
    jb = jbatch_graphs([g], global_keys=("energy",))
    kw = dict(depth=2, units=32)
    jm = jmake_painn(**kw)
    params = _tree(jm.init(jax.random.PRNGKey(0), jb))
    ref = JScannedMD(jm, params, dt=1e-3, segment_steps=20).run(z, pos, n_segments=2)
    tm = params_from_jax(make_painn(device="cpu", **kw), params)
    out = ScannedMD(tm, dt=1e-3, segment_steps=20, device="cpu").run(z, pos, n_segments=2)
    assert out["e_pot"].shape == ref["e_pot"].shape == (40,)
    np.testing.assert_allclose(out["e_pot"], ref["e_pot"], rtol=0, atol=MD_ATOL)
    np.testing.assert_allclose(out["e_kin"], ref["e_kin"], rtol=0, atol=MD_ATOL)
    e_tot = out["e_pot"] + out["e_kin"]
    assert np.isfinite(e_tot).all() and abs(e_tot[-1] - e_tot[0]) < 1e-3


# -------------------------------------------------- force_inverse_distances


def _tiny(**over):
    mod = importlib.import_module("gcnn_keras_tpu_torch.scripts.force_inverse_distances")
    cfg = dict(mod.CONFIG, synthetic_frames=12, batch_size=3, ensemble_size=2, epochs=1,
               make_plots=False, mlp_units=[8, 8, 1], learning_rate_start=1e-3,
               learning_rate_stop=1e-4, **over)
    return mod, cfg


def test_force_inverse_distances_config_equals_the_root_script():
    root = importlib.import_module("force_inverse_distances")
    mod, _ = _tiny()
    assert mod.CONFIG == root.CONFIG


def test_force_inverse_distances_first_step_matches_jax(monkeypatch, tmp_path):
    """The engine's first step of the script from JAX's initial params, as
    ``tests/test_torch_force_script.py`` holds the other scripts: the loss
    and each parameter gradient; the model takes the synthetic molecules'
    9 atoms (36 pair distances)."""
    from tests.test_torch_force_script import LOSS_RTOL, _Stop
    from gcnn_keras_tpu.data import scalers as jscalers
    from gcnn_keras_tpu.data.loader import GraphBatchLoader as JLoader
    from gcnn_keras_tpu.training import losses as jlosses
    from gcnn_keras_tpu.utils.data_splitter import kfold_swapped_val
    monkeypatch.chdir(tmp_path)
    mod, cfg = _tiny()
    full = {**jfs.DEFAULTS, **cfg}
    ds = jfs.load_force_dataset(full)
    tr, _, _ = next(kfold_swapped_val(len(ds), k=full["ensemble_size"], seed=full["seed"]))
    train = ds[tr]
    scaler = jscalers.EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(train)
    scaler.transform_dataset(train)
    jroot = importlib.import_module("force_inverse_distances")
    fmodel = jroot.build_model(dict(cfg))
    loader = JLoader(list(train), full["batch_size"], shuffle=True, seed=full["seed"],
                     global_keys=("energy",), **train.batch_shape_hint(full["batch_size"]))
    params = _tree(fmodel.init(jax.random.PRNGKey(full["seed"]), next(iter(loader))))
    batch = next(iter(loader))
    w = jfs.normalized_loss_weights(full)

    def jloss(p):
        out = fmodel.apply(p, batch)
        return (w["energy"] * jlosses.masked_graph_mae(out["energy"], batch.globals["energy"],
                                                       batch.globals["graph_mask"])
                + w["force"] * jlosses.masked_node_mae(out["force"], batch.nodes["force"],
                                                       batch.node_mask))
    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)

    seen, build = {}, mod.build_model

    def shared(c, device=None, generator=None):
        fm = build(c, device=device, generator=generator)
        params_from_jax(fm.energy_model, params)
        return fm

    def first_step(trainer, state, batches, *args, **kwargs):
        state, metrics = trainer.step(state, next(iter(batches)))
        seen.update(loss=float(metrics["loss"]), grads=[p.grad.clone() for p in state.params])
        raise _Stop
    monkeypatch.setattr(mod, "build_model", shared)
    monkeypatch.setattr(force_script, "fit_model", first_step)
    with pytest.raises(_Stop):
        force_script.run_force_training(mod.build_model, dict(cfg, device="cpu"))
    np.testing.assert_allclose(seen["loss"], float(ref_loss), rtol=LOSS_RTOL)
    ref_model = params_from_jax(build(cfg, device="cpu").energy_model, _tree(ref_grads))
    assert ref_model.max_nodes == 9
    for (n, r), g in zip(ref_model.named_parameters(), seen["grads"]):
        _close(g, r, GRAD_TOL)


def test_force_inverse_distances_runs_one_epoch_end_to_end(tmp_path, monkeypatch):
    """``python -m gcnn_keras_tpu_torch.scripts.force_inverse_distances``:
    one epoch of two folds, the engine's artifacts and a finite score."""
    from tests.test_torch_force_script import _assert_run_artifacts
    monkeypatch.chdir(tmp_path)
    mod, cfg = _tiny(device="cpu")
    score = force_script.run_force_training(mod.build_model, cfg)
    assert np.isfinite(score["loss_mean"]) and score["number_histories"] == 2
    _assert_run_artifacts("model_inverse_distances_force")
    assert mod.largest_molecule(cfg) == 9


def test_force_inverse_distances_trains_on_molecules_of_mixed_sizes(tmp_path, monkeypatch):
    """A dataset file of 12- to 20-atom molecules: the model takes the
    largest, every batch (each padded to its own largest molecule) and the
    validation split run through it, and the fold's score is finite."""
    from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset
    monkeypatch.chdir(tmp_path)
    graphs = chip_smoke.labelled_mols(3, 12)
    for g in graphs:
        g["range_indices"] = g["edge_indices"]
    MemoryGraphDataset(graphs=graphs).save(str(tmp_path / "mixed.pickle"))
    mod, cfg = _tiny(device="cpu", data_path=str(tmp_path / "mixed.pickle"))
    sizes = [len(g["node_number"]) for g in graphs]
    assert mod.largest_molecule(cfg) == max(sizes) and min(sizes) < max(sizes)
    score = force_script.run_force_training(mod.build_model, cfg)
    assert np.isfinite(score["loss_mean"]) and score["number_histories"] == 2


# ------------------------------------- chip_smoke phase 21 on the CPU


def _counted(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=name):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            elif _name == "sorted_segment_sum" and args[0].dtype == torch.bfloat16:
                _mod.launches_bf16 += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)


def test_chip_smoke_painn_md_runs_on_the_cpu(monkeypatch):
    """Phase 21's PAiNN MD at the bench width on a few steps and 3 replicas:
    launches per step, the CPU comparisons, the drift bound."""
    _counted(monkeypatch)
    paths, recs = chip_smoke.phase_painn_md("cpu", "cpu", steps=(2, 4), pairs=1, replicas=3,
                                            segment_steps=2, segments=1)
    per_eval = chip_smoke.PAINN_LAUNCHES
    assert paths["painn_md_single"] == {k: 3 * v for k, v in per_eval.items()}
    assert paths["painn_md_ensemble"] == {k: 3 * v for k, v in per_eval.items()}
    assert {k: len(v) for k, v in recs.items()} == {
        k: v for k, v in per_eval.items() if v}


def test_chip_smoke_multistate_runs_on_the_cpu(monkeypatch):
    """Phase 21's ``apply_multistate`` at the serving width on a small batch:
    the derived launches and the CPU comparisons."""
    _counted(monkeypatch)
    batch = batch_graphs(chip_smoke.qm9_like_mols(0, 4), device="cpu")
    assert chip_smoke.phase_multistate(batch, "cpu", "cpu") == chip_smoke.MULTISTATE_LAUNCHES


def test_chip_smoke_inverse_distance_script_runs_on_the_cpu(monkeypatch):
    """Phase 21's ``force_inverse_distances`` through phase 19's
    ``phase_script``: no kernel runs; losses finite, artifacts, reload."""
    _counted(monkeypatch)
    cuts = dict(epochs=2, synthetic_frames=24, batch_size=4, make_plots=False)
    launches, recs = chip_smoke.phase_script("force_inverse_distances", "cpu", "cpu",
                                             cuts=cuts)
    assert recs == {} and not any(launches.values())
