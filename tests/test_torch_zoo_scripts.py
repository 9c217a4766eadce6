"""The graph-learning drivers ``train_tudataset`` and ``train_moleculenet``
of the port against the JAX package's (``training/train_tudataset.py``,
``training/train_moleculenet.py``), and the label scalers they use, on the
CPU.

Each driver runs to its first fold's training and is stopped there, on
both sides: the JAX driver where it calls ``fit_model``, the port's where
it calls ``graph_driver.train_fold``. The fold's training graphs are the
same arrays, the first epoch's first batch is the same batch, and with the
JAX driver's initial weights carried into the port model its loss and
parameter gradients are the JAX ``Trainer`` step's (loss ``rtol 1e-5``,
each gradient within ``1e-5`` of its tensor's largest entry).
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.data import scalers as jscalers
from gcnn_keras_tpu_torch.data import scalers
from gcnn_keras_tpu_torch.models import gat, registry
from gcnn_keras_tpu_torch.scripts import train_moleculenet, train_tudataset
from gcnn_keras_tpu_torch.training import graph_driver
from gcnn_keras_tpu_torch.training.history import load_history_score
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_datasets import archives, serve  # noqa: F401 (a fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = {"train_tudataset": train_tudataset, "train_moleculenet": train_moleculenet}
GRAD_TOL = 1e-5


# --------------------------------------------------------- scalers


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True), (True, False)])
def test_standard_label_scaler_matches_jax(with_mean, with_std):
    rs = np.random.RandomState(3)
    y = rs.randn(40, 3) * [1.0, 5.0, 0.0] + [2.0, -1.0, 4.0]  # a constant column
    ours = scalers.StandardLabelScaler(with_mean=with_mean, with_std=with_std).fit(y)
    ref = jscalers.StandardLabelScaler(with_mean=with_mean, with_std=with_std).fit(y)
    for a, b in ((ours.transform(y), ref.transform(y)),
                 (ours.inverse_transform(y), ref.inverse_transform(y)),
                 (ours.get_scaling(), ref.get_scaling()),
                 (ours.fit_transform(y), ref.fit_transform(y))):
        np.testing.assert_array_equal(a, b)
    assert ours.get_config() == ref.get_config()
    again = scalers.StandardLabelScaler().set_config(ref.get_config())
    np.testing.assert_array_equal(again.transform(y), ref.transform(y))


def test_standard_scaler_on_a_dataset_matches_jax():
    rs = np.random.RandomState(4)
    graphs = [{"node_attributes": rs.randn(rs.randint(2, 6), 4).astype(np.float32)}
              for _ in range(5)]
    ours = scalers.StandardScaler().fit_dataset(graphs)
    ref = jscalers.StandardScaler().fit_dataset(graphs)
    mine = ours.transform_dataset([dict(g) for g in graphs])
    theirs = ref.transform_dataset([dict(g) for g in graphs])
    for a, b in zip(mine, theirs):
        assert a["node_attributes"].dtype == np.float32
        np.testing.assert_array_equal(a["node_attributes"], b["node_attributes"])


# --------------------------------------------------------- first fold against JAX


class _Stop(Exception):
    pass


def _jax_driver(name, argv, monkeypatch):
    """The JAX driver's first fold, stopped where it calls ``fit_model``:
    ``(model, trainer, state, loader)``."""
    import gcnn_keras_tpu.models.registry as jregistry
    import gcnn_keras_tpu.training.fit as jfit
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "training", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    get = jregistry.get_model_class

    def recording(*a, **kw):
        builder = get(*a, **kw)

        def build(**cfg):
            seen["model"] = builder(**cfg)
            return seen["model"]
        return build

    def stop(trainer, state, loader, *a, **kw):
        seen.update(trainer=trainer, state=state, loader=loader)
        raise _Stop
    monkeypatch.setattr(jregistry, "get_model_class", recording)
    monkeypatch.setattr(jfit, "fit_model", stop)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    with pytest.raises(_Stop):
        mod.main()
    return seen["model"], seen["trainer"], seen["state"], seen["loader"]


def _port_driver(name, argv, monkeypatch):
    """The port driver's first fold, stopped at ``train_fold``: ``(model,
    loss_fn, loader)``."""
    seen = {}

    def stop(model, loss_fn, loader, *a, **kw):
        seen.update(model=model, loss_fn=loss_fn, loader=loader)
        raise _Stop
    monkeypatch.setattr(graph_driver, "train_fold", stop)
    with pytest.raises(_Stop):
        DRIVERS[name].main(argv + ["--device", "cpu"])
    return seen["model"], seen["loss_fn"], seen["loader"]


def _same_graphs(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _first_step_matches(name, model, argv, monkeypatch):
    """The fold's graphs, the first batch and the first step of the two
    drivers run with ``argv``."""
    jmodel, jtrainer, jstate, jloader = _jax_driver(name, argv, monkeypatch)
    tmodel, loss_fn, loader = _port_driver(name, argv, monkeypatch)
    _same_graphs(loader.graphs, jloader.graphs)
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    np.testing.assert_array_equal(batch.globals["graph_labels"].numpy(),
                                  np.asarray(jbatch.globals["graph_labels"]))
    np.testing.assert_array_equal(batch.receivers.numpy(), np.asarray(jbatch.receivers))

    variables = jax.tree_util.tree_map(np.asarray, jstate.params)
    params_from_jax(tmodel, variables)
    (ref_loss, _), ref_grads = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(
        jstate.params, jbatch)
    loss, _ = loss_fn(batch)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names, params = zip(*tmodel.named_parameters())
    grads = torch.autograd.grad(loss, params)
    kw = {k: v for k, v in tmodel.config.items()}
    ref = dict(params_from_jax(registry.get_model_class(model)(device="cpu", **kw), {
        **variables, "params": jax.tree_util.tree_map(np.asarray, ref_grads["params"])}
    ).named_parameters())
    for n, g in zip(names, grads):
        r = ref[n].detach().numpy()
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), n


@pytest.mark.parametrize("name,model", [("train_tudataset", "GIN"),
                                        ("train_moleculenet", "GIN"),
                                        ("train_moleculenet", "GAT"),
                                        ("train_moleculenet", "AttentiveFP")])
def test_first_step_matches_the_jax_driver(name, model, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    _first_step_matches(name, model, ["--model", model, "--epochs", "1", "--folds", "3",
                                      "--no-plots"], monkeypatch)


def test_jax_driver_steps_gin_running_statistics_the_port_keeps(monkeypatch, tmp_path):
    """A deliberate difference: the JAX drivers hand the whole variable tree
    to the optimizer, so Adam moves GIN's ``batch_stats`` (read at
    ``train=False``) by their gradients; the port's running statistics are
    buffers that no optimizer moves."""
    monkeypatch.chdir(tmp_path)
    argv = ["--epochs", "1", "--folds", "3", "--no-plots"]
    _, jtrainer, jstate, jloader = _jax_driver("train_tudataset", argv, monkeypatch)
    stats = jax.tree_util.tree_map(np.array, jstate.params["batch_stats"])
    new, _ = jtrainer.step_fn()(jstate, next(iter(jloader)))  # donates jstate
    moved = jax.tree_util.tree_map(lambda a, b: float(np.abs(np.asarray(a) - b).max()),
                                   new.params["batch_stats"], stats)
    assert max(jax.tree_util.tree_leaves(moved)) > 0
    tmodel, loss_fn, loader = _port_driver("train_tudataset", argv, monkeypatch)
    before = {n: b.clone() for n, b in tmodel.named_buffers()}
    trainer = graph_driver.Trainer(loss_fn, lambda p: torch.optim.Adam(p, lr=1e-3))
    state = trainer.init_state(tmodel.parameters())
    trainer.step(state, next(iter(loader)))
    assert len(before) == 12  # gin_mlp_0-2, norm_0-1, mean and var
    for n, b in tmodel.named_buffers():
        assert torch.equal(b, before[n]), n


# --------------------------------------------------------- the entry points


@pytest.mark.parametrize("model", ["GIN", "GraphSAGE", "INorp"])
@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_trains_and_writes_its_score(name, model, tmp_path, monkeypatch):
    """One epoch of two folds on the CPU: finite losses, the score file."""
    monkeypatch.chdir(tmp_path)
    score = DRIVERS[name].main(["--device", "cpu", "--epochs", "1", "--folds", "2",
                                "--no-plots", "--model", model])
    kind = name.split("_")[1]
    path = tmp_path / "results" / kind / f"{model}_score.yaml"
    assert path.exists() or path.with_suffix(".json").exists()
    assert load_history_score(str(path))["number_histories"] == 2
    assert score["number_histories"] == 2 and np.isfinite(score["loss"]).all()


@pytest.mark.parametrize("model", ["NMPN", "AttentiveFP", "HamNet", "MEGAN"])
def test_moleculenet_driver_trains_the_second_group(model, tmp_path, monkeypatch):
    """The four of the zoo's second group that the JAX driver runs on its
    synthetic data (16 float node and 8 float edge features), one epoch of
    two folds: finite losses, the score file."""
    monkeypatch.chdir(tmp_path)
    score = train_moleculenet.main(["--device", "cpu", "--epochs", "1", "--folds", "2",
                                    "--no-plots", "--model", model])
    assert (tmp_path / "results" / "moleculenet" / f"{model}_score.yaml").exists() or \
        (tmp_path / "results" / "moleculenet" / f"{model}_score.json").exists()
    assert score["number_histories"] == 2 and np.isfinite(score["loss"]).all()


@pytest.mark.parametrize("model", ["DMPNN", "CMPNN"])
def test_moleculenet_driver_stops_where_jax_asserts(model, tmp_path, monkeypatch):
    """The drivers batch no reverse edges, so DMPNN and CMPNN stop at their
    first batch: the port's ``ValueError`` where the JAX driver asserts."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="compute_reverse_edges=True"):
        train_moleculenet.main(["--device", "cpu", "--epochs", "1", "--folds", "2",
                                "--no-plots", "--model", model])


def test_moleculenet_driver_draws_its_plots(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    train_moleculenet.main(["--device", "cpu", "--epochs", "1", "--folds", "2"])
    assert (tmp_path / "results/moleculenet/GIN_loss.png").exists()
    assert (tmp_path / "results/moleculenet/GIN_fold1/predict.png").exists()


@pytest.mark.parametrize("name,dataset", [("train_tudataset", "MUTAG"),
                                          ("train_moleculenet", "ESOL")])
def test_driver_dataset_first_step_matches_jax(name, dataset, archives, monkeypatch, tmp_path):
    """``--dataset`` on archives written by ``tests/test_torch_datasets.py``
    and served by ``file://``: MUTAG's graphs (labels 1 and -1, the -1 a
    row of zeros in both packages' one-hot), the first batch and GIN's
    first step against the JAX driver's; ESOL fetches and reads its CSV
    and then, without RDKit, raises the same ``ImportError`` in both."""
    serve(monkeypatch, archives, tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", dataset, "--model", "GIN", "--epochs", "1", "--folds", "3",
            "--batch-size", "2", "--no-plots"]
    try:
        import rdkit  # noqa: F401
    except ImportError:
        if name == "train_moleculenet":
            errors = []
            for run in (lambda: _jax_driver(name, argv, monkeypatch),
                        lambda: DRIVERS[name].main(argv + ["--device", "cpu"])):
                with pytest.raises(ImportError, match="rdkit is required") as e:
                    run()
                errors.append(str(e.value))
            assert errors[0] == errors[1]
            return
    labels = {float(g["graph_labels"][0]) for g in train_tudataset.load_dataset(dataset, 42)}
    assert labels == {1.0, -1.0}
    _first_step_matches(name, "GIN", argv, monkeypatch)


def test_input_widths_follow_the_data():
    tu = train_tudataset.synthetic_dataset(1)
    mol = train_moleculenet.synthetic_dataset(1)
    assert graph_driver.input_widths(tu) == {"edge_in_features": 0}
    assert graph_driver.input_widths(mol) == {"in_features": 16, "edge_in_features": 8}
    graphs = [{"node_number": np.arange(3), "edge_attributes": np.arange(2),
               "graph_attributes": np.zeros(4)}]
    assert graph_driver.input_widths(graphs) == {"edge_in_features": None,
                                                 "graph_in_features": 4}
    model = graph_driver.build_model("GAT", 2, graph_driver.input_widths(tu), device="cpu")
    assert model.config["output_mlp"] == {"units": [64, 32, 2],
                                          "activation": ["relu", "relu", "linear"]}
    assert graph_driver.build_model("GAT", 1, {}, device="cpu").config["output_mlp"] == \
        gat.model_default["output_mlp"]
    # MEGAN's output is its last final_units
    megan = graph_driver.build_model("MEGAN", 2, graph_driver.input_widths(tu), device="cpu")
    assert megan.config["final_units"] == [16, 2] and \
        megan.config["final_activation"] == "linear"
    assert graph_driver.build_model("MEGAN", 1, graph_driver.input_widths(mol),
                                    device="cpu").config["final_units"] == [16, 1]


# --------------------------------------------------------- chip_smoke phase 22


class _Everything(set):
    """A shape set that holds every shape: no call is timed."""

    def __contains__(self, item):
        return True


@pytest.fixture
def counted_kernels(monkeypatch):
    """Each kernel wrapper call counted as the card counts its launches, no
    device syncs, no sync debug mode."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "host_syncs", lambda fn: (fn(), 0)[1])
    for kname, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=kname):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)
    return chip_smoke


@pytest.mark.parametrize("name", ["GIN", "GraphSAGE", "GAT", "GATv2", "RGCN", "GNNFilm",
                                  "INorp"])
def test_chip_smoke_phase_22_model_runs_on_the_cpu(name, counted_kernels):
    """Phase 22's model checks on 16 molecules: the forward and first step
    against the CPU, every kernel call against its plain version, and the
    derived launches (``ZOO_LAUNCHES``) of a forward and of every step."""
    cs = counted_kernels
    profiles = []
    paths, recs = cs.phase_zoo_model(name, "cpu", _Everything(), profiles, device="cpu",
                                     n_mols=16)
    fwd, step = cs.ZOO_LAUNCHES[name]
    assert paths[f"{name}_zoo_forward"] == cs.launch_counts(sorted_segment_sum=fwd)
    assert paths[f"{name}_zoo_train"] == cs.launch_counts(
        sorted_segment_sum=cs.ZOO_STEPS * step)
    assert len(recs) == fwd + step and len(profiles) == 1


@pytest.mark.parametrize("name", ["DMPNN", "CMPNN", "NMPN", "AttentiveFP", "HamNet", "MEGAN"])
def test_chip_smoke_phase_23_model_runs_on_the_cpu(name, counted_kernels):
    """Phase 23's checks of the zoo's second group on 16 molecules, as phase
    22's: every output and the first step against the CPU, every kernel
    call against its plain version, the derived launches
    (``ZOO_LAUNCHES``) of a forward and of every step."""
    cs = counted_kernels
    profiles = []
    paths, recs = cs.phase_zoo_model(name, "cpu", _Everything(), profiles, device="cpu",
                                     n_mols=16)
    fwd, step = cs.ZOO_LAUNCHES[name]
    assert paths[f"{name}_zoo_forward"] == cs.launch_counts(sorted_segment_sum=fwd)
    assert paths[f"{name}_zoo_train"] == cs.launch_counts(
        sorted_segment_sum=cs.ZOO_STEPS * step)
    assert len(recs) == fwd + step and len(profiles) == 1


def test_zoo_b_inputs_follow_the_golden_recipes():
    """Phase 23's batches: float edge features of width 5 for CMPNN and
    MEGAN, integer classes below 5 for the others, reverse edges for DMPNN
    and CMPNN, coordinates for all."""
    import chip_smoke as cs
    for name in [n for n, entry in cs.ZOO_MODELS.items() if entry[2] == 23]:
        b = cs.zoo_batch(name, "cpu", n_mols=4)
        ed = b.edges["edge_attributes"]
        if name in ("CMPNN", "MEGAN"):
            assert ed.dtype == torch.float32 and ed.shape[1] == 5, name
            assert cs.zoo_model(name, "cpu").config["edge_in_features"] == 5
        else:
            assert ed.dim() == 1 and int(ed.max()) < 5, name
        assert ("edge_pair_index" in b.edges) == (name in ("DMPNN", "CMPNN")), name
        assert "node_coordinates" in b.nodes


@pytest.mark.parametrize("script,model", [("train_tudataset", "GIN"),
                                          ("train_moleculenet", "GAT"),
                                          ("train_moleculenet", "AttentiveFP")])
def test_chip_smoke_phase_22_driver_runs_on_the_cpu(script, model, counted_kernels):
    cs = counted_kernels
    paths, recs = cs.phase_zoo_driver(script, model, "cpu", device="cpu")
    calls = {k: len(r) for k, r in recs.items()}
    launches = paths[f"{script}_{model}"]
    assert calls["sorted_segment_sum"] == cs.ZOO_LAUNCHES[model][1]
    assert launches["sorted_segment_sum"] > calls["sorted_segment_sum"]
