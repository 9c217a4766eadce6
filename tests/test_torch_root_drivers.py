"""The last root drivers of the port against the JAX package's, on the
CPU: ``train_citation``, ``train_qm``, ``train_crystal`` and
``train_visual_graph_dataset``.

Each driver runs to its first fold's first step on both sides. The fold's
graphs are the same arrays, the first batch is the same batch, and with
the JAX driver's initial weights carried into the port model the loss is
the JAX step's within ``rtol 1e-5`` and each gradient within ``1e-5`` of
its tensor's largest entry (the citation driver's test accuracy, read from
the same forward, equal). Each driver also runs end to end. The
``--hyper`` runs of ``hyper_cora.py`` and ``hyper_qm7.py`` read archives
written by ``tests/test_torch_datasets.py`` and served through ``file://``.
"""
import copy
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import gcnn_keras_tpu.batch as jbatch  # noqa: E402
import gcnn_keras_tpu.models.megan as jmegan  # noqa: E402
import gcnn_keras_tpu.models.registry as jregistry  # noqa: E402
import gcnn_keras_tpu.training.fit as jfit  # noqa: E402
import gcnn_keras_tpu.training.history as jhistory  # noqa: E402
from gcnn_keras_tpu.training.losses import (  # noqa: E402
    masked_categorical_crossentropy as jmasked_cce, masked_graph_mae as jmasked_mae)
from gcnn_keras_tpu_torch.scripts import (train_citation, train_crystal,  # noqa: E402
                                          train_qm, train_visual_graph_dataset)
from gcnn_keras_tpu_torch.training import graph_driver  # noqa: E402
from gcnn_keras_tpu_torch.training.history import load_history_score  # noqa: E402
from gcnn_keras_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from tests.test_torch_datasets import (archives, reading_jax_deserialize,  # noqa: E402,F401
                                       serve)

torch.set_num_threads(1)

GRAD_TOL = 1e-5


class _Stop(Exception):
    pass


def _root_script(path, name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", str(ROOT / path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(seen, key, fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        seen.setdefault(key, []).append(out)
        return out
    return wrapped


def _recording_adam(seen):
    """``optax.adam`` whose ``init`` records the parameters it is given (the
    JAX drivers' initial weights) under ``seen["params"]``."""
    adam = optax.adam

    def make(*a, **kw):
        opt = adam(*a, **kw)

        def init(params):
            seen.setdefault("params", []).append(params)
            return opt.init(params)
        return optax.GradientTransformation(init, opt.update)
    return make


def _grads_close(model, grads, ref_model, ref_variables, ref_grads):
    """Each port gradient (in ``model.named_parameters()``'s order) within
    ``GRAD_TOL`` of the largest entry of the JAX gradient carried into
    ``ref_model`` by the same converter."""
    ref = dict(params_from_jax(ref_model, {
        **ref_variables, "params": jax.tree_util.tree_map(np.asarray, ref_grads["params"])}
    ).named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(grads) == len(ref)
    for n, g in zip(names, grads):
        r = ref[n].detach().numpy()
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), n


def _same_graphs(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# --------------------------------------------------------- fit_model drivers


def _jax_fit_driver(path, argv, monkeypatch):
    """A root driver that trains through ``fit_model``, stopped there:
    ``(model, trainer, state, loader)``."""
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
    monkeypatch.setattr(sys, "argv", [path] + argv)
    with pytest.raises(_Stop):
        _root_script(path, Path(path).stem).main()
    return seen["model"], seen["trainer"], seen["state"], seen["loader"]


def _port_fit_driver(mod, argv, monkeypatch):
    """The port driver stopped at ``graph_driver.train_fold``: ``(model,
    loss_fn, loader)``."""
    seen = {}

    def stop(model, loss_fn, loader, *a, **kw):
        seen.update(model=model, loss_fn=loss_fn, loader=loader)
        raise _Stop
    monkeypatch.setattr(graph_driver, "train_fold", stop)
    with pytest.raises(_Stop):
        mod.main(argv + ["--device", "cpu"])
    return seen["model"], seen["loss_fn"], seen["loader"]


FIT_DRIVERS = [("training/train_qm.py", train_qm, "Schnet",
                ["--molecules", "24", "--batch-size", "8"]),
               ("training/train_qm.py", train_qm, "PAiNN",
                ["--molecules", "24", "--batch-size", "8"]),
               ("training/train_crystal.py", train_crystal, "Schnet",
                ["--structures", "20", "--batch-size", "4"]),
               ("training/train_crystal.py", train_crystal, "CGCNN",
                ["--structures", "20", "--batch-size", "4", "--folds", "2"])]


@pytest.mark.parametrize("path,mod,model,extra", FIT_DRIVERS,
                         ids=[f"{Path(p).stem}-{m}" for p, _, m, _ in FIT_DRIVERS])
def test_fit_driver_first_step_matches_jax(path, mod, model, extra, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    argv = ["--model", model, "--epochs", "1", "--no-plots"] + extra
    jmodel, jtrainer, jstate, jloader = _jax_fit_driver(path, argv, monkeypatch)
    tmodel, loss_fn, loader = _port_fit_driver(mod, argv, monkeypatch)
    _same_graphs(loader.graphs, jloader.graphs)
    jb, b = next(iter(jloader)), next(iter(loader))
    np.testing.assert_array_equal(b.globals["graph_labels"].numpy(),
                                  np.asarray(jb.globals["graph_labels"]))
    np.testing.assert_array_equal(b.receivers.numpy(), np.asarray(jb.receivers))
    variables = jax.tree_util.tree_map(np.asarray, jstate.params)
    params_from_jax(tmodel, variables)
    (ref_loss, _), ref_grads = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(
        jstate.params, jb)
    loss, _ = loss_fn(b)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, [p for _, p in tmodel.named_parameters()])
    widths = graph_driver.input_widths(loader.graphs)
    _grads_close(tmodel, grads, mod.build_model(model, widths, "cpu"), variables, ref_grads)


# --------------------------------------------------------- full-batch drivers


def test_citation_first_step_matches_jax(monkeypatch, tmp_path):
    """Fold 0's first step: the same graph batch and masks, the loss and
    gradients on the JAX weights, and the test accuracy that the JAX step
    returns from the same forward (on the weights before the update)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--epochs", "1", "--folds", "4", "--nodes", "120", "--no-plots"]
    jseen, seen = {}, {}
    get = jregistry.get_model_class
    monkeypatch.setattr(jregistry, "get_model_class", lambda *a, **kw: _recording(
        jseen, "model", get(*a, **kw)))
    monkeypatch.setattr(optax, "adam", _recording_adam(jseen))
    monkeypatch.setattr(jbatch, "batch_graphs", _recording(jseen, "batch", jbatch.batch_graphs))
    monkeypatch.setattr(jhistory, "save_history_score", _recording(
        jseen, "score", jhistory.save_history_score))
    monkeypatch.setattr(sys, "argv", ["train_citation.py"] + argv)
    _root_script("training/train_citation.py", "train_citation").main()

    class Stopped(train_citation.Trainer):
        def step(self, state, batch):
            seen.update(loss_fn=self.loss_fn, batch=batch)
            raise _Stop
    monkeypatch.setattr(train_citation, "Trainer", Stopped)
    monkeypatch.setattr(train_citation, "build_model", _recording(
        seen, "model", train_citation.build_model))
    with pytest.raises(_Stop):
        train_citation.main(argv + ["--device", "cpu"])

    jb, b = jseen["batch"][0], seen["batch"]
    for k in ("node_attributes", "edge_weights"):
        key = "nodes" if k.startswith("node") else "edges"
        np.testing.assert_array_equal(getattr(b, key)[k].numpy(), np.asarray(getattr(jb, key)[k]))
    np.testing.assert_array_equal(b.receivers.numpy(), np.asarray(jb.receivers))
    # the JAX driver's labels and fold-0 mask, recomputed from its recipe
    labels = np.asarray(_citation_graph(120, 42)["node_labels"])
    n = labels.shape[0]
    y = np.zeros(jb.n_node, dtype=np.int64)
    y[:n] = labels
    test_idx = np.array_split(np.random.RandomState(42).permutation(n), 4)[0]
    train_mask = np.zeros(jb.n_node, dtype=bool)
    train_mask[:n] = True
    train_mask[test_idx] = False

    jmodel, jparams = jseen["model"][0], jseen["params"][0]
    variables = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = params_from_jax(seen["model"][0], variables)
    loss, metrics = seen["loss_fn"](b)
    score = jseen["score"][0]
    np.testing.assert_allclose(loss.item(), score["loss"][0], rtol=1e-5)
    assert float(metrics["val_categorical_accuracy"]) == score["val_categorical_accuracy"][0]

    def jloss(p):
        return jmasked_cce(jmodel.apply(p, jb)["output"], jax.numpy.asarray(y),
                           jax.numpy.asarray(train_mask))
    ref_loss, ref_grads = jax.value_and_grad(jloss)(jparams)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, [p for _, p in tmodel.named_parameters()])
    widths = graph_driver.input_widths([dict(_citation_graph(120, 42))])
    _grads_close(tmodel, grads, train_citation.build_model("GCN", int(labels.max()) + 1,
                                                           widths, "cpu"),
                 variables, ref_grads)


def _citation_graph(nodes, seed):
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticCitationDataset
    return SyntheticCitationDataset(num_nodes=nodes, seed=seed)[0]


def test_visual_graph_first_step_matches_jax(monkeypatch, tmp_path):
    dataset = "VgdMockDataset"  # the other's graphs are held bit for bit in the host tests
    pytest.importorskip("matplotlib")  # the JAX driver always draws its curves
    monkeypatch.chdir(tmp_path)
    argv = ["--epochs", "1", "--graphs", "20", "--dataset", dataset]
    jseen, seen = {}, {}
    monkeypatch.setattr(jmegan, "make_model", _recording(jseen, "model", jmegan.make_model))
    monkeypatch.setattr(optax, "adam", _recording_adam(jseen))
    monkeypatch.setattr(jbatch, "batch_graphs", _recording(jseen, "batch", jbatch.batch_graphs))
    monkeypatch.setattr(sys, "argv", ["train_visual_graph_dataset.py"] + argv)
    _root_script("training/train_visual_graph_dataset.py", "train_vgd").main()

    tv = train_visual_graph_dataset

    class Stopped(tv.Trainer):
        def step(self, state, batch):
            seen.update(loss_fn=self.loss_fn, batch=batch)
            raise _Stop
    monkeypatch.setattr(tv, "Trainer", Stopped)
    monkeypatch.setattr(tv, "build_model", _recording(seen, "model", tv.build_model))
    with pytest.raises(_Stop):
        tv.main(argv + ["--device", "cpu", "--no-plots"])

    jb, b = jseen["batch"][0], seen["batch"]
    for k in ("node_attributes",):
        np.testing.assert_array_equal(b.nodes[k].numpy(), np.asarray(jb.nodes[k]))
    np.testing.assert_array_equal(b.globals["graph_labels"].numpy(),
                                  np.asarray(jb.globals["graph_labels"]))
    np.testing.assert_array_equal(b.receivers.numpy(), np.asarray(jb.receivers))
    jmodel, jparams = jseen["model"][0], jseen["params"][0]
    variables = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = params_from_jax(seen["model"][0], variables)

    def jloss(p):
        return jmasked_mae(jmodel.apply(p, jb)["output"], jb.globals["graph_labels"],
                           jb.globals["graph_mask"])
    ref_loss, ref_grads = jax.value_and_grad(jloss)(jparams)
    loss, _ = seen["loss_fn"](b)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, [p for _, p in tmodel.named_parameters()])
    widths = graph_driver.input_widths(tv.load_dataset(dataset, 1, 42))
    _grads_close(tmodel, grads, tv.build_model(widths, "cpu"), variables, ref_grads)


def test_importance_auc_matches_jax():
    jtv = _root_script("training/train_visual_graph_dataset.py", "train_vgd")
    rs = np.random.RandomState(0)
    for n in (2, 7, 30):
        scores, truth = rs.rand(n), (rs.rand(n) > 0.5).astype(np.float32)
        got = train_visual_graph_dataset.importance_auc(scores, truth)
        want = jtv.importance_auc(scores, truth)
        assert got == want or (np.isnan(got) and np.isnan(want))
    assert np.isnan(train_visual_graph_dataset.importance_auc(np.ones(3), np.ones(3)))


def test_synthetic_crystals_match_jax():
    jtc = _root_script("training/train_crystal.py", "train_crystal")
    _same_graphs(train_crystal.synthetic_crystals(6, 3), jtc.synthetic_crystals(6, 3))


# --------------------------------------------------------- each driver end to end


RUNS = [
    (train_citation, "citation", "GCN", ["--nodes", "80", "--epochs", "12", "--folds", "2"]),
    (train_citation, "citation", "GCN", ["--nodes", "80", "--epochs", "40", "--folds", "2",
                                         "--early-stopping", "2"]),
    (train_qm, "qm", "Schnet", ["--molecules", "16", "--epochs", "1", "--folds", "2",
                                "--batch-size", "8"]),
    (train_crystal, "crystal", "Schnet", ["--structures", "12", "--epochs", "1",
                                          "--batch-size", "4"]),
    (train_crystal, "crystal", "Megnet", ["--structures", "12", "--epochs", "1",
                                          "--batch-size", "4"]),
    (train_visual_graph_dataset, "vgd", "MEGAN", ["--graphs", "16", "--epochs", "10",
                                                  "--folds", "2"]),
    (train_visual_graph_dataset, "vgd", "MEGAN", ["--graphs", "16", "--epochs", "10",
                                                  "--dataset", "VgdRbMotifsDataset"]),
]


@pytest.mark.parametrize("mod,kind,model,argv", RUNS,
                         ids=[f"{k}-{m}-{i}" for i, (_, k, m, _) in enumerate(RUNS)])
def test_driver_trains_and_writes_its_score(mod, kind, model, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    score = mod.main(argv + ["--model", model, "--device", "cpu", "--no-plots"])
    path = tmp_path / "results" / kind / f"{model}_score.yaml"
    assert load_history_score(str(path)) == score
    folds = int(argv[argv.index("--folds") + 1]) if "--folds" in argv else 1
    assert score["number_histories"] == folds and np.isfinite(score["loss"]).all()


def test_vgd_driver_takes_the_library_config(tmp_path, monkeypatch):
    """``--hyper`` with ``hyper_vgd_mock.py``: its dataset, MEGAN at its
    widths and its epochs (100)."""
    monkeypatch.chdir(tmp_path)
    score = train_visual_graph_dataset.main(
        ["--hyper", str(ROOT / "training/hyper/hyper_vgd_mock.py"), "--device", "cpu",
         "--no-plots"])
    assert len(score["loss"]) == 1 and np.isfinite(score["val_mae"]).all()


def test_citation_hyper_cora_first_step_matches_jax(archives, monkeypatch, tmp_path):
    """``train_citation --hyper hyper_cora.py --model GCN`` on a
    synthesized ``cora.npz``: fold 0's graph batch, the config's GCN on the
    JAX weights, its loss and gradients and the test accuracy of the same
    forward, against the JAX driver's."""
    from gcnn_keras_tpu_torch.data.serial import deserialize
    from gcnn_keras_tpu_torch.training.hyper import HyperParameter
    serve(monkeypatch, archives, tmp_path)
    reading_jax_deserialize(monkeypatch)
    monkeypatch.chdir(tmp_path)
    path = str(ROOT / "training/hyper/hyper_cora.py")
    argv = ["--hyper", path, "--model", "GCN", "--epochs", "1", "--folds", "3", "--no-plots"]
    jseen, seen = {}, {}
    get = jregistry.get_model_class
    monkeypatch.setattr(jregistry, "get_model_class", lambda *a, **kw: _recording(
        jseen, "model", get(*a, **kw)))
    monkeypatch.setattr(optax, "adam", _recording_adam(jseen))
    monkeypatch.setattr(jbatch, "batch_graphs", _recording(jseen, "batch", jbatch.batch_graphs))
    monkeypatch.setattr(jhistory, "save_history_score", _recording(
        jseen, "score", jhistory.save_history_score))
    monkeypatch.setattr(sys, "argv", ["train_citation.py"] + argv)
    _root_script("training/train_citation.py", "train_citation").main()

    class Stopped(train_citation.Trainer):
        def step(self, state, batch):
            seen.update(loss_fn=self.loss_fn, batch=batch)
            raise _Stop
    monkeypatch.setattr(train_citation, "Trainer", Stopped)
    monkeypatch.setattr(graph_driver, "build_hyper_model", _recording(
        seen, "model", graph_driver.build_hyper_model))
    with pytest.raises(_Stop):
        train_citation.main(argv + ["--device", "cpu"])

    jb, b = jseen["batch"][0], seen["batch"]
    for key, k in (("nodes", "node_attributes"), ("edges", "edge_weights")):
        np.testing.assert_array_equal(getattr(b, key)[k].numpy(), np.asarray(getattr(jb, key)[k]))
    np.testing.assert_array_equal(b.receivers.numpy(), np.asarray(jb.receivers))
    hyper = HyperParameter(path, model_name="GCN")
    ds = deserialize(hyper["data"]["dataset"])
    _, y, _ = train_citation.graph_inputs(ds, "cpu")
    train_mask, _ = train_citation.fold_masks(int(b.node_mask.sum()), b.n_node, 3, 42, "cpu")[0]

    jmodel, jparams = jseen["model"][0], jseen["params"][0]
    variables = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = params_from_jax(seen["model"][0], variables)
    loss, metrics = seen["loss_fn"](b)
    score = jseen["score"][0]
    np.testing.assert_allclose(loss.item(), score["loss"][0], rtol=1e-5)
    assert float(metrics["val_categorical_accuracy"]) == score["val_categorical_accuracy"][0]

    def jloss(p):
        return jmasked_cce(jmodel.apply(p, jb)["output"], jax.numpy.asarray(y.numpy()),
                           jax.numpy.asarray(train_mask.numpy()))
    ref_loss, ref_grads = jax.value_and_grad(jloss)(jparams)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, [p for _, p in tmodel.named_parameters()])
    widths = graph_driver.input_widths(ds)
    _grads_close(tmodel, grads, graph_driver.build_hyper_model(hyper, widths, "cpu"),
                 variables, ref_grads)


def test_qm_hyper_qm7_first_step_matches_jax(archives, monkeypatch, tmp_path):
    """``train_qm --hyper hyper_qm7.py --model Schnet`` on a synthesized
    ``qm7.mat`` (its ``read_in_memory``, ``set_range`` and ``set_angle``
    methods): the fold's graphs, the first batch, and the config's SchNet's
    first step on the JAX weights, against the JAX driver's."""
    from gcnn_keras_tpu_torch.training.hyper import HyperParameter
    serve(monkeypatch, archives, tmp_path)
    monkeypatch.chdir(tmp_path)
    path = str(ROOT / "training/hyper/hyper_qm7.py")
    argv = ["--hyper", path, "--model", "Schnet", "--epochs", "1", "--folds", "2",
            "--batch-size", "2", "--no-plots"]
    jmodel, jtrainer, jstate, jloader = _jax_fit_driver("training/train_qm.py", argv, monkeypatch)
    tmodel, loss_fn, loader = _port_fit_driver(train_qm, argv, monkeypatch)
    _same_graphs(loader.graphs, jloader.graphs)
    assert len(loader.graphs) > 0
    jb, b = next(iter(jloader)), next(iter(loader))
    np.testing.assert_array_equal(b.globals["graph_labels"].numpy(),
                                  np.asarray(jb.globals["graph_labels"]))
    np.testing.assert_array_equal(b.receivers.numpy(), np.asarray(jb.receivers))
    variables = jax.tree_util.tree_map(np.asarray, jstate.params)
    params_from_jax(tmodel, variables)
    (ref_loss, _), ref_grads = jax.value_and_grad(jtrainer.loss_fn, has_aux=True)(
        jstate.params, jb)
    loss, _ = loss_fn(b)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names, params = zip(*tmodel.named_parameters())
    grads = torch.autograd.grad(loss, params)
    widths = graph_driver.input_widths(loader.graphs)
    hyper = HyperParameter(path, model_name="Schnet")
    ref = dict(params_from_jax(train_qm.build_model("Schnet", widths, "cpu", hyper=hyper), {
        **variables, "params": jax.tree_util.tree_map(np.asarray, ref_grads["params"])}
    ).named_parameters())
    import chip_smoke
    # the config's SchNet (128 units, 25 bins) sums some gradients with
    # cancellation: a tensor outside GRAD_TOL is held by the float64 rules
    chip_smoke.check_grads("train_qm --hyper hyper_qm7.py", dict(zip(names, grads)), ref,
                           GRAD_TOL, lambda: chip_smoke.float64_grads(
                               copy.deepcopy(tmodel), lambda m, bb: train_qm.loss_fn(m)(bb)[0],
                               b))


def test_driver_draws_its_plots(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    train_qm.main(["--molecules", "16", "--epochs", "1", "--folds", "2", "--batch-size", "8",
                   "--device", "cpu"])
    assert (tmp_path / "results/qm/Schnet_loss.png").exists()
    assert (tmp_path / "results/qm/Schnet_fold1/predict.png").exists()
