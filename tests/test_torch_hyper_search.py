"""The port's search and configuration library against the JAX package, on
the CPU.

- ``training/metrics.py`` against ``gcnn_keras_tpu.training.metrics`` on
  the same numpy inputs, within ``1e-6``;
- ``SearchSpace``/``HyperbandSearch`` against the JAX ones with the same
  deterministic ``trial_fn``: the same trial files and ``best_trial.json``
  after ``json.load``, every field but the wall time ``time_s``; and
  ``retrieve_trial`` on the JAX search's directory;
- ``HyperParameter`` loading ``.py``, ``.json`` and ``.yaml`` configs;
  ``make_model`` for SchNet and HDNNP4th against the JAX models on the JAX
  params (``params_from_jax``), within ``1e-5`` of the largest output;
  an unported model module raising;
- ``make_optimizer``'s optimizers against optax: three updates of the same
  params with the same gradients, within ``1e-6`` relative (each tensor
  within ``1e-6`` of its largest entry);
- one ``force_search`` trial from the JAX trial's initial params: the same
  split and first batch, the loss within ``rtol 1e-5`` and each gradient
  within ``1e-4`` of the tensor's largest entry
  (``test_torch_training.py``'s tolerances; a tensor's largest entry
  taken as at least 1e-3 of the largest gradient), and the validation metrics
  after one SGD step within ``rtol 1e-4`` (Adam's first step divides each
  gradient by its own magnitude, so float32 noise in a small gradient
  moves a weight by the full learning rate).
"""
import functools
import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs  # noqa: E402
from gcnn_keras_tpu.data.dataset import MemoryGraphDataset as JDataset  # noqa: E402
from gcnn_keras_tpu.data.loader import GraphBatchLoader as JLoader  # noqa: E402
from gcnn_keras_tpu.data.scalers import EnergyForceExtensiveLabelScaler as JScaler  # noqa: E402
from gcnn_keras_tpu.training import force_script as jfs  # noqa: E402
from gcnn_keras_tpu.training import hyper_search as jhs  # noqa: E402
from gcnn_keras_tpu.training import losses as jlosses  # noqa: E402
from gcnn_keras_tpu.training import metrics as jmetrics  # noqa: E402
from gcnn_keras_tpu.training.hyper import HyperParameter as JHyperParameter  # noqa: E402
from gcnn_keras_tpu_torch.batch import batch_graphs  # noqa: E402
from gcnn_keras_tpu_torch.models import registry  # noqa: E402
from gcnn_keras_tpu_torch.training import force_script, force_search, hyper_search  # noqa: E402
from gcnn_keras_tpu_torch.training import metrics, optimizers  # noqa: E402
from gcnn_keras_tpu_torch.training.hyper import HyperParameter  # noqa: E402
from gcnn_keras_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

METRIC_TOL, OUTPUT_TOL, OPT_RTOL = 1e-6, 1e-5, 1e-6
LOSS_RTOL, GRAD_TOL, METRICS_RTOL = 1e-5, 1e-4, 1e-4


# ------------------------------------------------------------ metrics


def _metric_inputs(shape, mask_shape, seed, all_masked=False):
    rs = np.random.RandomState(seed)
    pred = rs.randn(*shape).astype(np.float32)
    target = rs.randn(*shape).astype(np.float32)
    mask = np.zeros(mask_shape, bool) if all_masked else rs.rand(*mask_shape) > 0.3
    return pred, target, mask


@pytest.mark.parametrize("fn", ["scaled_mae", "scaled_rmse"])
@pytest.mark.parametrize("shape,mask_shape,all_masked", [
    ((7,), (7,), False), ((7, 1), (7,), False), ((11, 3), (11,), False),
    ((5, 2, 3), (5,), False), ((6, 3), (6,), True)])
def test_scaled_metrics_match_jax(fn, shape, mask_shape, all_masked):
    pred, target, mask = _metric_inputs(shape, mask_shape, len(shape), all_masked)
    got = getattr(metrics, fn)(torch.tensor(pred), torch.tensor(target), torch.tensor(mask),
                               scale=2.5)
    ref = getattr(jmetrics, fn)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                                scale=2.5)
    np.testing.assert_allclose(got.item(), float(ref), rtol=METRIC_TOL, atol=METRIC_TOL)
    if all_masked:
        assert got.item() == 0.0


@pytest.mark.parametrize("nan_share", [0.0, 0.4, 1.0])
def test_nan_tolerant_accuracy_matches_jax(nan_share):
    rs = np.random.RandomState(3)
    pred = rs.rand(9, 2).astype(np.float32)
    target = (rs.rand(9, 2) > 0.5).astype(np.float32)
    target[rs.rand(9, 2) < nan_share] = np.nan
    p, t, w = metrics.nan_tolerant_auc_inputs(torch.tensor(pred), torch.tensor(target))
    jp, jt, jw = jmetrics.nan_tolerant_auc_inputs(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    got = metrics.binary_accuracy_no_nan(torch.tensor(pred), torch.tensor(target)).item()
    ref = float(jmetrics.binary_accuracy_no_nan(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, ref, rtol=METRIC_TOL, atol=METRIC_TOL)


# ------------------------------------------------------------- search

SPACE = {"depth": {"int": [2, 5]}, "units": {"choice": [16, 32, 64]},
         "dropout": {"float": [0.0, 0.5]}, "learning_rate": {"log_float": [1e-4, 5e-3]}}


def _stub_trial(hp, epochs):
    """A deterministic trial: a score that falls with the epochs."""
    score = hp["learning_rate"] * 100 + hp["depth"] / hp["units"] + hp["dropout"] / epochs
    return {"val_force_mae": score, "val_energy_mae": 2 * score}


def _run_search(mod, directory, **kw):
    search = mod.HyperbandSearch(mod.SearchSpace(SPACE), directory=str(directory), **kw)
    return search.run(_stub_trial)


def _trial_files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            rec = json.load(f)
        rec.pop("time_s")
        out[name] = rec
    return out


@pytest.mark.parametrize("kw", [
    dict(objective="val_force_mae", num_trials=9, min_epochs=1, max_epochs=9, eta=3),
    dict(objective="val_force_mae", num_trials=3, min_epochs=1, max_epochs=3, eta=3, seed=4),
    dict(objective="val_energy_mae", num_trials=5, min_epochs=2, max_epochs=5, eta=2,
         direction="max", seed=1),
    dict(objective="val_force_mae", num_trials=4, min_epochs=5, max_epochs=3, seed=2)])
def test_hyperband_writes_the_jax_trial_files(kw, tmp_path, capsys):
    best = _run_search(hyper_search, tmp_path / "port", **kw)
    port_out = capsys.readouterr().out
    ref = _run_search(jhs, tmp_path / "jax", **kw)
    assert capsys.readouterr().out == port_out
    files = _trial_files(tmp_path / "port")
    assert files == _trial_files(tmp_path / "jax")
    assert "best_trial.json" in files and len(files) == kw["num_trials"] + 1
    best.pop("time_s"), ref.pop("time_s")
    assert best == ref == files["best_trial.json"]


def test_search_space_samples_as_jax():
    space = dict(SPACE, kind={"choice": ["a", "b"]})
    rs, jrs = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(20):
        assert hyper_search.SearchSpace(space).sample(rs) == jhs.SearchSpace(space).sample(jrs)
    with pytest.raises(ValueError, match="bad spec"):
        hyper_search.SearchSpace({"x": {"normal": [0, 1]}}).sample(rs)


def test_retrieve_trial_reads_the_jax_search(tmp_path, monkeypatch, capsys):
    _run_search(jhs, tmp_path, objective="val_force_mae", num_trials=3, min_epochs=1,
                max_epochs=3)
    for tid in (None, 0, 2):
        assert hyper_search.retrieve_trial(str(tmp_path), tid) == \
            jhs.retrieve_trial(str(tmp_path), tid)
    script = importlib.import_module("gcnn_keras_tpu_torch.scripts.retrieve_trial")
    capsys.readouterr()
    trial = script.main(["--directory", str(tmp_path), "--trial-id", "1"])
    assert json.loads(capsys.readouterr().out) == trial == jhs.retrieve_trial(str(tmp_path), 1)


# ------------------------------------------------------ HyperParameter

SCHNET_CFG = {"name": "Schnet", "depth": 2, "interaction_args": {"units": 16},
              "gauss_args": {"bins": 8, "distance_max": 5.0},
              "last_mlp": {"units": [16, 8]}, "output_mlp": {"units": [8, 1]}}
HYPER = {"model": {"module_name": "Schnet", "class_name": "make_model", "config": SCHNET_CFG},
         "data": {"dataset": {"class_name": "SyntheticMDDataset"}},
         "training": {"compile": {"optimizer": {"class_name": "Adam",
                                                "config": {"learning_rate": 5e-4}}}}}


def _write_config(tmp_path, fmt):
    path = tmp_path / f"hyper.{fmt}"
    hyper = {"Schnet": HYPER}
    if fmt == "py":
        path.write_text(f"hyper = {hyper!r}\n")
    elif fmt == "json":
        path.write_text(json.dumps(hyper))
    else:
        import yaml
        path.write_text(yaml.safe_dump(hyper))
    return str(path)


@pytest.mark.parametrize("fmt", ["py", "json", "yaml"])
def test_hyper_parameter_loads_as_jax(fmt, tmp_path):
    path = _write_config(tmp_path, fmt)
    hp = HyperParameter(path, model_name="Schnet", dataset_name="md")
    ref = JHyperParameter(path, model_name="Schnet", dataset_name="md")
    assert hp["model"] == ref["model"] and "training" in hp and "nothing" not in hp
    hp.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    with pytest.raises(ValueError, match="!= PAiNN"):
        HyperParameter(HYPER, model_name="PAiNN")
    with pytest.raises(ValueError, match="unknown config format"):
        HyperParameter(str(tmp_path / "hyper.toml"))


def test_results_file_path_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = HyperParameter(HYPER, model_name="Schnet", dataset_name="md").results_file_path()
    assert got == JHyperParameter(HYPER, model_name="Schnet",
                                  dataset_name="md").results_file_path()
    assert os.path.isdir(got)


def _md_graphs(n, need_esp=False):
    cfg = {**jfs.DEFAULTS, "synthetic_frames": n, "need_angles": True, "need_esp": need_esp}
    return [dict(g) for g in jfs.load_force_dataset(cfg)]


def _hdnnp4th_hyper():
    mlp = {"units": [8, 8, 1], "num_relations": 9, "activation": ["swish", "swish", "linear"]}
    g2 = {"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 6.0, "elements": [1, 6, 8]}
    g4 = {"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "zeta": [1.0, 8.0], "rc": 6.0,
          "elements": [1, 6, 8], "multiplicity": 2.0}
    return {"model": {"module_name": "kgcnn.literature.HDNNP4th",
                      "config": {"g2_kwargs": g2, "g4_kwargs": g4, "mlp_charge_kwargs": mlp,
                                 "mlp_local_kwargs": dict(mlp)}}}


@pytest.mark.parametrize("name", ["Schnet", "HDNNP4th"])
def test_make_model_loads_the_jax_params(name):
    hyper = HYPER if name == "Schnet" else _hdnnp4th_hyper()
    graphs = _md_graphs(3, need_esp=name == "HDNNP4th")
    keys = ("energy", "total_charge") if name == "HDNNP4th" else ("energy",)
    jmodel = JHyperParameter(hyper, model_name=name).make_model()
    jbatch = jbatch_graphs(graphs, global_keys=keys)
    params = jmodel.init(jax.random.PRNGKey(1), jbatch)
    model = HyperParameter(hyper, model_name=name).make_model(device="cpu")
    params_from_jax(model, jax.tree_util.tree_map(np.asarray, params))
    got = model(batch_graphs(graphs, global_keys=keys, device="cpu"))
    ref = jmodel.apply(params, jbatch)
    for k in ("output", "charge") if name == "HDNNP4th" else ("output",):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].detach().numpy(), r, rtol=0,
                                   atol=OUTPUT_TOL * np.abs(r).max(), err_msg=k)


@pytest.mark.parametrize("module", ["MAT", "kgcnn.literature.Unet", "GNNExplain",
                                    "gcnn_keras_tpu.models.mat",
                                    "gcnn_keras_tpu.models.gnnexplain"])
def test_unported_model_module_raises_naming_the_zoo(module):
    """MAT and Unet (slice 15) and GNNExplain (slice 19) resolve to the
    port's modules and build through ``HyperParameter``; none raises any
    more. GNNExplain builds a ``GNNExplainer`` that takes the ``device``
    the hyper path passes."""
    file = module.split(".")[-1].lower()
    assert registry.get_model_class(module).__module__ == f"gcnn_keras_tpu_torch.models.{file}"
    if "nnexplain" in module.lower():
        hyper = HyperParameter({"model": {"module_name": module, "config": {"epochs": 3}}})
        explainer = hyper.make_model(device="cpu")
        assert (explainer.epochs, explainer.device) == (3, torch.device("cpu"))
        return
    hyper = HyperParameter({"model": {"module_name": module, "config": {"depth": 1}}})
    assert hyper.make_model(device="cpu").config["depth"] == 1


def test_zoo_is_the_rest_of_the_jax_table():
    from gcnn_keras_tpu.models import registry as jregistry
    jax_table = {name: path.rsplit(".", 1)[1] for name, path in jregistry._MODULES.items()}
    ported = {name: path.rsplit(".", 1)[1] for name, path in registry._MODULES.items()}
    assert ported == jax_table


def test_registry_takes_the_jax_paths():
    from gcnn_keras_tpu_torch.models import painn, schnet
    assert registry.get_model_class("gcnn_keras_tpu.models.schnet") is schnet.make_model
    assert registry.get_model_class("PAiNN", "make_crystal_model") is painn.make_crystal_model
    m = registry.make_model_by_name("Schnet", config={"depth": 1}, device="cpu")
    assert hasattr(m, "interaction_0") and not hasattr(m, "interaction_1")


# ---------------------------------------------------------- optimizers

OPTIMIZERS = {
    "adam": ("Adam", {}),
    "adamw": ("AdamW", {}),
    "adamw_decay": ("adamw", {"weight_decay": 0.05, "b1": 0.8}),
    "nadam": ("Nadam", {}),
    "sgd": ("SGD", {}),
    "sgd_momentum": ("SGD", {"momentum": 0.9}),
    "rmsprop": ("RMSprop", {}),
    "rmsprop_momentum": ("RMSprop", {"momentum": 0.5, "eps": 1e-6}),
    "adan": ("Adan", {}),
    "adan_decay": ("Adan", {"weight_decay": 0.02, "b3": 0.95}),
    "adam_schedule": ("Adam", {"learning_rate": {
        "class_name": "linear_warmup_exponential_decay",
        "config": {"lr_start": 0.05, "warmup_steps": 2, "decay_steps": 3.0}}}),
    "adan_schedule": ("Adan", {"learning_rate": {
        "class_name": "linear_warmup_exponential_decay",
        "config": {"lr_start": 0.05, "warmup_steps": 2, "decay_steps": 3.0}}}),
}


def _opt_hyper(class_name, cfg):
    cfg = {"learning_rate": 0.05, "ignored_key": 1, **cfg}
    return {"model": {}, "training": {"compile": {"optimizer": {
        "class_name": class_name, "config": cfg}}}}


def _check_updates_against_optax(case, without_grad=()):
    """Three updates of the same params and gradients through optax and
    the port; the parameters named in ``without_grad`` get a gradient at
    the first update only (None after, zeros for optax)."""
    hyper = _opt_hyper(*OPTIMIZERS[case])
    rs = np.random.RandomState(5)
    init = {"w": rs.randn(4, 3).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    for g in grads[1:]:
        for k in without_grad:
            g[k] = None
    tx = JHyperParameter(hyper).make_optimizer()
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt = HyperParameter(hyper).make_optimizer()(list(params.values()))
    for g in grads:
        jg = {k: jnp.zeros_like(jparams[k]) if v is None else jnp.asarray(v)
              for k, v in g.items()}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = None if g[k] is None else torch.tensor(g[k])
        opt.step()
        for k, p in params.items():
            ref = np.asarray(jparams[k])
            got = p.detach().numpy()
            assert np.abs(got - ref).max() <= OPT_RTOL * np.abs(ref).max(), (case, k)
    return {k: np.abs(np.asarray(jparams[k]) - init[k]).max() for k in init}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(case):
    moved = _check_updates_against_optax(case)
    assert max(moved.values()) > 1e-3  # the updates are large enough to see


@pytest.mark.parametrize("case", ["adamw_decay", "sgd_momentum", "rmsprop_momentum",
                                  "adan_decay"])
def test_optimizer_steps_a_parameter_without_gradient_as_optax(case):
    """optax updates every leaf, a zero gradient included: decay and
    momentum go on moving a parameter that the loss does not reach."""
    moved = _check_updates_against_optax(case, without_grad=("b",))
    assert moved["b"] > 1e-3


@pytest.mark.parametrize("class_name,cfg", [("Adam", {"momentum": 0.9}),
                                            ("SGD", {"eps": 1e-3})])
def test_optimizer_rejects_the_keywords_optax_rejects(class_name, cfg):
    hyper = _opt_hyper(class_name, cfg)
    with pytest.raises(TypeError):
        JHyperParameter(hyper).make_optimizer()
    with pytest.raises(TypeError):
        HyperParameter(hyper).make_optimizer()


def test_default_optimizer_is_adam_at_1e3():
    factory = HyperParameter({"model": {}}).make_optimizer()
    opt = factory([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, optimizers.OptaxAdam) and opt.param_groups[0]["lr"] == 1e-3


# ----------------------------------------------------- force_search trial

HP = {"depth": 1, "units": 16, "gauss_bins": 8, "learning_rate": 0.02,
      "force_loss_weight": 200.0}


def _search_cfg(frames=15):
    mod = importlib.import_module("gcnn_keras_tpu_torch.scripts.force_schnet")
    return dict(mod.CONFIG, synthetic_frames=frames, batch_size=12)


def _jax_split(cfg):
    """The JAX ``run_force_search``'s split and scaling."""
    ds = jfs.load_force_dataset(cfg)
    idx = np.random.RandomState(cfg["seed"]).permutation(len(ds))
    n_val = max(len(ds) // 5, 1)
    val, train = ds[idx[:n_val]], ds[idx[n_val:]]
    scaler = JScaler()
    scaler.fit_dataset(train)
    scaler.transform_dataset(train)
    scaler.transform_dataset(val)
    return train, val


def test_search_split_matches_jax():
    cfg = _search_cfg(17)
    train, val = force_search.split_search_data(force_script.load_force_dataset(cfg),
                                                cfg["seed"])
    jtrain, jval = _jax_split(cfg)
    for got, ref in ((train, jtrain), (val, jval)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            for k in r:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("cfg,hp", [
    ({"energy_loss_weight": 1.0, "force_loss_weight": 200.0}, {"force_loss_weight": 50.0}),
    ({"energy_loss_weight": 0.0, "charge_loss_weight": 1.0, "force_loss_weight": 0.0}, {}),
    ({}, {})])
def test_search_loss_weights_are_the_jax_trials(cfg, hp):
    we = cfg.get("energy_loss_weight", 1.0)
    wf = hp.get("force_loss_weight", cfg.get("force_loss_weight", 0.0))
    wq = cfg.get("charge_loss_weight", 0.0)
    norm = max(we + wf + wq, 1e-8)
    assert force_search.search_loss_weights(cfg, hp) == {
        "energy": we / norm, "force": wf / norm, "charge": wq / norm}


class _RecordingSGD(torch.optim.SGD):
    """SGD that keeps its first step's gradients."""
    first = None

    def step(self, closure=None):
        if _RecordingSGD.first is None:
            _RecordingSGD.first = [p.grad.clone() for g in self.param_groups
                                   for p in g["params"]]
        return super().step(closure)


def test_force_search_trial_matches_jax():
    """Trial 0 of the SchNet search from the JAX trial's initial params:
    the loss and gradients of its first step, then the validation metrics
    after that one SGD step (one batch an epoch)."""
    cfg = _search_cfg()
    jscript = importlib.import_module("force_schnet_hyp_param_search")
    script = importlib.import_module(
        "gcnn_keras_tpu_torch.scripts.force_schnet_hyp_param_search")
    jtrain, jval = _jax_split(cfg)
    jm = jscript.build_model(HP, cfg)
    loader = JLoader(list(jtrain), cfg["batch_size"], shuffle=True, global_keys=("energy",),
                     **jtrain.batch_shape_hint(cfg["batch_size"]))
    params = jm.init(jax.random.PRNGKey(0), next(iter(loader)), train=False)
    jbatch = next(iter(loader))  # the JAX trial's first step
    w = force_search.search_loss_weights(cfg, HP)

    def jloss(p, b):
        out = jm.apply(p, b, train=False)
        return w["energy"] * jlosses.masked_graph_mae(
            out["energy"], b.globals["energy"], b.globals["graph_mask"]) + \
            w["force"] * jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
    loss, grads = jax.value_and_grad(jloss)(params, jbatch)
    stepped = jax.tree_util.tree_map(lambda p, g: p - HP["learning_rate"] * g, params, grads)
    vb = JDataset(graphs=list(jval)).to_batch(global_keys=("energy",))
    vout = jm.apply(stepped, vb, train=False)
    ref_metrics = {
        "val_force_mae": float(jlosses.masked_node_mae(vout["force"], vb.nodes["force"],
                                                       vb.node_mask)),
        "val_energy_mae": float(jlosses.masked_graph_mae(vout["energy"], vb.globals["energy"],
                                                         vb.globals["graph_mask"]))}

    train, val = force_search.split_search_data(force_script.load_force_dataset(cfg),
                                                cfg["seed"])
    tree = jax.tree_util.tree_map(np.asarray, params)
    seen = {}

    def init(fm):
        params_from_jax(fm.energy_model, tree)
        seen["fm"] = fm
    _RecordingSGD.first = None
    trial_fn = force_search.make_trial_fn(
        script.build_model, cfg, train, val, ("energy",), "cpu", init=init,
        optimizer=lambda hp: functools.partial(_RecordingSGD, lr=hp["learning_rate"]))
    got_metrics = trial_fn(HP, 1)
    assert sorted(got_metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(got_metrics[k], v, rtol=METRICS_RTOL, err_msg=k)

    # the first step's loss and gradients, on the weights it started from
    fm = script.build_model(HP, cfg, device="cpu")
    params_from_jax(fm.energy_model, tree)
    pbatch = next(iter(force_search.GraphBatchLoader(
        list(train), cfg["batch_size"], seed=1, global_keys=("energy",), device="cpu",
        **train.batch_shape_hint(cfg["batch_size"]))))
    np.testing.assert_array_equal(pbatch.nodes["force"].numpy(),
                                  np.asarray(jbatch.nodes["force"]))
    got_loss, _ = force_script.force_loss_fn(fm, w)(pbatch)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=LOSS_RTOL)
    ref = params_from_jax(script.build_model(HP, cfg, device="cpu").energy_model,
                          jax.tree_util.tree_map(np.asarray, grads))
    ref = [p.detach() for p in ref.parameters()]
    assert len(ref) == len(_RecordingSGD.first)
    # the output bias's gradient is the mean of the energy errors' signs:
    # 0 exactly here, float32 noise there, so a tensor's scale is at least
    # 1e-3 of the largest gradient
    floor = 1e-3 * max(r.abs().max() for r in ref)
    for g, r in zip(_RecordingSGD.first, ref):
        assert (g - r).abs().max() <= GRAD_TOL * max(r.abs().max(), floor)
