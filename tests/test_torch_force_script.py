"""The port's training engine and scripts against the JAX package, on the CPU.

``gcnn_keras_tpu_torch.training.force_script`` and the scripts of
``gcnn_keras_tpu_torch.scripts`` against ``gcnn_keras_tpu.training.
force_script`` and the root ``force_*.py``, ``energy_hdnnp4th.py`` and
``charge_hdnnp4th.py``, at ``tests/test_force_script.py``'s ``_tiny``
sizes:

- each ``CONFIG`` equals the root script's, key for key; the datasets the
  engine and ``force_hdnnp4th`` load are the JAX ones bit for bit;
- the linear schedule equals ``optax.linear_schedule`` exactly (optax run
  eagerly; under ``jit`` XLA on the CPU contracts its multiply-add into an
  FMA, which moves some steps by up to one float32 ulp of the initial
  rate);
- ``EarlyStopping``/``fit_model`` give JAX's history keys, stop epoch and
  restored weights; ``save_history_score`` JAX's keys and values;
- the first engine step from JAX's initial params: the same batch bit for
  bit, the loss within ``rtol 1e-5``, each parameter gradient within
  ``1e-4`` of that tensor's largest entry (``test_torch_training.py``'s
  tolerances: float32 sums in other orders through two reverse passes);
- a JAX engine checkpoint, restored by the JAX ``load_checkpoint``, loads
  through ``params_from_jax`` into the port script's model: energies
  within ``1e-5`` of the magnitude of the terms the last layer sums; ``evaluate_model``'s errors match the JAX engine's
  ``errors.json`` within ``rtol 1e-4`` (metrics of float32 predictions);
- each port script runs end to end and writes the JAX engine's artifacts.
"""
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

from gcnn_keras_tpu.data import scalers as jscalers  # noqa: E402
from gcnn_keras_tpu.data.dataset import MemoryGraphDataset as JDataset  # noqa: E402
from gcnn_keras_tpu.data.loader import GraphBatchLoader as JLoader  # noqa: E402
from gcnn_keras_tpu.training import force_script as jfs  # noqa: E402
from gcnn_keras_tpu.training import history as jhistory  # noqa: E402
from gcnn_keras_tpu.training import losses as jlosses  # noqa: E402
from gcnn_keras_tpu.training import schedules as jschedules  # noqa: E402
from gcnn_keras_tpu.training.evaluation import evaluate_model as jevaluate  # noqa: E402
from gcnn_keras_tpu.training.fit import fit_model as jfit_model  # noqa: E402
from gcnn_keras_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from gcnn_keras_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint  # noqa: E402
from gcnn_keras_tpu.utils.data_splitter import kfold_swapped_val  # noqa: E402
from gcnn_keras_tpu_torch.batch import GraphBatch, batch_graphs  # noqa: E402
from gcnn_keras_tpu_torch.data.dataset import MemoryGraphDataset  # noqa: E402
from gcnn_keras_tpu_torch.data.scalers import EnergyForceExtensiveLabelScaler  # noqa: E402
from gcnn_keras_tpu_torch.layers.mlp import Dense  # noqa: E402
from gcnn_keras_tpu_torch.models.schnet import make_model as schnet  # noqa: E402
from gcnn_keras_tpu_torch.training import Trainer, force_script, history, schedules  # noqa: E402
from gcnn_keras_tpu_torch.training.callbacks import EarlyStopping  # noqa: E402
from gcnn_keras_tpu_torch.training.evaluation import evaluate_model  # noqa: E402
from gcnn_keras_tpu_torch.training.fit import fit_model  # noqa: E402
from gcnn_keras_tpu_torch.training.losses import masked_graph_mae  # noqa: E402
from gcnn_keras_tpu_torch.utils import plots, wandb_wizard  # noqa: E402
from gcnn_keras_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from gcnn_keras_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL, ENERGY_RTOL, ERRORS_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
SCRIPTS = ["force_schnet", "force_painn", "force_hdnnp2nd", "force_hdnnp4th",
           "energy_hdnnp4th", "charge_hdnnp4th"]
# narrow widths for the scripts whose CONFIG has no mlp_units
NARROW = {"force_schnet": {"schnet": {"depth": 1, "units": 16, "gauss_bins": 8,
                                      "gauss_distance": 5.0}},
          "force_painn": {"painn": {"depth": 1, "units": 16, "num_radial": 8, "cutoff": 5.0}}}
PREFIX = {"force_schnet": "model_schnet_force", "force_painn": "model_painn_force",
          "force_hdnnp2nd": "model_hdnnp2nd_force", "force_hdnnp4th": "model_energy_force",
          "energy_hdnnp4th": "model_hdnnp4th_energy", "charge_hdnnp4th": "model_hdnnp4th_charge"}


def _port(name):
    return importlib.import_module(f"gcnn_keras_tpu_torch.scripts.{name}")


def _tiny(name, **over):
    """``tests/test_force_script.py``'s ``_tiny`` settings."""
    cfg = dict(_port(name).CONFIG, synthetic_frames=6, batch_size=3, ensemble_size=2,
               epochs=2, make_plots=False, learning_rate_start=1e-3,
               learning_rate_stop=1e-4, **NARROW.get(name, {}))
    if "mlp_units" in cfg:
        cfg["mlp_units"] = [8, 8, 1]
    cfg.update(over)
    return cfg


def _assert_batches_equal(tb, jb):
    for name in GraphBatch.__dataclass_fields__:
        got, ref = getattr(tb, name), getattr(jb, name)
        if isinstance(ref, dict):
            assert sorted(got) == sorted(ref), name
            for k in ref:
                np.testing.assert_array_equal(got[k].cpu().numpy(), np.asarray(ref[k]))
        elif ref is None or isinstance(ref, (int, bool)):
            assert got == ref, name
        else:
            np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(ref), err_msg=name)


def _jax_dataset(name, cfg):
    """The dataset the JAX script trains on."""
    if name == "force_hdnnp4th":
        return importlib.import_module(name).load_dataset(cfg)
    return jfs.load_force_dataset({**jfs.DEFAULTS, **cfg})


def _global_keys(name, cfg):
    if name == "force_hdnnp4th" or {**jfs.DEFAULTS, **cfg}["need_esp"]:
        return ("energy", "total_charge")
    return ("energy",)


def _train_port(name, cfg):
    mod = _port(name)
    if name == "force_hdnnp4th":
        return mod.train(cfg)
    return force_script.run_force_training(mod.build_model, cfg)


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("name", SCRIPTS)
def test_config_equals_the_root_scripts(name):
    assert _port(name).CONFIG == importlib.import_module(name).CONFIG


@pytest.mark.parametrize("q,e,f", [(0.0, 1.0, 200.0), (50.0, 1.0, 200.0), (1.0, 0.0, 0.0),
                                   (0.0, 0.0, 0.0)])
def test_normalized_loss_weights_match_jax(q, e, f):
    cfg = {"charge_loss_weight": q, "energy_loss_weight": e, "force_loss_weight": f}
    assert force_script.normalized_loss_weights(cfg) == jfs.normalized_loss_weights(cfg)


@pytest.mark.parametrize("name", ["force_hdnnp2nd", "charge_hdnnp4th", "force_hdnnp4th"])
def test_datasets_match_jax(name):
    cfg = _tiny(name, synthetic_frames=5)
    ds = _port(name).load_dataset(cfg) if name == "force_hdnnp4th" \
        else force_script.load_force_dataset(force_script.script_config(_port(name), **cfg))
    ref = _jax_dataset(name, cfg)
    assert len(ds) == len(ref) == 5
    for g, r in zip(ds, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_parse_config_cli_takes_the_device(tmp_path, monkeypatch):
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"batch_size": 7}))
    monkeypatch.setattr(sys, "argv", ["force_schnet", "--conf", str(conf), "--epochs", "3",
                                      "--device", "cpu"])
    cfg = force_script.parse_config_cli(_port("force_schnet").CONFIG)
    assert (cfg["batch_size"], cfg["epochs"], cfg["device"]) == (7, 3, "cpu")
    monkeypatch.setattr(sys, "argv", ["force_schnet"])
    assert "device" not in force_script.parse_config_cli(_port("force_schnet").CONFIG)


@pytest.mark.parametrize("over", [{"n_devices": 2}, {"distributed": True, "n_devices": 2}])
def test_data_parallel_raises_naming_the_roadmap_item(over, monkeypatch):
    """The engine's data-parallel options run (``tests/test_torch_parallel.py``);
    what they still refuse: ``n_devices`` ranks on a machine with fewer
    cards, and ``distributed`` with an ``n_devices`` other than the
    group's size (no launcher here: 1 rank). Each raise names both counts."""
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = _tiny("force_schnet", **over)
    if over.get("distributed"):
        cfg["device"] = "cpu"
        match = r"make_mesh\(n_devices=2\).*1 rank"
    else:
        match = "2 ranks need 2 CUDA devices, but this machine has 1"
    with pytest.raises(ValueError, match=match):
        force_script.run_force_training(_port("force_schnet").build_model, cfg)


# ---------------------------------------------------------- schedules


@pytest.mark.parametrize("start,stop,steps", [(1e-3, 1e-5, 300), (1e-3, 1e-4, 4),
                                              (5e-4, 1e-6, 63), (1e-3, 1e-5, 0)])
def test_linear_schedule_equals_optax(start, stop, steps):
    ref, got = optax.linear_schedule(start, stop, steps), schedules.linear_schedule(start, stop, steps)
    jitted = jax.jit(ref)
    for k in range(steps + 5):
        assert got(k) == float(ref(jnp.int32(k))), k
        r = np.float32(jitted(jnp.int32(k)))
        assert abs(np.float32(got(k)) - r) <= np.spacing(np.float32(start)), k


@pytest.mark.parametrize("name,kw", [
    ("linear_warmup_exponential_decay", dict(lr_start=1e-3, warmup_steps=10, decay_steps=20.0,
                                             lr_min=1e-5)),
    ("linear", dict(lr_start=1e-3, lr_stop=1e-5, steps_total=50, steps_const=5)),
    ("linear_warmup_linear", dict(lr_start=1e-3, lr_stop=1e-4, warmup_steps=7, steps_total=40)),
    ("cosine_annealing", dict(lr_start=1e-3, steps_total=30, lr_min=1e-6)),
    ("constant", dict(lr=3e-4))])
def test_schedules_match_jax(name, kw):
    """In double precision here, float32 there: within two float32 epsilons
    of the schedule's largest rate."""
    ref, got = jschedules.get_schedule(name, **kw), schedules.get_schedule(name, **kw)
    atol = 2 * np.finfo(np.float32).eps * kw.get("lr_start", kw.get("lr"))
    for k in range(60):
        np.testing.assert_allclose(got(k), float(ref(jnp.int32(k))), rtol=0, atol=atol,
                                   err_msg=str(k))


def test_trainer_schedule_sets_each_updates_learning_rate():
    """Update k moves a parameter by ``schedule(k)`` times its gradient."""
    p = torch.nn.Parameter(torch.zeros(()))
    sched = schedules.linear_schedule(1.0, 0.25, 3)
    trainer = Trainer(lambda b: (p * 1.0, {}), lambda ps: torch.optim.SGD(ps, lr=9.0),
                      schedule=sched)
    state = trainer.init_state([p])
    moves = []
    for _ in range(5):
        before = p.item()
        state, _ = trainer.step(state, None)
        moves.append(before - p.item())
    np.testing.assert_allclose(moves, [sched(k) for k in range(5)], rtol=1e-6)
    assert state.step == 5


# ------------------------------------------------------------ fit loop


def _toy(seed=0):
    """A one-parameter regression both packages can train: y = a x."""
    rs = np.random.RandomState(seed)
    x = rs.randn(8).astype(np.float32)
    return x, 3.0 * x


def _port_toy(lr):
    x, y = map(torch.tensor, _toy())
    a = torch.nn.Parameter(torch.zeros(()))

    def loss_fn(b):
        err = (a * x - y).abs().mean()
        return err, {"mae": err.detach()}
    trainer = Trainer(loss_fn, lambda ps: torch.optim.Adam(ps, lr=lr))
    return trainer, trainer.init_state([a]), a


def _jax_toy(lr):
    x, y = map(jnp.asarray, _toy())

    def loss_fn(p, b):
        err = jnp.mean(jnp.abs(p * x - y))
        return err, {"mae": err}
    trainer = JTrainer(loss_fn, optax.adam(lr))
    return trainer, trainer.init_state(jnp.zeros(()))


@pytest.mark.parametrize("patience", [0, 2])
def test_fit_model_history_and_stop_match_jax(patience):
    """The same history keys, the same validation sequence consumed, the
    same stop epoch; on a stop the best epoch's weights come back."""
    seq = [1.0, 0.8, 0.5, 0.9, 0.9, 0.9, 0.9, 0.9]

    def scripted(snapshots):
        def eval_fn(params):
            snapshots.append(params[0].item() if isinstance(params, list) else float(params))
            return {"val_loss": seq[len(snapshots) - 1]}
        return eval_fn

    trainer, state, a = _port_toy(0.1)
    snaps = []
    state, hist = fit_model(trainer, state, [None, None], scripted(snaps), epochs=8,
                            early_stopping=patience, verbose_every=0)
    jtrainer, jstate = _jax_toy(0.1)
    jsnaps = []
    jstate, jhist = jfit_model(jtrainer, jstate, [None, None], scripted(jsnaps), epochs=8,
                               early_stopping=patience, verbose_every=0)
    # (a jitted step returns its metrics sorted by key; the order differs)
    assert sorted(hist) == sorted(jhist) == ["epoch_time", "loss", "mae", "val_loss"]
    assert len(hist["val_loss"]) == len(jhist["val_loss"]) == (5 if patience else 8)
    assert hist["val_loss"] == jhist["val_loss"]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    if patience:  # epoch 2's weights restored
        assert a.item() == snaps[2] and float(jstate.params) == jsnaps[2]
    else:
        assert a.item() == snaps[-1]


def test_early_stopping_keeps_a_copy_of_the_best_parameters():
    p = torch.nn.Parameter(torch.arange(3.0))
    stopper = EarlyStopping(patience=1)
    assert not stopper.update(0, {"val_loss": 1.0}, [p])
    with torch.no_grad():
        p.add_(10.0)
    assert stopper.update(1, {"val_loss": 2.0}, [p]) and stopper.stopped_epoch == 1
    stopper.restore([p])
    assert p.tolist() == [0.0, 1.0, 2.0] and p.requires_grad


def test_fit_model_steps_per_dispatch_gives_the_same_history():
    """K steps a dispatch run as K sequential steps: the same history as
    K = 1 (``tests/test_training.py`` pins the same for JAX)."""
    hists = []
    for k in (1, 3):
        trainer, state, a = _port_toy(0.05)
        _, hist = fit_model(trainer, state, [None] * 7, lambda p: {"val_loss": a.item()},
                            epochs=3, steps_per_dispatch=k, verbose_every=0)
        hists.append({key: v for key, v in hist.items() if key != "epoch_time"})
    assert hists[0] == hists[1]


def test_save_history_score_matches_jax(tmp_path):
    hists = [{"loss": [3.0, 2.0], "val_loss": [2.5, 1.5], "epoch_time": [0.1, 0.2]},
             {"loss": [4.0, 1.0], "force_mae": [0.3]}]
    kw = dict(model_name="m", dataset_name="d", seed=4, time_list=[1.5, 2.5])
    got = history.save_history_score(hists, str(tmp_path / "a" / "port.yaml"), **kw)
    ref = jhistory.save_history_score(hists, str(tmp_path / "b" / "jax.yaml"), **kw)
    got.pop("date_time"), ref.pop("date_time")
    assert got == ref
    loaded = history.load_history_score(str(tmp_path / "a" / "port.yaml"))
    assert loaded["loss_mean"] == ref["loss_mean"] and loaded["execute_time"] == [1.5, 2.5]


def test_wandb_and_plots_follow_the_jax_package(monkeypatch):
    assert wandb_wizard.init_wandb("p", enabled=False) is None
    wandb_wizard.log_wandb({"loss": 1.0})
    wandb_wizard.finish_wandb()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        plots.plot_predict_true(np.ones(3), np.ones(3))


def test_checkpoint_round_trip(tmp_path):
    model = schnet(device="cpu", depth=1, interaction_args={"units": 8})
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    path = save_checkpoint(str(tmp_path / "ck"), model, opt, step=4, fold=1)
    assert path.endswith("step_4") and os.path.isdir(path)
    save_checkpoint(str(tmp_path / "ck"), model, step=2)
    ck = load_checkpoint(str(tmp_path / "ck"))
    assert ck["extra"] == {"fold": 1}
    fresh = schnet(device="cpu", depth=1, interaction_args={"units": 8},
                   generator=torch.Generator().manual_seed(5))
    fresh.load_state_dict(ck["params"])
    for p, q in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(p, q)
    opt2 = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    opt2.load_state_dict(ck["opt_state"])
    assert opt2.state_dict()["state"][0]["step"] == 1
    assert "opt_state" not in load_checkpoint(str(tmp_path / "ck"), step=2)


# ------------------------------------------------- engine against JAX


class _Stop(Exception):
    pass


def _first_port_step(name, cfg, params, monkeypatch):
    """The port engine's first training step from JAX's ``params``: its
    batch, loss, and each trained parameter's (name, gradient)."""
    mod = _port(name)
    build_model = mod.build_model

    def build(c, device=None, generator=None):
        fm = build_model(c, device=device, generator=generator)
        params_from_jax(fm.energy_model, params)
        return fm

    monkeypatch.setattr(mod, "build_model", build)
    seen = {}

    def first_step(trainer, state, batches, *args, **kwargs):
        batch = next(iter(batches))
        state, metrics = trainer.step(state, batch)
        seen.update(batch=batch, loss=float(metrics["loss"]),
                    grads=[p.grad.clone() for p in state.params])
        raise _Stop

    monkeypatch.setattr(force_script, "fit_model", first_step)
    with pytest.raises(_Stop):
        _train_port(name, dict(cfg, device="cpu"))
    return seen


def _jax_first_step(name, cfg):
    """The JAX engine's fold 0 up to its first step: the params it
    initialises, the batch of its first step, and the loss and gradients
    there (its loss closure, written out)."""
    full = {**jfs.DEFAULTS, **cfg} if name != "force_hdnnp4th" else dict(cfg)
    ds = _jax_dataset(name, cfg)
    keys = _global_keys(name, cfg)
    tr, _, _ = next(kfold_swapped_val(len(ds), k=full["ensemble_size"], seed=full["seed"]))
    train = ds[tr]
    scaler = jscalers.EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(train)
    scaler.transform_dataset(train)
    fmodel = importlib.import_module(name).build_model(cfg)
    loader = JLoader(list(train), full["batch_size"], shuffle=True, seed=full["seed"],
                     global_keys=keys, **train.batch_shape_hint(full["batch_size"]))
    params = fmodel.init(jax.random.PRNGKey(full["seed"]), next(iter(loader)), train=False)
    batch = next(iter(loader))
    w = jfs.normalized_loss_weights(full)

    def loss_fn(p, b):
        out = fmodel.apply(p, b, train=False)
        loss = 0.0
        if w["energy"] > 0:
            loss += w["energy"] * jlosses.masked_graph_mae(out["energy"], b.globals["energy"],
                                                           b.globals["graph_mask"])
        if w["force"] > 0:
            loss += w["force"] * jlosses.masked_node_mae(out["force"], b.nodes["force"],
                                                         b.node_mask)
        if w["charge"] > 0 and "charge" in out:
            loss += w["charge"] * jlosses.masked_node_mae(out["charge"], b.nodes["charge"],
                                                          b.node_mask)
        return loss
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, batch, float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("name", ["force_schnet", "force_hdnnp2nd", "force_hdnnp4th"])
def test_first_engine_step_matches_jax(name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    cfg = _tiny(name, synthetic_frames=12)
    params, jbatch, jloss, jgrads = _jax_first_step(name, cfg)
    seen = _first_port_step(name, cfg, params, monkeypatch)
    _assert_batches_equal(seen["batch"], jbatch)
    np.testing.assert_allclose(seen["loss"], jloss, rtol=LOSS_RTOL)
    ref_model = params_from_jax(_port(name).build_model(cfg, device="cpu").energy_model, jgrads)
    ref = [(n, p) for n, p in ref_model.named_parameters() if p.requires_grad]
    assert len(ref) == len(seen["grads"]) > 0
    for (n, r), g in zip(ref, seen["grads"]):
        r = r.detach()
        assert (g - r).abs().max() <= GRAD_TOL * r.abs().max(), n


@pytest.fixture(scope="module")
def jax_schnet_run(tmp_path_factory):
    """One tiny run of the JAX engine on the SchNet script."""
    workdir = tmp_path_factory.mktemp("jax_engine")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        cfg = _tiny("force_schnet", epochs=1, synthetic_frames=9)
        jfs.run_force_training(importlib.import_module("force_schnet").build_model, cfg)
    finally:
        os.chdir(cwd)
    return workdir, cfg


def _test_split(cfg, scaler_path):
    """Fold 0's test split of the engine's dataset, scaled by the fold's
    ``scaler.json``."""
    ds = force_script.load_force_dataset(force_script.script_config(_port("force_schnet"), **cfg))
    _, _, te = next(kfold_swapped_val(len(ds), k=cfg["ensemble_size"], seed=cfg["seed"]))
    test = ds[te]
    EnergyForceExtensiveLabelScaler().load(scaler_path).transform_dataset(test)
    return MemoryGraphDataset(graphs=list(test))


def test_jax_engine_checkpoint_loads_into_the_port_model(jax_schnet_run):
    workdir, cfg = jax_schnet_run
    ck = jload_checkpoint(str(workdir / "model_schnet_force_0"))
    jm = importlib.import_module("force_schnet").build_model(cfg)
    fm = _port("force_schnet").build_model(cfg, device="cpu")
    params_from_jax(fm.energy_model, jax.tree_util.tree_map(np.asarray, ck["params"]))
    graphs = [dict(g) for g in _test_split(cfg, str(workdir / "model_schnet_force_0" /
                                                   "scaler.json"))]
    from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
    ref = np.asarray(jm.apply(ck["params"], jbatch_graphs(graphs, global_keys=("energy",)),
                              train=False)["energy"])
    # the energies (about 1e-3 after one step) are sums of larger terms in
    # the last Dense: hold them to ENERGY_RTOL of those terms' magnitude
    last = [m for m in fm.energy_model.output_mlp.modules() if isinstance(m, Dense)][-1]
    seen = {}
    hook = last.register_forward_hook(lambda m, inp, out: seen.update(x=inp[0].detach()))
    got = fm.apply(batch_graphs(graphs, global_keys=("energy",), device="cpu"))["energy"]
    hook.remove()
    terms = (seen["x"].abs() @ last.weight.detach().abs().T + last.bias.detach().abs()).max()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=ENERGY_RTOL,
                               atol=ENERGY_RTOL * terms.item())


def test_evaluate_model_errors_match_the_jax_engine(jax_schnet_run, tmp_path):
    workdir, cfg = jax_schnet_run
    fold_dir = workdir / "model_schnet_force_0"
    ck = jload_checkpoint(str(fold_dir))
    fm = _port("force_schnet").build_model(cfg, device="cpu")
    params_from_jax(fm.energy_model, jax.tree_util.tree_map(np.asarray, ck["params"]))
    test = _test_split(cfg, str(fold_dir / "scaler.json"))
    scaler = EnergyForceExtensiveLabelScaler().load(str(fold_dir / "scaler.json"))
    empty = np.array([], np.int64)
    got = evaluate_model(test, fm, (empty, empty, np.arange(len(test))), scaler=scaler,
                         output_dir=str(tmp_path), dataset_name="force",
                         model_name=cfg["model_prefix"], global_keys=("energy",),
                         make_plots=False)
    ref = json.loads((fold_dir / "errors.json").read_text())
    assert sorted(got) == sorted(ref) and any(k.startswith("Test") for k in got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=ERRORS_RTOL, err_msg=k)
    assert json.loads((tmp_path / "errors.json").read_text()) == got
    for f in ("geoms.extxyz", "energy_predictions.csv", "force_predictions.csv"):
        got_lines = (tmp_path / f).read_text().splitlines()
        ref_lines = (fold_dir / f).read_text().splitlines()
        assert len(got_lines) == len(ref_lines) and got_lines[0] == ref_lines[0], f


def test_evaluate_model_matches_jax_with_charges_on_every_split(tmp_path):
    """``force_hdnnp4th``'s evaluation (every split, charges) on JAX's
    initial params."""
    cfg = _tiny("force_hdnnp4th", synthetic_frames=9)
    ds = importlib.import_module("force_hdnnp4th").load_dataset(cfg)
    pds = _port("force_hdnnp4th").load_dataset(cfg)
    jm = importlib.import_module("force_hdnnp4th").build_model(cfg)
    params = jm.init(jax.random.PRNGKey(1), JDataset(graphs=list(ds)).to_batch(
        global_keys=("energy", "total_charge")), train=False)
    fm = _port("force_hdnnp4th").build_model(cfg, device="cpu")
    params_from_jax(fm.energy_model, jax.tree_util.tree_map(np.asarray, params))
    indices = (np.arange(4), np.arange(4, 6), np.arange(6, 9))
    scaler, jscaler = EnergyForceExtensiveLabelScaler(), jscalers.EnergyForceExtensiveLabelScaler()
    scaler.fit_dataset(pds[:4])
    jscaler.fit_dataset(ds[:4])
    ref = jevaluate(JDataset(graphs=list(ds)), jm, params, indices, scaler=jscaler,
                    output_dir=str(tmp_path / "jax"), make_plots=False, eval_batch_size=4)
    got = evaluate_model(MemoryGraphDataset(graphs=list(pds)), fm, indices, scaler=scaler,
                         output_dir=str(tmp_path / "port"), make_plots=False, eval_batch_size=4)
    assert sorted(got) == sorted(ref) and len(got) == 27
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=ERRORS_RTOL, err_msg=k)
    for f in ("charge_predictions.csv", "energy_predictions.csv", "force_predictions.csv"):
        got_rows = np.genfromtxt(tmp_path / "port" / f, delimiter=",", names=True, dtype=None,
                                 encoding=None)
        ref_rows = np.genfromtxt(tmp_path / "jax" / f, delimiter=",", names=True, dtype=None,
                                 encoding=None)
        assert got_rows.dtype.names == ref_rows.dtype.names
        label = f.split("_")[0]
        np.testing.assert_array_equal(got_rows[f"{label}_reference"],
                                      ref_rows[f"{label}_reference"])
        if "at_types" in got_rows.dtype.names:
            assert list(got_rows["at_types"]) == list(ref_rows["at_types"])


# ------------------------------------------------------- end to end


def _assert_run_artifacts(prefix, folds=2, score=None):
    """``tests/test_force_script.py``'s artifact set."""
    score = score or f"results/{prefix}_score.yaml"
    assert os.path.exists(score), score
    for fold in range(folds):
        outdir = f"{prefix}_{fold}"
        for fname in ("scaler.json", "errors.json", "geoms.extxyz", "energy_predictions.csv"):
            assert os.path.exists(os.path.join(outdir, fname)), f"{outdir}/{fname}"
        with open(os.path.join(outdir, "errors.json")) as fh:
            assert any(k.startswith("Test") for k in json.load(fh))
        assert load_checkpoint(outdir)["params"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs_end_to_end(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    score = _train_port(name, _tiny(name, device="cpu"))
    assert np.isfinite(score["loss_mean"]) and score["loss_mean"] < 100.0
    assert score["number_histories"] == 2 and len(score["execute_time"]) == 2
    if name == "force_hdnnp4th":
        _assert_run_artifacts(PREFIX[name], score="results/hdnnp4th_score.yaml")
        errors = json.loads((tmp_path / f"{PREFIX[name]}_0" / "errors.json").read_text())
        assert {k.split()[0] for k in errors} == {"Train", "Val", "Test"}
    else:
        _assert_run_artifacts(PREFIX[name])


def test_engine_leaves_the_dataset_unscaled(tmp_path, monkeypatch):
    """The splits are copies: after every fold the dataset holds its raw
    labels, so no fold scales another's labels again."""
    monkeypatch.chdir(tmp_path)
    cfg = _tiny("force_schnet", device="cpu", ensemble_size=3, synthetic_frames=9)
    loaded = []
    load = force_script.load_force_dataset
    monkeypatch.setattr(force_script, "load_force_dataset",
                        lambda c: loaded.append(load(c)) or loaded[-1])
    force_script.run_force_training(_port("force_schnet").build_model, cfg)
    fresh = load({**force_script.DEFAULTS, **cfg})
    for g, r in zip(loaded[0], fresh):
        for k in ("energy", "force"):
            np.testing.assert_array_equal(g[k], r[k])


def test_engine_validates_on_the_whole_split(tmp_path, monkeypatch):
    """``val_energy_mae`` is the MAE over the validation split in one
    batch, as the evaluation's scaled labels give it."""
    monkeypatch.chdir(tmp_path)
    cfg = _tiny("force_schnet", device="cpu", epochs=1)
    seen = {}
    fit = force_script.fit_model

    def record(trainer, state, batches, eval_fn, *args, **kw):
        seen["eval"] = eval_fn
        return fit(trainer, state, batches, eval_fn, *args, **kw)

    monkeypatch.setattr(force_script, "fit_model", record)
    force_script.run_force_training(_port("force_schnet").build_model, cfg)
    out = seen["eval"](None)
    assert set(out) == {"val_energy_mae", "val_force_mae", "val_loss"}
    w = force_script.normalized_loss_weights(cfg)
    assert out["val_loss"] == pytest.approx(w["energy"] * out["val_energy_mae"]
                                            + w["force"] * out["val_force_mae"])
    assert masked_graph_mae(torch.zeros(2, 1), torch.ones(2, 1),
                            torch.tensor([True, False])).item() == 1.0


# ------------------------------------------------- chip_smoke phase 19


@pytest.mark.parametrize("name", SCRIPTS)
def test_chip_smoke_phase_19_runs_on_the_cpu(name, monkeypatch):
    """``chip_smoke.py`` phase 19 on the CPU at the scripts' widths on 24
    frames, each kernel wrapper call counted as the card counts its
    launches: the first step against the CPU, its kernel calls and every
    step's launches against its path's, falling losses, the artifacts and
    the reloaded checkpoint's energies."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for kname, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=kname):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)
    cuts = dict(epochs=2, synthetic_frames=24, batch_size=4, make_plots=False)
    launches, recs = chip_smoke.phase_script(name, "cpu", "cpu", cuts=cuts)
    path = chip_smoke.SCRIPT_PATHS[name]
    calls = {k: len(r) for k, r in recs.items()}
    if path:
        assert calls == {k: v for k, v in chip_smoke.TRAIN_PATHS[path]["launches"].items() if v}
    assert calls and all(launches[k] >= calls[k] for k in calls)
