"""The force driver ``train_force`` of the port against the JAX package's
(``training/train_force.py``), its warm-up cosine schedule against
``optax``, and ``chip_smoke.py`` phase 24 on the CPU.

Each driver runs to its first fold's training and is stopped there, on
both sides, where it calls ``fit_model``. The fold's training frames are
the same arrays, the first epoch's first batch is the same batch, and with
the JAX driver's initial weights carried into the port model its loss and
parameter gradients (through the forces, a second derivative) are the JAX
``Trainer`` step's: the loss within ``rtol 1e-5``, each gradient within
``1e-5`` of its tensor's largest entry or by ``chip_smoke.check_grads``'
float64 rules.
"""
import copy
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu_torch.scripts import train_force
from gcnn_keras_tpu_torch.training import fit, schedules
from gcnn_keras_tpu_torch.training.history import load_history_score
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.torch_jax_jit import jit_energy_force_init
from tests.test_torch_datasets import archives, reading_jax_deserialize, serve  # noqa: F401
from tests.test_torch_zoo_scripts import _Everything, counted_kernels  # noqa: F401 (a fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-5


class _Stop(Exception):
    pass


def _jax_driver(argv, monkeypatch):
    """The JAX driver's first fold, stopped where it calls ``fit_model``:
    ``(trainer, state, loader)``."""
    import gcnn_keras_tpu.training.fit as jfit
    spec = importlib.util.spec_from_file_location(
        "_jax_train_force", os.path.join(ROOT, "training", "train_force.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def stop(trainer, state, epoch_batches, *a, **kw):
        seen.update(trainer=trainer, state=state, loader=epoch_batches())
        raise _Stop
    monkeypatch.setattr(jfit, "fit_model", stop)
    monkeypatch.setattr(sys, "argv", ["train_force"] + argv)
    jit_energy_force_init(monkeypatch)
    with pytest.raises(_Stop):
        mod.main()
    return seen["trainer"], seen["state"], seen["loader"]


def _port_driver(argv, monkeypatch):
    """The port driver's first fold, stopped where it calls ``fit_model``:
    ``(EnergyForceModel, trainer, loader)``."""
    seen = {}
    build = train_force.build_model

    def recording(*a, **kw):
        seen["fmodel"] = build(*a, **kw)
        return seen["fmodel"]

    def stop(trainer, state, loader, *a, **kw):
        seen.update(trainer=trainer, loader=loader)
        raise _Stop
    monkeypatch.setattr(train_force, "build_model", recording)
    monkeypatch.setattr(fit, "fit_model", stop)
    with pytest.raises(_Stop):
        train_force.main(argv + ["--device", "cpu"])
    return seen["fmodel"], seen["trainer"], seen["loader"]


def _same_graphs(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


FIELDS = ("senders", "receivers", "edge_mask", "node_mask", "angle_edges", "angle_edge_mask",
          "angle_edges_2", "angle_edge_mask_2", "senders2", "receivers2", "edge2_mask")


def _first_step_matches(argv, model, monkeypatch):
    """The fold's frames, the first batch and the first step of the two
    drivers run with ``argv``."""
    jtrainer, jstate, jloader = _jax_driver(argv, monkeypatch)
    fmodel, trainer, loader = _port_driver(argv, monkeypatch)
    _same_graphs(loader.graphs, jloader.graphs)
    assert loader.batch_kwargs == {**jloader.batch_kwargs, "n_graph_pad":
                                   loader.batch_kwargs["n_graph_pad"]}
    jbatch, batch = next(iter(jloader)), next(iter(loader))
    for field in FIELDS:
        got, want = getattr(batch, field), getattr(jbatch, field)
        assert (got is None) == (want is None), field
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=field)
    for key in ("node_coordinates", "node_number", "force"):
        np.testing.assert_array_equal(batch.nodes[key].numpy(), np.asarray(jbatch.nodes[key]))
    np.testing.assert_array_equal(batch.globals["energy"].numpy(),
                                  np.asarray(jbatch.globals["energy"]))

    variables = jax.tree_util.tree_map(np.asarray, jstate.params)
    params_from_jax(fmodel.energy_model, variables)
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(jtrainer.loss_fn, has_aux=True))(
        jstate.params, jbatch)
    loss, aux = trainer.loss_fn(batch)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for k in ("energy_mae", "force_mae"):
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-5)
    names, params = zip(*fmodel.energy_model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    args = train_force.parser().parse_args(argv)
    builder = train_force.build_model(model, "cpu", torch.Generator().manual_seed(0),
                                      train_force.load_hyper(args))
    ref = {n: p.detach() for n, p in params_from_jax(builder.energy_model, {
        "params": jax.tree_util.tree_map(np.asarray, ref_grads["params"])}).named_parameters()}
    import chip_smoke

    def exact():  # the port's gradients of the same loss in float64
        return chip_smoke.float64_grads(
            copy.deepcopy(fmodel.energy_model),
            lambda m, b: train_force.loss_fn(train_force.EnergyForceModel(m, device="cpu"),
                                             1.0, 50.0)(b)[0], batch)
    chip_smoke.check_grads(f"train_force {model}",
                           {n: g for n, g in zip(names, grads) if g is not None},
                           ref, GRAD_TOL, exact)
    for n, g in zip(names, grads):
        if g is None:  # the forces do not see the last bias
            assert not ref[n].any(), n


@pytest.mark.parametrize("model", ["MXMNet", "EGNN"])
def test_first_step_matches_the_jax_driver(model, monkeypatch, tmp_path):
    """The fold's frames (MXMNet's multiplex graphs and pair lists
    included), the first batch and the first step of 32 frames."""
    monkeypatch.chdir(tmp_path)
    _first_step_matches(["--model", model, "--frames", "32", "--epochs", "2", "--no-plots"],
                        model, monkeypatch)


HYPER_MD = os.path.join(ROOT, "training", "hyper", "hyper_synthetic_md.py")


@pytest.mark.parametrize("model", ["Schnet", "PAiNN"])
def test_hyper_first_step_matches_the_jax_driver(model, monkeypatch, tmp_path):
    """``--hyper hyper_synthetic_md.py``: the config's dataset (256 frames,
    its ``set_range`` method, then the driver's), its model at the config's
    widths and its optimizer; the fold's frames, the first batch and the
    first step against the JAX driver's."""
    monkeypatch.chdir(tmp_path)
    _first_step_matches(["--hyper", HYPER_MD, "--model", model, "--epochs", "1",
                         "--no-plots"], model, monkeypatch)


def test_hyper_driver_trains_with_the_configs_optimizer(tmp_path, monkeypatch):
    """The ``--hyper`` run's model and optimizer are the config's (Adam at
    its constant 1e-3, no schedule); it trains and writes its score."""
    from gcnn_keras_tpu_torch.training import optimizers
    monkeypatch.chdir(tmp_path)
    args = train_force.parser().parse_args(["--hyper", HYPER_MD, "--model", "PAiNN"])
    hyper = train_force.load_hyper(args)
    factory, schedule = train_force.optimizer_for(args, hyper)
    assert schedule is None
    opt = factory([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, optimizers.OptaxAdam) and opt.param_groups[0]["lr"] == 1e-3
    fm = train_force.build_model("PAiNN", "cpu", torch.Generator().manual_seed(0), hyper)
    assert fm.energy_model.config["depth"] == 3
    score = train_force.main(["--device", "cpu", "--hyper", HYPER_MD, "--model", "Schnet",
                              "--epochs", "1", "--batch-size", "64", "--no-plots"])
    assert np.isfinite(score["loss"]).all()
    assert (tmp_path / "results/force/Schnet_score.yaml").exists() or \
        (tmp_path / "results/force/Schnet_score.json").exists()


def test_the_schedule_is_optax_warmup_cosine_decay():
    import optax
    for init, peak, warmup, decay, end in ((0.0, 1e-3, 6, 12, 0.0), (0.0, 1e-3, 50, 400, 0.0),
                                           (1e-4, 2e-3, 3, 20, 1e-5)):
        ours = schedules.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
        ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
        got = np.array([ours(k) for k in range(decay + 5)])
        want = np.array([float(ref(k)) for k in range(decay + 5)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    args = train_force.parser().parse_args(["--epochs", "3", "--frames", "128"])
    sched = train_force.schedule_for(args)  # 24 steps: a warm-up of 2
    assert sched(0) == 0.0 and sched(2) == pytest.approx(1e-3) and sched(24) == 0.0
    with pytest.raises(ValueError, match="decay_steps"):
        schedules.warmup_cosine_decay_schedule(0.0, 1e-3, 5, 5)


def test_hyper_md17_first_step_matches_the_jax_driver(archives, monkeypatch, tmp_path):
    """``--hyper hyper_md17.py --model Schnet.EnergyForceModel`` on a
    synthesized ``aspirin_ccsd`` trajectory served by ``file://``: the
    config's ``MD17Dataset`` read (the JAX one read too, where its
    ``deserialize`` builds it empty), then the fold's frames, the first
    batch and the first step against the JAX driver's."""
    serve(monkeypatch, archives, tmp_path)
    reading_jax_deserialize(monkeypatch)
    monkeypatch.chdir(tmp_path)
    model = "Schnet.EnergyForceModel"
    _first_step_matches(["--hyper", os.path.join(ROOT, "training", "hyper", "hyper_md17.py"),
                         "--model", model, "--epochs", "1", "--batch-size", "2", "--no-plots"],
                        model, monkeypatch)


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--n-devices", "2"], "2 ranks need 2 CUDA devices, but this machine has 1",
                 id="argv0-Parallel"),
    pytest.param(["--distributed", "--n-devices", "2", "--device", "cpu"],
                 r"make_mesh\(n_devices=2\).*1 rank", id="argv1-Parallel")])
def test_unported_options_raise(argv, match, tmp_path, monkeypatch):
    """``--n-devices`` and ``--distributed`` run (``tests/test_torch_parallel.py``
    holds ``--n-devices 2 --device cpu`` against the JAX driver); what they
    still refuse: more ranks than the machine has cards, and an
    ``--n-devices`` other than the launcher's group (none here: 1 rank)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
                 "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match=match):
        train_force.main(argv + ["--frames", "16"])


def test_dimenet_stops_at_its_first_batch_in_both_packages(tmp_path, monkeypatch):
    """The driver computes pairs for MXMNet alone, so DimeNet++ has no
    ``angle_edges``: the JAX driver's assert, the port's ``ValueError``."""
    monkeypatch.chdir(tmp_path)
    argv = ["--model", "DimeNetPP", "--frames", "32", "--epochs", "1", "--no-plots"]
    spec = importlib.util.spec_from_file_location(
        "_jax_train_force_dime", os.path.join(ROOT, "training", "train_force.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_force"] + argv)
    with pytest.raises(AssertionError, match="angle_edges"):
        mod.main()
    with pytest.raises(ValueError, match="angle_edges"):
        train_force.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("model", ["MXMNet", "EGNN", "Megnet", "Schnet"])
def test_driver_trains_and_writes_its_artifacts(model, tmp_path, monkeypatch):
    """Two epochs of two folds of 32 frames on the CPU: finite losses, the
    score file, the last fold's checkpoint and scaler."""
    monkeypatch.chdir(tmp_path)
    score = train_force.main(["--device", "cpu", "--model", model, "--frames", "32",
                              "--epochs", "2", "--folds", "2", "--no-plots",
                              "--checkpoint-dir", "ckpt"])
    path = tmp_path / "results" / "force" / f"{model}_score.yaml"
    assert path.exists() or path.with_suffix(".json").exists()
    assert load_history_score(str(path))["number_histories"] == 2
    assert score["number_histories"] == 2 and np.isfinite(score["loss"]).all()
    assert (tmp_path / "ckpt" / "step_2" / "checkpoint.pt").exists()
    assert (tmp_path / "ckpt" / "scaler.json").exists()


def test_driver_draws_its_plots(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    train_force.main(["--device", "cpu", "--model", "EGNN", "--frames", "32", "--epochs", "1"])
    assert (tmp_path / "results/force/EGNN_loss.png").exists()
    assert (tmp_path / "results/force/EGNN_fold0/predict_force.png").exists()


# --------------------------------------------------------- chip_smoke phase 24


PHASE_24 = ["EGNN", "Megnet", "CGCNN", "DimeNetPP", "MXMNet", "CGCNN-crystal",
            "Megnet-crystal", "DimeNetPP-crystal"]


@pytest.mark.parametrize("name", PHASE_24)
def test_chip_smoke_phase_24_model_runs_on_the_cpu(name, counted_kernels):
    """Phase 24's checks of one path on 16 frames, molecules or graphs: the
    forward and first step against the CPU, every kernel call against its
    plain version, the derived launches (``ZOO_LAUNCHES``) of a forward and
    of every step."""
    cs = counted_kernels
    profiles = []
    paths, recs = cs.phase_zoo_model(name, "cpu", _Everything(), profiles, device="cpu",
                                     n_mols=16)
    fwd, step = cs.ZOO_LAUNCHES[name]
    assert paths[f"{name}_zoo_forward"] == cs.launch_counts(sorted_segment_sum=fwd)
    assert paths[f"{name}_zoo_train"] == cs.launch_counts(
        sorted_segment_sum=cs.ZOO_STEPS * step)
    assert len(recs) == fwd + step and len(profiles) == 1


@pytest.mark.parametrize("model", ["MXMNet", "EGNN"])
def test_chip_smoke_phase_24_driver_runs_on_the_cpu(model, counted_kernels):
    cs = counted_kernels
    paths, recs = cs.phase_zoo_driver("train_force", model, "cpu", device="cpu")
    calls = {k: len(r) for k, r in recs.items()}
    launches = paths[f"train_force_{model}"]
    assert calls["sorted_segment_sum"] == cs.ZOO_LAUNCHES[model][1]
    assert launches["sorted_segment_sum"] > calls["sorted_segment_sum"]


def test_phase_24_batches_have_their_shapes():
    """Each phase 24 batch at 512 frames, molecules or graphs as
    ``ZOO_SHAPES`` holds it; the models read what their batches carry: the
    energies and forces of ``train_force``'s frames for the force
    potentials, the lattices for the crystals, DimeNet++'s pairs, and
    MXMNet's pairs and range edges."""
    import chip_smoke as cs
    for name in PHASE_24:
        b = cs.zoo_batch(name, "cpu")
        assert cs.zoo_shapes(b) == cs.ZOO_SHAPES[name], name
        inputs = cs.ZOO_MODELS[name][1]
        if inputs.get("force"):
            assert "energy" in b.globals and "force" in b.nodes, name
            assert int(b.node_mask.sum()) == 512 * 9, name  # SyntheticMDDataset's molecule
        assert ("graph_lattice" in b.globals) == ("crystal" in inputs), name
        assert ("range_image" in b.edges) == ("crystal" in inputs), name
        assert int(b.globals["graph_mask"].sum()) == 512


def test_zero_heads_are_filled_from_a_seed():
    """Phase 24's DimeNet++ and MXMNet heads: drawn (not zeros), the same
    on every build; nothing else of the model changes."""
    import chip_smoke as cs
    from gcnn_keras_tpu_torch.models import dimenet_pp, mxmnet
    for name, make, head in (("DimeNetPP", dimenet_pp.make_model, "output_0.out.weight"),
                             ("MXMNet", mxmnet.make_model, "local_0.y_W.weight")):
        a, b = cs.zoo_model(name, "cpu"), cs.zoo_model(name, "cpu")
        fresh = dict(make(device="cpu", generator=torch.Generator().manual_seed(0))
                     .named_parameters())
        for n, p in a.named_parameters():
            assert torch.equal(p, dict(b.named_parameters())[n]), n
            if (n.startswith("output_") and n.endswith(".out.weight")) or \
                    n.endswith("y_W.weight"):
                assert p.abs().max() > 0 and not fresh[n].any(), n
            else:
                assert torch.equal(p, fresh[n]), n
        assert head in fresh


def _float32_spread(name, n_mols):
    """``(port, jax, float64)``: the gradients by the port's names of
    ``chip_smoke.zoo_force_loss`` on phase 24's first ``n_mols`` frames
    (``ZOO_MODELS[name]`` at its default widths, phase 24's weights) from
    the port in float32, from JAX in float32 on the same weights, and from
    the port in float64."""
    import functools
    import importlib

    import jax.numpy as jnp

    import chip_smoke as cs
    from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
    from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
    from gcnn_keras_tpu.training import losses as jlosses
    from gcnn_keras_tpu_torch.utils import convert
    tb = cs.zoo_batch(name, "cpu", n_mols=n_mols)
    jb = jbatch_graphs(cs.zoo_graphs(name, n_mols), **cs.zoo_batch_kw(name))
    model = cs.zoo_model(name, "cpu")
    tree, flax_of = {}, {}
    for key, p, transposed in convert._flax_leaves(model):
        node = tree
        for k in key.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[key.split("/")[-1]] = (p.detach().numpy().T if transposed
                                    else p.detach().numpy()).copy()
        flax_of[id(p)] = (key, transposed)
    jfm = JEnergyForceModel(importlib.import_module(
        f"gcnn_keras_tpu.models.{cs.ZOO_MODELS[name][0]}").make_model())

    def jloss(params, b):
        out = jfm.apply({"params": params}, b)
        return jlosses.masked_graph_mae(out["energy"], b.globals["energy"],
                                        b.globals["graph_mask"]) + \
            50.0 * jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
    j32 = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree), jb))
    names, params = zip(*model.named_parameters())
    p32 = {n: g for n, g in zip(names, torch.autograd.grad(
        cs.zoo_force_loss(model, tb), params, allow_unused=True)) if g is not None}
    p64 = cs.float64_grads(copy.deepcopy(model), cs.zoo_force_loss, tb)
    jax32 = {}
    for n, p in zip(names, params):
        if n not in p32:
            continue
        key, transposed = flax_of[id(p)]
        leaf = np.asarray(functools.reduce(lambda d, k: d[k], key.split("/"), j32))
        jax32[n] = torch.from_numpy((leaf.T if transposed else leaf).copy())
    return p32, jax32, p64


# the fault planted in one tensor of each potential's gradients: 10%, or
# 100% for MXMNet, whose float32 gradients lie up to 6.5% from float64
FAULTS = {"EGNN": 0.1, "Megnet": 0.1, "DimeNetPP": 0.1, "MXMNet": 1.0}


@pytest.mark.parametrize("name", ["EGNN", "Megnet", "DimeNetPP", "MXMNet"])
def test_force_gradients_on_the_frames_meet_the_float64_rules(name):
    """Phase 24's force step on its first 64 frames (``train_force``'s
    geometry): the port's float32 gradients against JAX's by
    ``check_grads``' float64 rules, and JAX's against the port's (Megnet's
    against its float64 gradients: JAX's are NaN through Set2Set); a fault
    of ``FAULTS[name]`` in the tensor of the largest gradient is refused.
    EGNN's, Megnet's and DimeNet++'s float32 gradients lie within 1e-5 of
    each tensor's largest entry from float64 in both packages. MXMNet's
    filled heads give energies of some 5e5 and forces of some 7e6 against
    labels below 10, and its float32 gradients lie up to 6.5e-2 (the port)
    and 5.4e-2 (JAX) from float64: the second rule holds each tensor within
    ``ARBITER_FACTOR`` times JAX's distance. Run with ``-s`` it prints the
    largest shares."""
    import chip_smoke as cs
    p32, jax32, p64 = _float32_spread(name, 64)

    def share(g, n):
        return (g[n].double() - p64[n]).abs().max().item() / p64[n].abs().max().item()
    names = [n for n in p32 if p64[n].abs().max() > 0]
    port = max(share(p32, n) for n in names)
    message = f"{name}: float32 gradients up to {port:.3g} from float64 (the port)"
    if name == "Megnet":
        pairs = ((p32, p64),)
    else:
        pairs = ((p32, jax32), (jax32, p32))
        ratios = [share(p32, n) / share(jax32, n) for n in names if share(jax32, n) > 0]
        message += (f", {max(share(jax32, n) for n in names):.3g} (JAX); the port at "
                    f"{min(ratios):.3g}-{max(ratios):.3g}x JAX's distance")
    print(message)
    for tested, reference in pairs:
        cs.check_grads(name, tested, reference, cs.TRAIN_TOL, lambda: p64)
    assert port < (0.1 if name == "MXMNet" else 1e-5)
    worst = max(names, key=lambda n: p64[n].abs().max().item())
    with pytest.raises(AssertionError, match=worst):
        cs.check_grads(name, dict(p32, **{worst: p32[worst] * (1 + FAULTS[name])}),
                       pairs[0][1], cs.TRAIN_TOL, lambda: p64)


def test_bessel_forms_phase_runs_on_the_cpu(counted_kernels):
    """The timing of DimeNet++'s and MXMNet's force steps with the radial
    part's one recursion and with the JAX package's recursion per order, on
    4 frames: the same first losses, a time and peak for each turn."""
    out = counted_kernels.phase_bessel_forms("cpu", device="cpu", n_mols=4, reps=1)
    for name in ("DimeNetPP", "MXMNet"):
        assert [len(out[name][f]) for f in ("diagonal", "per_order")] == [2, 2]
        assert all(r["ms"] > 0 and r["peak_mb"] is None
                   for rs in out[name].values() for r in rs)


# --------------------------------------------------------- chip_smoke phase 25


@pytest.mark.parametrize("model,per_step", [("Schnet", 19), ("PAiNN", 25)])
def test_chip_smoke_phase_25_hyper_driver_runs_on_the_cpu(model, per_step, counted_kernels):
    """Phase 25's ``train_force --hyper hyper_synthetic_md.py`` run: the
    config's model on its 256 frames, 3 epochs of one fold; the first step
    against the CPU, its segment-sum calls (kernel #1, grad-of-grad) against
    the plain version, every step's launches."""
    cs = counted_kernels
    paths, recs = cs.phase_zoo_driver("train_force_hyper", model, "cpu", device="cpu")
    assert len(recs["sorted_segment_sum"]) == per_step
    steps = 3 * ((256 - 256 // 5) // 16)  # 3 epochs of the fold's full batches
    assert paths[f"train_force_hyper_{model}"]["sorted_segment_sum"] >= steps * per_step
