"""The port's energy+force training step against the JAX package, on the CPU.

``gcnn_keras_tpu_torch.training`` (losses, ``Trainer``) and
``EnergyForceModel.apply(create_graph=True)`` are held against the JAX
package's ``training/losses.py``, ``Trainer`` and ``optax.adam``, on the same
batches (``bench.py`` ``_mols``) and weights (``params_from_jax``), with the
JAX bench's losses: E + 100 F for SchNet, HDNNP2nd and PAiNN, 50 q + E + 200
F for HDNNP4th with ESP coupling. The JAX gradients have the params tree's
structure, so ``params_from_jax`` maps them onto the port's parameters too.

Tolerances: the losses within ``rtol 1e-5``; each parameter's gradient
within ``1e-4`` of that tensor's largest entry (both packages compute in
float32 and sum in other orders through two reverse passes; the port's
ACSF closed forms and Gauss-Jordan Qeq solve against JAX autodiff and
Cholesky); Adam against optax on the same gradients within ``1e-6``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp2nd as jhdnnp2nd
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th
from gcnn_keras_tpu.models import painn as jpainn
from gcnn_keras_tpu.models.schnet import make_model as jschnet
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu.training.trainer import Trainer as JTrainer
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp2nd, hdnnp4th, painn, schnet
from gcnn_keras_tpu_torch.training import Trainer, losses
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM = functools.partial(torch.optim.Adam, lr=1e-3)

_MLP = {"units": [16, 16, 1], "num_relations": 10, "activation": ["swish", "swish", "linear"]}
_ACSF = {k: chip_smoke.HDNNP2ND_KW[k] for k in ("g2_kwargs", "g4_kwargs")}
# depth 2 and narrow widths; the HDNNP models keep the bench's ACSF tables
MODELS = {
    "schnet": dict(kw=dict(depth=2, interaction_args={"units": 32},
                           gauss_args={"bins": 8, "distance_max": 4.0},
                           input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
                           last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]}),
                   jax=jschnet, port=schnet.make_model, with_esp=False,
                   global_keys=("energy",), weights=(0.0, 1.0, 100.0), esp=False),
    "hdnnp2nd": dict(kw=dict(_ACSF, mlp_kwargs=_MLP),
                     jax=jhdnnp2nd.make_model_behler, port=hdnnp2nd.make_model_behler,
                     with_esp=True, global_keys=("energy",), weights=(0.0, 1.0, 100.0),
                     esp=False),
    "hdnnp4th": dict(kw=dict(_ACSF, mlp_charge_kwargs=_MLP, mlp_local_kwargs=_MLP,
                             electrostatic_kwargs={"param_trainable": False}),
                     jax=jhdnnp4th.make_model_behler, port=hdnnp4th.make_model_behler,
                     with_esp=True, global_keys=("energy", "total_charge"),
                     weights=(50.0, 1.0, 200.0), esp=True),
    "painn": dict(kw=dict(depth=2, conv_args={"units": 32, "cutoff": 5.0},
                          update_args={"units": 32}, input_embedding={"node": {"output_dim": 32}},
                          bessel_basis={"num_radial": 8, "cutoff": 5.0},
                          output_mlp={"units": [32, 1], "activation": ["swish", "linear"]}),
                  jax=jpainn.make_model, port=painn.make_model, with_esp=False,
                  global_keys=("energy",), weights=(0.0, 1.0, 100.0), esp=False),
}


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_loss(jm, weights):
    """The JAX bench's loss (bench.py:201-206, :478-484, :567-572)."""
    wq, _, wf = weights

    def loss_fn(params, b):
        out = jm.apply(params, b, train=False)
        e = jlosses.masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
        f = jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
        if wq:
            q = jlosses.masked_node_mae(out["charge"], b.nodes["charge"], b.node_mask)
            return wq * q + e + wf * f, {}
        return e + wf * f, {}
    return loss_fn


def _setup(name, seed, n_mols):
    """The JAX model, its params, its loss, the JAX and port batches, and
    the port's model holding the same weights with its loss."""
    cfg = MODELS[name]
    graphs = _mols(np.random.RandomState(seed), n_mols, with_esp=cfg["with_esp"])
    jb = jbatch_graphs(graphs, global_keys=cfg["global_keys"])
    tb = batch_graphs(graphs, global_keys=cfg["global_keys"], device="cpu")
    jm = JEnergyForceModel(cfg["jax"](**cfg["kw"]), use_esp_coupling=cfg["esp"])
    params = _tree(jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(3), jb))
    tmodel = params_from_jax(cfg["port"](device="cpu", **cfg["kw"]), params)
    fm = EnergyForceModel(tmodel, use_esp_coupling=cfg["esp"], device="cpu")
    wq, _, wf = cfg["weights"]
    return (jm, params, _jax_loss(jm, cfg["weights"]), jb, tb, fm,
            chip_smoke.ef_loss_fn(fm, wf, wq))


def _grads_close(name, model, grads, ref_tree):
    """Each port gradient against the JAX gradient mapped onto a fresh
    model by ``params_from_jax``."""
    cfg = MODELS[name]
    ref_model = params_from_jax(cfg["port"](device="cpu", **cfg["kw"]), ref_tree)
    ref = dict(ref_model.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(grads) == len(ref) > 0
    for n, g in zip(names, grads):
        r = ref[n].detach().numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= GRAD_TOL * np.abs(r).max(), (n, err, np.abs(r).max())


# ------------------------------------------------------------ losses


@pytest.mark.parametrize("fn", ["masked_graph_mae", "masked_graph_mse", "masked_node_mae",
                                "masked_node_mse", "force_loss", "force_loss_mse",
                                "masked_categorical_crossentropy", "masked_accuracy"])
def test_losses_match_jax(fn):
    rs = np.random.RandomState(0)
    mask = rs.rand(9) > 0.3
    if fn.startswith(("masked_categorical", "masked_accuracy")):
        args = [rs.randn(9, 5).astype(np.float32), rs.randint(0, 5, size=9), mask]
        one_hot = [args[0], np.eye(5, dtype=np.float32)[args[1]], mask]
        cases = [args, one_hot]
    else:
        cases = [[rs.randn(9, 3).astype(np.float32), rs.randn(9, 3).astype(np.float32), mask],
                 [rs.randn(9).astype(np.float32), rs.randn(9).astype(np.float32), mask]]
    name, extra = (("force_loss", {"kind": "mse"}) if fn == "force_loss_mse" else (fn, {}))
    for args in cases:
        out = getattr(losses, name)(*map(torch.from_numpy, args), **extra)
        ref = getattr(jlosses, name)(*map(jnp.asarray, args), **extra)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    empty = np.zeros_like(mask)  # no valid row: the mean is 0, not nan
    out = getattr(losses, name)(*map(torch.from_numpy, cases[0][:2] + [empty]), **extra)
    assert out.item() == 0.0


def test_adam_matches_optax():
    """``torch.optim.Adam(lr=1e-3)`` against ``optax.adam(1e-3)`` over three
    steps on the same gradients."""
    rs = np.random.RandomState(1)
    init = {"a": rs.randn(4, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * 10.0 ** rs.uniform(-6, 1)).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]
    opt = optax.adam(1e-3)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    topt = ADAM(list(tparams.values()))
    for g in grads:
        up, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, up)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in init:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ force training


def test_create_graph_keeps_the_forces_differentiable():
    _, _, _, _, tb, fm, _ = _setup("hdnnp4th", 10, 2)
    served, trained = fm.apply(tb), fm.apply(tb, create_graph=True)
    assert served["force"].grad_fn is None and trained["force"].grad_fn is not None
    # the backward formulas that record a graph sum in other orders
    for key in ("energy", "force", "charge"):
        torch.testing.assert_close(trained[key].detach(), served[key], rtol=1e-5, atol=1e-6)
    (g,) = torch.autograd.grad(trained["force"].square().sum(),
                               fm.energy_model.mlp_charge.rel_dense_0.kernel)
    assert g.abs().max() > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_force_loss_parameter_gradients_match_jax(name):
    """The loss and ``jax.value_and_grad`` of the JAX bench loss, on shared
    weights; through the ACSF Functions' closed forms (G4/G2 jvp as the
    backward of the vjp) and, for HDNNP4th, the Qeq solve to second order."""
    jm, params, jloss, jb, tb, fm, loss_fn = _setup(name, 11, 3)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, jb)
    loss, _ = loss_fn(tb)
    grads = torch.autograd.grad(loss, list(fm.energy_model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    _grads_close(name, fm.energy_model, grads, _tree(ref_grads))


def test_two_trainer_steps_match_jax_trainer():
    """Two ``Trainer`` steps against the JAX ``Trainer`` on the HDNNP2nd
    bench loss: each step's loss, and the parameters after. The optimizer
    is SGD: Adam scales each entry's step to about its learning rate
    whatever the gradient's size, so a gradient entry that cancels to
    float32 noise in one package and to exactly 0 in the other (a relation's
    bias whose energy-MAE signs cancel) moves by 1e-3 in one and not in the
    other. Adam itself is held on equal gradients in ``test_adam_matches_optax``."""
    jm, params, jloss, jb, tb, fm, loss_fn = _setup("hdnnp2nd", 12, 3)
    jtr = JTrainer(jloss, optax.sgd(1e-3))
    jstate = jtr.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    tr = Trainer(loss_fn, functools.partial(torch.optim.SGD, lr=1e-3))
    state = tr.init_state(fm.energy_model.parameters())
    for _ in range(2):
        jstate, jm_metrics = jtr.step_fn()(jstate, jb)
        state, metrics = tr.step_fn()(state, tb)
        np.testing.assert_allclose(metrics["loss"].item(), float(jm_metrics["loss"]),
                                   rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == 2
    ref = dict(params_from_jax(MODELS["hdnnp2nd"]["port"](device="cpu", **MODELS["hdnnp2nd"]["kw"]),
                               _tree(jstate.params)).named_parameters())
    for n, p in fm.energy_model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_fit_epoch_steps_per_dispatch_equals_sequential_steps():
    graphs = [_mols(np.random.RandomState(20 + i), 2) for i in range(3)]
    results = []
    for spd in (1, 3):
        fm = EnergyForceModel(schnet.make_model(device="cpu", **MODELS["schnet"]["kw"]),
                              device="cpu")
        tr = Trainer(chip_smoke.ef_loss_fn(fm, 100.0), ADAM)
        batches = [batch_graphs(g, global_keys=("energy",), device="cpu") for g in graphs]
        state, metrics = tr.fit_epoch(tr.init_state(fm.energy_model.parameters()), batches,
                                      steps_per_dispatch=spd)
        results.append((state.step, metrics["loss"],
                        [p.detach().clone() for p in fm.energy_model.parameters()]))
    (s1, l1, p1), (s3, l3, p3) = results
    assert s1 == s3 == 3 and l1 == l3
    assert all(torch.equal(a, b) for a, b in zip(p1, p3))


def test_trainer_with_a_mesh_raises():
    """A mesh of this process alone takes the step without a mesh (the
    data-parallel step on 2 and more ranks: ``tests/test_torch_parallel.py``);
    a mesh of more ranks than the process group has raises, naming both
    counts, as does ``steps_per_dispatch`` 0."""
    from gcnn_keras_tpu_torch.parallel.mesh import make_mesh
    graphs = _mols(np.random.RandomState(21), 2)
    results = []
    for mesh in (None, make_mesh(1, device="cpu")):
        fm = EnergyForceModel(schnet.make_model(device="cpu", **MODELS["schnet"]["kw"]),
                              device="cpu")
        tr = Trainer(chip_smoke.ef_loss_fn(fm, 100.0), ADAM, mesh=mesh)
        state = tr.init_state(fm.energy_model.parameters())
        state, metrics = tr.step(state, batch_graphs(graphs, global_keys=("energy",),
                                                     device="cpu"))
        results.append((metrics["loss"], [p.detach().clone() for p in state.params]))
    (l0, p0), (l1, p1) = results
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
    with pytest.raises(ValueError, match=r"make_mesh\(n_devices=2\).*1 rank"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        Trainer(lambda b: (torch.zeros(()), {}), ADAM).fit_epoch(None, [], 0)


# ------------------------------------------------------------ chip_smoke.py


@pytest.mark.parametrize("with_esp", [False, True])
def test_labelled_mols_are_bench_mols(with_esp):
    ours = chip_smoke.labelled_mols(4, 5, with_esp=with_esp)
    ref = _mols(np.random.RandomState(4), 5, with_esp=with_esp)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    request = chip_smoke.qm9_like_mols(4, 5)
    assert [list(g) for g in request] == [
        [k for k in g if k not in ("energy", "force")] for g in chip_smoke.labelled_mols(4, 5)]


@pytest.mark.parametrize("path", list(chip_smoke.TRAIN_PATHS))
def test_kernel_calls_per_training_step_are_the_derived_counts(path):
    """One Trainer step of each full-width training path of ``chip_smoke.py``
    on a 3-molecule batch (GCN: a 100-node citation graph; the
    molecule-scale paths: one molecule of their size, at most 260 atoms, so
    past the SPD kernels' gate where theirs is) calls each
    kernel's wrapper as often as
    ``TRAIN_PATHS`` says that the card launches it per step; the calls are
    recorded by ``chip_smoke.captured_calls``, which phase 10 uses to hold
    every call of a step against its plain version, and which puts the
    wrappers back afterwards."""
    table = chip_smoke.kernel_wrappers()
    wrappers = {name: getattr(mod, attr) for name, (mod, attr, _) in table.items()}
    _, trainer, state = chip_smoke.make_trainer(path, "cpu")
    # 3 molecules, a citation graph of 100 nodes, or one molecule
    cfg = chip_smoke.TRAIN_PATHS[path]
    size = {"gcn": 100, "hdnnp4th_mol": min(cfg["size"], 260)}.get(cfg["model"], 3)
    with chip_smoke.captured_calls() as calls:
        trainer.step_fn()(state, chip_smoke.train_batch(path, 3, size, "cpu"))
    assert {name: getattr(mod, attr) for name, (mod, attr, _) in table.items()} == wrappers
    expected = chip_smoke.TRAIN_PATHS[path]["launches"]
    assert {k: len(v) for k, v in calls.items() if v} == {k: v for k, v in expected.items() if v}
    for name, arg_list in calls.items():
        # the segment-sum's bfloat16 calls are its wrapper's too
        mod, attr, plain = table[name.replace("_bf16", "")]
        for args in arg_list:  # the copies reproduce the call: the plain version on the CPU
            torch.testing.assert_close(getattr(mod, attr)(*args), plain(*args), rtol=0, atol=0)
