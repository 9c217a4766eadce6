"""SchNet's MD execution modes in the port (``fused_aggregate=True``, the
custom-VJP route ``fused_aggregate="vjp"``, ``accurate_cfconv=True``)
against the JAX models with the same flags, on shared weights, on the CPU.

On a CPU tensor the kernel wrappers run their plain versions inside the
same autograd Functions the card runs, so the wiring (the GMS and
FusedGatherMulSegsum backwards, the fused cfconv's first-order VJP, which
cotangents each pass asks for) is what these tests hold. Energies and
forces within ``rtol 1e-5, atol 1e-5 * max|reference|``; force-loss
parameter gradients within 1e-4 of each tensor's largest entry, as in
``tests/test_torch_training.py``. The kernel calls per evaluation and per
training step are counted by wrapping each kernel's wrapper
(``chip_smoke.captured_calls``) and held to ``chip_smoke.schnet_launches``,
which ``chip_smoke.py`` holds the card's launches to.
"""
import functools

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.training import Trainer
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SMALL = dict(depth=2, gauss_args={"bins": 8, "distance_max": 4.0},
             input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
             last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})
MODES = {"fused": {"fused_aggregate": True}, "vjp": {"fused_aggregate": "vjp"},
         "accurate": {"accurate_cfconv": True}}
GRAD_TOL = 1e-4


def _kw(mode):
    return dict(SMALL, interaction_args={"units": 32, **MODES[mode]})


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _shared(mode, graphs, global_keys=()):
    """The JAX EnergyForceModel in ``mode`` with init params, and the port's
    in the same mode holding the same weights; both batches."""
    jb = jbatch_graphs(graphs, global_keys=global_keys)
    jm = JEnergyForceModel(jmake_model(**_kw(mode)))
    params = _tree(jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(1), jb))
    tm = EnergyForceModel(params_from_jax(make_model(device="cpu", **_kw(mode)), params),
                          device="cpu")
    return jm, params, jb, tm, batch_graphs(graphs, global_keys=global_keys, device="cpu")


def _close(out, ref, rtol=1e-5):
    out = out.detach().numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_energy_force_matches_jax(mode):
    graphs = [{k: v for k, v in g.items() if k not in ("energy", "force")}
              for g in _mols(np.random.RandomState(0), 6)]
    jm, params, jb, tm, tb = _shared(mode, graphs)
    ref = jm.apply(params, jb, train=False)
    out = tm.apply(tb)
    _close(out["energy"], ref["energy"])
    _close(out["force"], ref["force"])


@pytest.mark.parametrize("mode", ["fused", "vjp"])
def test_fused_force_loss_parameter_gradients_match_jax(mode):
    """The bench's SchNet loss, E + 100 F, differentiated along the
    parameters through the forces (grad-of-grad) in the fused modes, against
    ``jax.value_and_grad`` of the JAX model in the same mode."""
    graphs = _mols(np.random.RandomState(11), 3)
    jm, params, jb, tm, tb = _shared(mode, graphs, global_keys=("energy",))

    def jloss(params, b):
        out = jm.apply(params, b, train=False)
        return (jlosses.masked_graph_mae(out["energy"], b.globals["energy"],
                                         b.globals["graph_mask"])
                + 100.0 * jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params, jb)
    loss, _ = chip_smoke.ef_loss_fn(tm, 100.0)(tb)
    grads = torch.autograd.grad(loss, list(tm.energy_model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = dict(params_from_jax(make_model(device="cpu", **_kw(mode)),
                               _tree(ref_grads)).named_parameters())
    names = [n for n, _ in tm.energy_model.named_parameters()]
    assert len(names) == len(grads) == len(ref) > 0
    for n, g in zip(names, grads):
        r = ref[n].detach().numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= GRAD_TOL * np.abs(r).max(), (n, err, np.abs(r).max())


@pytest.mark.parametrize("mode", ["unfused", "fused", "accurate"])
def test_kernel_calls_per_evaluation_are_the_derived_counts(mode):
    """One energy+force evaluation of the full-width model of
    ``chip_smoke.py`` in ``mode`` calls each kernel's wrapper as often as
    ``chip_smoke.schnet_launches`` says the card launches it; each recorded
    call reproduces its plain version."""
    fm = chip_smoke.energy_force_model("schnet", "cpu", mode)
    b = batch_graphs(chip_smoke.qm9_like_mols(3, 3), device="cpu")
    with chip_smoke.captured_calls() as calls:
        fm.apply(b)
    assert {k: len(v) for k, v in calls.items() if v} == {
        k: v for k, v in chip_smoke.schnet_launches(mode).items() if v}
    table = chip_smoke.kernel_wrappers()
    for name, arg_list in calls.items():
        mod, attr, plain = table[name]
        for args in arg_list:
            torch.testing.assert_close(getattr(mod, attr)(*args), plain(*args), rtol=0, atol=0)


def test_kernel_calls_per_fused_training_step():
    """A training step (E + 100 F, Adam) of the full-width fused model:
    the gms kernel on the 4 forward applications only, and 19 segment-sums
    (PERF.md derives them); the accurate mode refuses the force loss."""
    counts = {}
    for mode in ("fused", "accurate"):
        fm = chip_smoke.energy_force_model("schnet", "cpu", mode)
        trainer = Trainer(chip_smoke.ef_loss_fn(fm, 100.0),
                          functools.partial(torch.optim.Adam, lr=1e-3))
        state = trainer.init_state(fm.energy_model.parameters())
        batch = chip_smoke.train_batch("schnet_train", 3, 3, "cpu")
        if mode == "accurate":
            with pytest.raises(RuntimeError, match="first-order only"):
                trainer.step_fn()(state, batch)
            continue
        with chip_smoke.captured_calls() as calls:
            trainer.step_fn()(state, batch)
        counts = {k: len(v) for k, v in calls.items() if v}
    assert counts == {"gather_mul_segsum": 4, "sorted_segment_sum": 19}


def test_modes_share_one_parameter_tree():
    """Every mode builds the same parameters from the same seed, so one
    checkpoint (or ``params_from_jax`` tree) serves all three."""
    models = [chip_smoke.schnet_model(mode, "cpu", depth=2) for mode in chip_smoke.SCHNET_MODES]
    for (n0, p0), *rest in zip(*(m.named_parameters() for m in models)):
        for n, p in rest:
            assert n == n0 and torch.equal(p, p0)


def test_fused_chain_still_raises():
    with pytest.raises(NotImplementedError, match="slice 6"):
        make_model(device="cpu", **dict(SMALL, interaction_args={"fused_chain": True}))


def test_chip_smoke_md_phases_run_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phases 13 and 14 at a few steps on the CPU, each
    kernel wrapper call counted as the card counts its launches: the
    derived launches per step hold, the modes agree and the NVE drift stays
    under its bounds."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name, value in (("MD_STEPS", (2, 4)), ("MD_PAIRS", 1), ("ENSEMBLE_REPLICAS", 3),
                        ("ENSEMBLE_SEGMENT_STEPS", 2), ("NVE_STEPS", 20)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=name):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)
    assert chip_smoke.phase_gms_second_order("cpu")["launches"]["gather_mul_segsum"] == 4
    launches, calls = chip_smoke.phase_md_single("cpu", "cpu")
    # each trajectory evaluates its start and every step: both lengths once, then in pairs
    evals = (sum(chip_smoke.MD_STEPS) + 2) * (1 + chip_smoke.MD_PAIRS)
    assert launches == {k: evals * sum(chip_smoke.schnet_launches(m)[k]
                                       for m in chip_smoke.SCHNET_MODES)
                        for k in chip_smoke.KERNEL_NAMES}
    assert {m: {k: len(v) for k, v in c.items()} for m, c in calls.items()} == {
        m: {k: v for k, v in chip_smoke.schnet_launches(m).items() if v}
        for m in chip_smoke.SCHNET_MODES}
    evals = chip_smoke.ENSEMBLE_SEGMENTS * (chip_smoke.ENSEMBLE_SEGMENT_STEPS + 1)
    assert chip_smoke.phase_md_ensemble("cpu", "cpu")["fused_cfconv"] == 4 * evals
    assert chip_smoke.phase_nve("cpu", "cpu")["gather_mul_segsum"] == 2 * (chip_smoke.NVE_STEPS + 1)
