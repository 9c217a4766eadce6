"""HDNNP4th at molecule scale: ``chip_smoke.py`` phase 18's molecule, model
and training step against the JAX package's ``bench.py``
``bench_large_mol_step``, on the CPU, and the phase itself at small sizes.

``bench_large_mol_step`` builds one molecule of n atoms (a curved chain),
its batch, the model and its params; the port's ``large_mol_graph(n)`` and
``LARGE_MOL_KW`` must give the same graph and a model that takes those
params whole (``params_from_jax`` raises on a missing or extra leaf). The
graph dicts are built once and fed to both packages' batchers: from 256
atoms the JAX ``set_range`` takes its C++ cell list, whose edge order may
differ from the port's dense path (the same edges). The loss and parameter
gradients of the bench's loss (50 q + E + 200 F) agree to
``tests/test_torch_training.py``'s ``LOSS_RTOL`` 1e-5 and ``GRAD_TOL`` 1e-4,
at 64 atoms (the Qeq solve on the SPD kernel's path, its plain version
here) and at 260 (past the kernel's gate: Cholesky).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import optax

import chip_smoke
from bench import bench_large_mol_step
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp4th
from gcnn_keras_tpu_torch.ops.cuda import spd_solve as kspd
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
GLOBALS = ("energy", "total_charge")
NODE_KEYS = ("node_number", "node_coordinates", "force", "esp", "esp_grad", "charge")


@functools.lru_cache(maxsize=None)
def _bench(n):
    """``bench_large_mol_step(n)``: its step, params (numpy) and batch."""
    step_fn, (params, opt_state, batch), _, _ = bench_large_mol_step(jax, optax, n)
    return step_fn, jax.tree_util.tree_map(np.asarray, params), opt_state, batch


def _port_model(params):
    return EnergyForceModel(params_from_jax(hdnnp4th.make_model_behler(
        device="cpu", **chip_smoke.LARGE_MOL_KW), params), use_esp_coupling=True, device="cpu")


@pytest.mark.parametrize("n", [64, 260])
def test_large_mol_graph_is_the_bench_graph(n):
    """The same atoms, labels and edge set as ``bench_large_mol_step``'s
    batch; its params load whole into ``LARGE_MOL_KW``'s model."""
    g = chip_smoke.large_mol_graph(n)
    _, params, _, jb = _bench(n)
    real = np.asarray(jb.node_mask)
    assert real.sum() == n and jb.max_nodes == n
    for key in NODE_KEYS:
        np.testing.assert_array_equal(g[key], np.asarray(jb.nodes[key])[real], err_msg=key)
    for key in ("energy", "total_charge"):
        np.testing.assert_array_equal(g[key], np.asarray(jb.globals[key])[0], err_msg=key)
    emask = np.asarray(jb.edge_mask)
    pairs = np.stack([np.asarray(jb.receivers), np.asarray(jb.senders)], 1)[emask]
    assert sorted(map(tuple, g["edge_indices"].tolist())) == sorted(map(tuple, pairs.tolist()))
    assert len(g["angle_indices_nodes"]) == int(np.asarray(jb.angle_mask).sum())
    _port_model(params)


def _jax_loss(jm):
    """``bench_large_mol_step``'s loss (``bench.py:758-766``)."""
    def loss_fn(params, b):
        out = jm.apply(params, b, train=False)
        e = jlosses.masked_graph_mae(out["energy"], b.globals["energy"], b.globals["graph_mask"])
        f = jlosses.masked_node_mae(out["force"], b.nodes["force"], b.node_mask)
        q = jlosses.masked_node_mae(out["charge"], b.nodes["charge"], b.node_mask)
        return 50.0 * q + e + 200.0 * f
    return loss_fn


@pytest.mark.parametrize("n", [64, 260])
def test_molecule_scale_step_matches_jax(n):
    """The loss and its parameter gradients on the bench's params, through
    the forces; at 64 atoms also the bench step's own loss."""
    step_fn, params, opt_state, jb_bench = _bench(n)
    g = chip_smoke.large_mol_graph(n)
    jb = jbatch_graphs([g], global_keys=GLOBALS)
    tb = batch_graphs([g], global_keys=GLOBALS, device="cpu")
    assert kspd.fits_shared_memory(tb.max_nodes, 2) == (n <= chip_smoke.SPD_MAX_M)
    jm = JEnergyForceModel(jhdnnp4th.make_model_behler(**chip_smoke.LARGE_MOL_KW),
                           use_esp_coupling=True)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(_jax_loss(jm)))(params, jb)
    if n == 64:  # the same batch: the bench's loss is this loss
        _, _, bench_loss = jax.jit(step_fn)(params, opt_state, jb_bench)
        np.testing.assert_allclose(float(bench_loss), float(ref_loss), rtol=1e-6)
    fm = _port_model(params)
    loss, _ = chip_smoke.ef_loss_fn(fm, 200.0, 50.0)(tb)
    grads = torch.autograd.grad(loss, list(fm.energy_model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    ref = dict(_port_model(jax.tree_util.tree_map(np.asarray, ref_grads))
               .energy_model.named_parameters())
    names = [k for k, _ in fm.energy_model.named_parameters()]
    assert len(names) == len(grads) == len(ref) > 0
    for name, grad in zip(names, grads):
        r = ref[name].detach()
        assert (grad - r).abs().max() <= GRAD_TOL * r.abs().max(), name


def test_chip_smoke_phase_18_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 18 on the CPU at small sizes, each kernel
    wrapper call counted as the card counts its launches: evaluations of
    molecules of 40 atoms (the SPD kernel's path) and 250 (Cholesky),
    the iterative step against the dense one at 200 atoms, and the ML/MM
    evaluation; the derived launches hold."""
    assert chip_smoke.SPD_MAX_M == kspd.max_kernel_m(2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "QEQ_AB_STEPS", {200: 2})
    for name, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=name):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)
    for n in (40, 250):
        launches, recs = chip_smoke.phase_mol_serving(n, "cpu", "cpu")
        assert launches == chip_smoke.mol_launches(n)
        assert {k: len(r) for k, r in recs.items()} == {
            k: v for k, v in launches.items() if v}
    assert chip_smoke.phase_qeq_ab("cpu", "cpu") == {
        "hdnnp4th_mol200_cg_train": dict(chip_smoke.mol_launches(200, train=True), spd_solve=0)}
    request = ("seed 0, 6 mols", chip_smoke.with_esp(chip_smoke.qm9_like_mols(0, 6), 0))
    assert chip_smoke.phase_mlmm(request, "cpu", "cpu") == chip_smoke.MLMM_LAUNCHES
