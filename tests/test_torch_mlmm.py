"""The port's ``MLMMEnergyForceModel`` against the JAX package's, on shared
weights, on the CPU.

The wrapper adds the QM/MM point-charge energy ``sum_i q_i Phi_i`` and
force ``-q_i dPhi_i/dr_i`` to an HDNNP4th ``EnergyForceModel``'s outputs.
Both packages compute in float32; energies, forces, charges and the
correction agree to ``tests/test_torch_hdnnp4th.py``'s ``rtol 1e-5, atol
1e-6``, and a force loss's parameter gradients through the wrapper to
``tests/test_torch_training.py``'s 1e-4 of each tensor's largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph.preprocess import set_angle as jset_angle
from gcnn_keras_tpu.graph.preprocess import set_range as jset_range
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.model.mlmm import MLMMEnergyForceModel as JMLMM
from gcnn_keras_tpu.models.hdnnp4th import make_model_behler as jmake_model_behler
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.model.mlmm import MLMMEnergyForceModel
from gcnn_keras_tpu_torch.models import schnet
from gcnn_keras_tpu_torch.models.hdnnp4th import make_model_behler
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
GLOBALS = ("total_charge",)
KEYS = ("energy", "force", "charge", "qmmm_energy_correction")
# tests/test_moldyn.py::test_mlmm_wrapper_adds_qmmm_terms's model
KW = dict(mlp_charge_kwargs={"units": [8, 1], "num_relations": 17,
                             "activation": ["swish", "linear"]},
          mlp_local_kwargs={"units": [8, 1], "num_relations": 17,
                            "activation": ["swish", "linear"]})


def _moldyn_graphs():
    """tests/test_moldyn.py:91-122's system: 4 atoms of H, C and S with an
    ESP and its gradient, total charge 0."""
    rs = np.random.RandomState(0)
    n = 4
    g = {"node_number": rs.choice([1, 6, 16], size=n),
         "node_coordinates": (rs.randn(n, 3) * 1.2).astype(np.float32),
         "total_charge": np.array([0.0], dtype=np.float32),
         "esp": (rs.randn(n) * 0.1).astype(np.float32),
         "esp_grad": (rs.randn(n, 3) * 0.1).astype(np.float32)}
    g = jset_range(g, max_distance=6.0, max_neighbours=6)
    g["edge_indices"] = g["range_indices"]
    return [jset_angle(g, range_indices="edge_indices")]


def _bench_graphs():
    """Three of bench.py's flagship molecules, total charges -1, 0, +1."""
    graphs = _mols(np.random.RandomState(6), 3, with_esp=True)
    for i, g in enumerate(graphs):
        g["total_charge"] = np.array([float(i - 1)], np.float32)
    return graphs


def _shared(graphs, esp_coupling):
    """The JAX wrapper and params, the port's wrapper holding the same
    weights, and both packages' batches of ``graphs``."""
    jb = jbatch_graphs(graphs, global_keys=GLOBALS)
    jw = JMLMM(JEnergyForceModel(jmake_model_behler(**KW), use_esp_coupling=esp_coupling))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k, b: jw.init(k, b, train=False))(jax.random.PRNGKey(0), jb))
    model = params_from_jax(make_model_behler(device="cpu", **KW), params)
    tw = MLMMEnergyForceModel(EnergyForceModel(model, use_esp_coupling=esp_coupling,
                                               device="cpu"))
    return jw, params, jb, tw, batch_graphs(graphs, global_keys=GLOBALS, device="cpu")


@pytest.mark.parametrize("graphs", [_moldyn_graphs, _bench_graphs], ids=["moldyn", "bench"])
@pytest.mark.parametrize("esp_coupling", [False, True], ids=["inner", "inner-esp-coupled"])
def test_mlmm_matches_jax(graphs, esp_coupling):
    jw, params, jb, tw, tb = _shared(graphs(), esp_coupling)
    ref = jax.jit(lambda p, b: jw.apply(p, b, train=False))(params, jb)
    out = tw.apply(tb)
    inner = tw.inner.apply(tb)
    for key in KEYS:
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # the energy is the inner one shifted by the correction; the forces move
    torch.testing.assert_close(out["energy"], inner["energy"] + out["qmmm_energy_correction"],
                               rtol=0, atol=0)
    assert not torch.allclose(out["energy"], inner["energy"])
    assert not torch.allclose(out["force"], inner["force"])
    q, mask = out["charge"], tb.node_mask
    torch.testing.assert_close(
        out["force"], inner["force"] - q[:, None] * tb.nodes["esp_grad"] * mask[:, None])


def test_mlmm_force_loss_gradients_match_jax():
    """A loss on the wrapper's energies and forces (``create_graph=True``),
    differentiated along the parameters, against ``jax.grad`` of the same
    loss through the JAX wrapper."""
    jw, params, jb, tw, tb = _shared(_bench_graphs(), True)

    def jloss(p):
        out = jw.apply(p, jb, train=False)
        return jnp.sum(out["energy"] * jb.globals["graph_mask"][:, None]) + 10.0 * jnp.sum(
            out["force"] ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    out = tw.apply(tb, create_graph=True)
    loss = torch.sum(out["energy"] * tb.globals["graph_mask"][:, None]) + 10.0 * torch.sum(
        out["force"] ** 2)
    model = tw.inner.energy_model
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    ref = dict(params_from_jax(make_model_behler(device="cpu", **KW), jax.tree_util.tree_map(
        np.asarray, ref_grads)).named_parameters())
    for (name, _), g in zip(model.named_parameters(), grads):
        r = ref[name].detach()
        assert (g - r).abs().max() <= GRAD_TOL * r.abs().max(), name


def test_mlmm_passes_the_inner_output_through():
    """Without an ESP in the batch, or without charges in the inner output,
    the inner dict comes back unchanged; without the ESP gradient only the
    energy moves."""
    graphs = _moldyn_graphs()
    _, _, _, tw, _ = _shared(graphs, False)
    no_esp = [{k: v for k, v in g.items() if k not in ("esp", "esp_grad")} for g in graphs]
    tb = batch_graphs(no_esp, global_keys=GLOBALS, device="cpu")
    out, inner = tw.apply(tb), tw.inner.apply(tb)
    assert "qmmm_energy_correction" not in out and set(out) == set(inner)
    for key in inner:
        torch.testing.assert_close(out[key], inner[key], rtol=0, atol=0)

    no_grad = [{k: v for k, v in g.items() if k != "esp_grad"} for g in graphs]
    tb = batch_graphs(no_grad, global_keys=GLOBALS, device="cpu")
    out, inner = tw.apply(tb), tw.inner.apply(tb)
    torch.testing.assert_close(out["force"], inner["force"], rtol=0, atol=0)
    assert not torch.allclose(out["energy"], inner["energy"])

    fm = EnergyForceModel(schnet.make_model(device="cpu", depth=1), device="cpu")
    tb = batch_graphs(graphs, global_keys=GLOBALS, device="cpu")
    out, inner = MLMMEnergyForceModel(fm)(tb), fm(tb)
    assert "charge" not in out and set(out) == set(inner)
    torch.testing.assert_close(out["energy"], inner["energy"], rtol=0, atol=0)
