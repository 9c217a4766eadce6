"""The port's ``GraphBatchNorm``, ``MLP(use_normalization=...)``, the
``batch_stats`` collection of ``params_from_jax`` and HDNNP4th's
``normalize_kwargs`` against the JAX package, on the CPU.

Float32 throughout, sums in other orders: outputs and running statistics
within ``1e-5`` of the largest reference value, HDNNP4th's energies,
charges and forces within ``rtol 1e-5, atol 1e-6``
(``tests/test_torch_hdnnp4th.py``'s), gradients within ``1e-4`` of each
tensor's largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bench import _mols
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.layers import mlp as jmlp
from gcnn_keras_tpu.layers import norm as jnorm
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models import hdnnp4th as jhdnnp4th
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers import mlp, norm
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models import hdnnp4th
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

TOL, GRAD_TOL = 1e-5, 1e-4
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(out, ref, tol=TOL):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _tree(v):
    return jax.tree_util.tree_map(np.array, v)


def _perturb(tree, rs):
    """Every norm layer's scale, bias and running statistics moved off
    their initial values, in place; returns the tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rs)
        elif k == "mean":
            tree[k] = (rs.randn(*v.shape) * 0.5).astype(np.float32)
        elif k in ("var", "scale"):
            tree[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "bias" and v.ndim == 1:
            tree[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
    return tree


def _data(shape, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    mask = rs.rand(shape[0]) > 0.3
    x[~mask] = 1e3  # padding rows: large values that the statistics must skip
    return x, mask


@pytest.mark.parametrize("shape", [(40, 6), (40, 3, 6)])
@pytest.mark.parametrize("train", [False, True])
def test_graph_batch_norm_matches_jax(shape, train):
    """``train=False`` normalizes by the running statistics; ``train=True``
    by the masked batch statistics, updating the running ones as
    ``apply(..., mutable=["batch_stats"])`` does (momentum 0.9 here)."""
    x, mask = _data(shape)
    layer = jnorm.GraphBatchNorm(momentum=0.9, epsilon=1e-3)
    variables = _perturb(_tree(layer.init(jax.random.PRNGKey(0), x, mask,
                                          use_running_average=True)),
                         np.random.RandomState(1))
    port = params_from_jax(norm.GraphBatchNorm(shape[-1], momentum=0.9, epsilon=1e-3),
                           variables)
    out = port(torch.from_numpy(x), torch.from_numpy(mask), train=train)
    if train:
        ref, state = layer.apply(variables, x, mask, use_running_average=False,
                                 mutable=["batch_stats"])
        _close(port.mean, state["batch_stats"]["mean"])
        _close(port.var, state["batch_stats"]["var"])
    else:
        ref = layer.apply(variables, x, mask, use_running_average=True)
        np.testing.assert_array_equal(port.mean.numpy(), variables["batch_stats"]["mean"])
    _close(out[torch.from_numpy(mask)], np.asarray(ref)[mask])


def test_graph_batch_norm_keys_on_train_not_on_module_mode():
    """The trap: ``nn.Module.train()`` (which ``Trainer`` does not call, but
    a user may) changes nothing; only the call's ``train`` does."""
    x, mask = _data((20, 4), seed=2)
    layer = norm.GraphBatchNorm(4)
    with torch.no_grad():
        layer.mean.fill_(0.3)
        layer.var.fill_(2.0)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    layer.train()
    a = layer(xt, mt)
    layer.eval()
    b = layer(xt, mt)
    assert torch.equal(a, b) and layer.mean[0].item() == pytest.approx(0.3)
    with pytest.raises(ValueError, match="mask"):
        layer(xt, train=True)


@pytest.mark.parametrize("technique", ["graph_batch", "graph_layer"])
@pytest.mark.parametrize("train", [False, True])
def test_mlp_with_normalization_matches_jax(technique, train):
    """dense -> norm -> activation per layer, with a normalized layer beside
    a plain one and ``last_linear``; the input gradient too."""
    x, mask = _data((30, 5), seed=3)
    x[~mask] = 0.0
    kw = dict(units=[8, 6, 4], activation=["swish", "relu", "swish"],
              use_normalization=[True, False, True], normalization_technique=technique,
              last_linear=True)
    layer = jmlp.MLP(**kw)
    variables = _perturb(_tree(layer.init(jax.random.PRNGKey(2), x, mask)),
                         np.random.RandomState(4))
    port = params_from_jax(mlp.MLP(5, **kw), variables)
    assert [n for n, _ in port.named_children()] == ["dense_0", "norm_0", "dense_1",
                                                     "dense_2", "norm_2"]
    proj = np.random.RandomState(5).randn(30, 4).astype(np.float32)

    def jfn(xx):
        if train and technique == "graph_batch":
            y, state = layer.apply(variables, xx, mask, train=True, mutable=["batch_stats"])
        else:
            y, state = layer.apply(variables, xx, mask, train=train), None
        return jnp.sum(y * proj), (y, state)
    (_, (ref, state)), ref_grad = jax.value_and_grad(jfn, has_aux=True)(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, torch.from_numpy(mask), train=train)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(proj)).sum(), xt)
    rows = torch.from_numpy(mask)
    _close(out[rows], np.asarray(ref)[mask])
    _close(grad[rows], np.asarray(ref_grad)[mask], GRAD_TOL)
    if state is not None:
        _close(port.norm_2.var, state["batch_stats"]["norm_2"]["var"])


def test_params_from_jax_checks_the_batch_stats_leaves():
    x, mask = _data((10, 3), seed=6)
    variables = _tree(jnorm.GraphBatchNorm().init(jax.random.PRNGKey(0), x, mask,
                                                  use_running_average=True))
    with pytest.raises(KeyError, match="batch_stats leaf 'mean' missing"):
        params_from_jax(norm.GraphBatchNorm(3), {"params": variables["params"]})
    extra = {"params": variables["params"],
             "batch_stats": dict(variables["batch_stats"], other=np.zeros(3, np.float32))}
    with pytest.raises(KeyError, match="no port counterpart"):
        params_from_jax(norm.GraphBatchNorm(3), extra)
    with pytest.raises(ValueError, match="flax shape"):
        params_from_jax(norm.GraphBatchNorm(4), variables)


# --------------------------------------------------- HDNNP4th normalize


ELEMENTS = [1, 6, 7, 8, 9]
_MLP = {"units": [16, 16, 1], "num_relations": 10, "activation": ["swish", "swish", "linear"]}
KW4 = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 3.0], "rc": 4.0, "elements": ELEMENTS},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 4.0,
               "zeta": [1.0, 8.0], "elements": ELEMENTS, "multiplicity": 2.0},
    mlp_charge_kwargs=_MLP, mlp_local_kwargs=_MLP,
    electrostatic_kwargs={"param_trainable": False}, normalize_kwargs={"epsilon": 1e-3})


def _hdnnp4th_graphs(seed, n_mols, rep=False):
    graphs = _mols(np.random.RandomState(seed), n_mols, with_esp=True)
    rs = np.random.RandomState(seed + 1)
    for i, g in enumerate(graphs):
        g["total_charge"] = np.array([float(i % 3 - 1)], np.float32)
        if rep:
            g["rep"] = rs.randn(len(g["node_number"]), 12).astype(np.float32)
    keys = ("energy", "total_charge")
    return (jbatch_graphs(graphs, global_keys=keys),
            batch_graphs(graphs, global_keys=keys, device="cpu"))


def test_hdnnp4th_behler_with_normalize_kwargs_matches_jax():
    """Charges, energies and forces with ESP coupling on perturbed running
    statistics (``train=False``), and the 50 q + E + 200 F loss's parameter
    gradients."""
    jb, tb = _hdnnp4th_graphs(12, 3)
    jm = JEnergyForceModel(jhdnnp4th.make_model_behler(**KW4), use_esp_coupling=True)
    params = _perturb(_tree(jax.jit(jm.init)(jax.random.PRNGKey(3), jb)),
                      np.random.RandomState(7))
    tm = params_from_jax(hdnnp4th.make_model_behler(device="cpu", **KW4), params)
    fm = EnergyForceModel(tm, use_esp_coupling=True, device="cpu")
    ref = jax.jit(jm.apply)(params, jb)
    out = fm.apply(tb)
    for key in ("energy", "charge", "force"):
        np.testing.assert_allclose(_np(out[key]), np.asarray(ref[key]), rtol=RTOL, atol=ATOL)

    def jloss(p):
        o = jm.apply(p, jb)
        m = jb.node_mask[:, None]
        return (50.0 * jnp.sum(jnp.abs(o["charge"] - jb.nodes["charge"]) * jb.node_mask)
                + jnp.sum(jnp.abs(o["energy"][:, 0] - jb.globals["energy"][:, 0])
                          * jb.globals["graph_mask"])
                + 200.0 * jnp.sum(jnp.abs(o["force"] - jb.nodes["force"]) * m))
    ref_grads = jax.jit(jax.grad(jloss))(params)
    o = fm.apply(tb, create_graph=True)
    m = tb.node_mask[:, None]
    loss = (50.0 * ((o["charge"] - tb.nodes["charge"]).abs() * tb.node_mask).sum()
            + ((o["energy"][:, 0] - tb.globals["energy"][:, 0]).abs()
               * tb.globals["graph_mask"]).sum()
            + 200.0 * ((o["force"] - tb.nodes["force"]).abs() * m).sum())
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    ref_params = dict(params_from_jax(hdnnp4th.make_model_behler(device="cpu", **KW4),
                                      {**params, "params": _tree(ref_grads["params"])}
                                      ).named_parameters())
    for (n, _), g in zip(tm.named_parameters(), grads):
        _close(g, ref_params[n], GRAD_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_hdnnp4th_learn_with_normalize_kwargs_matches_jax(train):
    """The learn model on a given ``rep``: ``train=False`` on perturbed
    statistics; ``train=True`` on the batch's, with the running averages
    after."""
    jb, tb = _hdnnp4th_graphs(13, 3, rep=True)
    kw = dict(mlp_charge_kwargs=_MLP, mlp_local_kwargs=_MLP,
              normalize_kwargs={"momentum": 0.9})
    jmodel = jhdnnp4th.make_model_learn(**kw)
    params = _perturb(_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(4), jb)),
                      np.random.RandomState(8))
    tm = params_from_jax(hdnnp4th.make_model_learn(device="cpu", rep_features=12, **kw), params)
    if train:
        ref, state = jmodel.apply(params, jb, train=True, mutable=["batch_stats"])
        _close(tm.norm.var.detach(), params["batch_stats"]["norm"]["var"])
    else:
        ref = jmodel.apply(params, jb)
    out = tm(tb, train=train)
    for key in ("output", "charge"):
        np.testing.assert_allclose(_np(out[key]), np.asarray(ref[key]), rtol=RTOL, atol=ATOL)
    if train:
        for leaf in ("mean", "var"):
            _close(getattr(tm.norm, leaf), state["batch_stats"]["norm"][leaf])
