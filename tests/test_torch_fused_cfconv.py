"""The port's fused cfconv (``ops/cuda/fused_cfconv.py``) and SchNet's
``accurate_cfconv`` mode against the JAX package, on the CPU.

The Pallas kernel ``_fused_cfconv_impl`` has no interpret switch, so its
oracle here is ``_reference_impl``, which is what the JAX package computes
off the TPU (``fused_cfconv_auto``); the port's plain version is what a CPU
tensor runs inside ``FusedCfconv``. Tolerances: values and first
derivatives within 1e-5 of the reference's largest entry (float32 sums in
other orders); the model-flag parity at the JAX test's ``rtol`` (energies
1e-5, forces 1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph.preprocess import set_range as jset_range
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu.ops.pallas.fused_cfconv import _reference_impl, fused_cfconv_auto as jauto
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL = 1e-5


def _close(out, ref, rtol=RTOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _setup(E=256, N=64, B=8, U=16, seed=0):
    """``tests/test_fused_cfconv.py``'s inputs: basis, xj, sorted receivers,
    N, W1, b1, W2, b2 (numpy)."""
    rs = np.random.RandomState(seed)
    recv = np.sort(rs.randint(0, N, size=E)).astype(np.int32)
    return (rs.randn(E, B).astype(np.float32), rs.randn(E, U).astype(np.float32), recv, N,
            (rs.randn(B, U) * 0.1).astype(np.float32), (rs.randn(U) * 0.1).astype(np.float32),
            (rs.randn(U, U) * 0.1).astype(np.float32), (rs.randn(U) * 0.1).astype(np.float32))


def _torch_args(args):
    return [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args]


def test_plain_matches_reference_impl_and_numpy():
    args = _setup()
    basis, xj, recv, N, w1, b1, w2, b2 = args
    ref = np.asarray(_reference_impl(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                       for a in args]))
    h = np.logaddexp(0, basis.astype(np.float64) @ w1 + b1) - np.log(2)
    expect = np.zeros((N, xj.shape[1]))
    np.add.at(expect, recv, xj * (h @ w2 + b2))
    before = fc.launches
    for out in (fc.fused_cfconv_plain(*_torch_args(args)),
                fc.fused_cfconv_kernel(*_torch_args(args))):
        _close(out, ref)
        _close(out, expect)
    assert fc.launches == before  # a CPU tensor launches nothing


@pytest.mark.parametrize("e,n,b,u", [(0, 5, 8, 16), (1, 4, 3, 3), (30, 9, 20, 200),
                                     (40, 12, 20, 3)])
def test_plain_edge_cases(e, n, b, u):
    """No edges, one edge, U 3 and 200, rows without edges (every other
    row), padding edges on the last row."""
    rs = np.random.RandomState(e + u)
    recv = np.sort(rs.choice(np.arange(0, n - 1, 2), size=e)).astype(np.int32)
    if e >= 3:
        recv[-3:] = n - 1
    args = (rs.randn(e, b).astype(np.float32), rs.randn(e, u).astype(np.float32), recv, n,
            rs.randn(b, u).astype(np.float32), rs.randn(u).astype(np.float32),
            (rs.randn(u, u) * 0.1).astype(np.float32), rs.randn(u).astype(np.float32))
    ref = np.asarray(_reference_impl(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                       for a in args]))
    _close(fc.fused_cfconv_kernel(*_torch_args(args)), ref)


def test_first_order_gradients_match_jax():
    args = _setup()
    basis, xj, recv, N, w1, b1, w2, b2 = args

    def jloss(basis, xj, w1, b1, w2, b2):
        return jnp.sum(jnp.tanh(jauto(basis, xj, jnp.asarray(recv), N, w1, b1, w2, b2)) ** 2)

    refs = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, (basis, xj, w1, b1, w2, b2)))
    tb, tx, tr, _, tw1, tb1, tw2, tb2 = _torch_args(args)
    leaves = [t.requires_grad_(True) for t in (tb, tx, tw1, tb1, tw2, tb2)]
    out = fc.fused_cfconv_auto(tb, tx, tr, N, tw1, tb1, tw2, tb2)
    grads = torch.autograd.grad((torch.tanh(out) ** 2).sum(), leaves)
    for g, ref in zip(grads, refs):
        _close(g, ref)


def test_second_derivative_raises():
    """The kernel path is first-order only, as in the JAX package: a
    derivative through the backward raises instead of returning a silent
    result, whether it is asked along an input of the Function or along a
    weight upstream (a force loss's parameter gradient)."""
    tb, tx, tr, N, tw1, tb1, tw2, tb2 = _torch_args(_setup())
    tb.requires_grad_(True)
    v = torch.randn(N, tx.shape[1], requires_grad=True)
    out = fc.FusedCfconv.apply(tb, tx, tr, tw1, tb1, tw2, tb2, N)
    (g,) = torch.autograd.grad((out * v).sum(), tb, create_graph=True)
    for wrt in (tb, v):
        with pytest.raises(RuntimeError, match="first-order only"):
            torch.autograd.grad((g ** 2).sum(), wrt, retain_graph=True)


def test_force_loss_through_the_accurate_model_raises():
    """A force loss's parameter gradients through ``accurate_cfconv``: the
    error, not zeros."""
    graphs = _tiny_mols()
    fm = EnergyForceModel(make_model(device="cpu", **dict(
        SMALL, interaction_args={"units": 16, "accurate_cfconv": True})), device="cpu")
    out = fm.apply(batch_graphs(graphs, global_keys=("energy",), device="cpu"),
                   create_graph=True)
    with pytest.raises(RuntimeError, match="first-order only"):
        torch.autograd.grad((out["force"] ** 2).sum(), list(fm.energy_model.parameters()))


def test_wrapper_checks_and_shared_memory_gate():
    tb, tx, tr, N, tw1, tb1, tw2, tb2 = _torch_args(_setup())
    with pytest.raises(ValueError):
        fc.fused_cfconv_kernel(tb, tx, tr, N, tw2, tb1, tw2, tb2)
    with pytest.raises(TypeError):
        fc.fused_cfconv_kernel(tb, tx, tr.long(), N, tw1, tb1, tw2, tb2)
    # the tiled kernel (U up to 128): W2 and W1 padded to 128 units, 32 hidden
    # and 32 message rows, 32 basis rows, 32 receivers and the edge range;
    # two blocks a SM
    assert fc.TILED_UNITS == 128
    assert fc.shared_memory_bytes(20, 128) == 4 * (128 * 128 + 20 * 128 + 2 * 32 * 128
                                                   + 32 * 20) + 4 * (32 + 2) == 111240
    assert 2 * fc.shared_memory_bytes(20, 128) <= fc.SHARED_MEMORY_BYTES
    # the wide kernel above: 16 hidden rows of U (rounded up to 4), W2, W1,
    # the biases, 16 basis rows, 16 receivers, 2
    assert fc.shared_memory_bytes(20, 200) == 4 * (16 * 200 + 200 * 200 + 20 * 200
                                                   + 2 * 200 + 16 * 20 + 16 + 2)
    assert fc.fits_shared_memory(20, 128) and fc.fits_shared_memory(20, 200)
    assert fc.fits_shared_memory(20, 222) and not fc.fits_shared_memory(20, 223)
    assert not fc.fits_shared_memory(20, 256)


# ------------------------------------------------------------ the model flag

SMALL = dict(depth=2, gauss_args={"bins": 8},
             last_mlp={"units": [8], "activation": ["shifted_softplus"]},
             output_mlp={"units": [1], "activation": ["linear"]})


def _tiny_mols(seed=0, n_mols=3):
    """``tests/test_fused_cfconv.py``'s ``_tiny_mol_batch`` graphs."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_mols):
        n = rs.randint(4, 8)
        g = {"node_number": rs.choice([1, 6, 8], size=n),
             "node_coordinates": (rs.randn(n, 3) * 1.5).astype(np.float32),
             "energy": np.array([rs.randn()], dtype=np.float32)}
        g = jset_range(g, max_distance=5.0, max_neighbours=8)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(g)
    return graphs


def test_accurate_cfconv_model_flag_parity_and_forces():
    """The port's accurate mode on the base model's weights (one parameter
    tree) against the base model, and against the JAX accurate model on the
    same weights."""
    graphs = _tiny_mols()
    kw = dict(SMALL, interaction_args={"units": 16})
    akw = dict(SMALL, interaction_args={"units": 16, "accurate_cfconv": True})
    jb = jbatch_graphs(graphs, global_keys=("energy",))
    jacc = JEnergyForceModel(jmake_model(**akw))
    params = jax.jit(lambda k, b: jacc.init(k, b, train=False))(jax.random.PRNGKey(0), jb)
    tree = jax.tree_util.tree_map(np.asarray, params)
    base = EnergyForceModel(params_from_jax(make_model(device="cpu", **kw), tree), device="cpu")
    acc = EnergyForceModel(params_from_jax(make_model(device="cpu", **akw), tree), device="cpu")
    assert [n for n, _ in base.energy_model.named_parameters()] == \
        [n for n, _ in acc.energy_model.named_parameters()]
    tb = batch_graphs(graphs, global_keys=("energy",), device="cpu")
    out_b, out_a = base.apply(tb), acc.apply(tb)
    np.testing.assert_allclose(out_a["energy"].detach().numpy(), out_b["energy"].detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_a["force"].numpy(), out_b["force"].numpy(),
                               rtol=1e-4, atol=1e-5)
    ref = jacc.apply(params, jb, train=False)
    _close(out_a["energy"], ref["energy"])
    _close(out_a["force"], ref["force"])


def test_accurate_cfconv_rejects_nonreference_config():
    with pytest.raises(ValueError, match="accurate_cfconv"):
        make_model(device="cpu", depth=1, gauss_args={"bins": 8},
                   interaction_args={"units": 8, "accurate_cfconv": True,
                                     "cfconv_pool": "mean"})
    with pytest.raises(ValueError, match="accurate_cfconv"):
        make_model(device="cpu", depth=1,
                   interaction_args={"units": 8, "accurate_cfconv": True, "use_bias": False})
