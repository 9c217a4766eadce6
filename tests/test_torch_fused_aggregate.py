"""The port's fused gather-multiply-segment-sum (``ops/cuda/fused_aggregate.py``,
``ops/cuda/bilinear.py``) against the JAX package, on the CPU.

On a CPU tensor the kernel wrapper runs its plain version, so these tests
hold that version and the autograd Functions around it (the same wiring the
card runs) against:

- the Pallas kernel ``_fused_gather_mul_segsum`` in interpret mode with
  ``exact=True`` (float32 sums), and numpy;
- the JAX custom VJP ``fused_gather_mul_segsum`` (interpret mode) for first
  derivatives;
- ``bilinear_gather_mul_segsum`` (the ``gms`` primitive) for the value,
  first derivatives, the grad-of-grad force-training pattern and third
  order, on the graphs of ``tests/test_bilinear_family.py``.

Tolerance: 1e-5 of the largest entry of the reference, per tensor (the
packages sum in other orders in float32).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.ops.pallas.bilinear import bilinear_gather_mul_segsum as jbilinear
from gcnn_keras_tpu.ops.pallas.fused_aggregate import (
    _fused_gather_mul_segsum, fused_gather_mul_segsum)
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers.aggr import gather_mul_pool_edges
from gcnn_keras_tpu_torch.ops.cuda import bilinear as kb
from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa

torch.set_num_threads(1)

RTOL = 1e-5


def _close(out, ref, rtol=RTOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def window_graph():
    """``tests/test_fused_aggregate.py``'s graphs: receiver-sorted edges of
    40 node-contiguous graphs of up to 24 nodes, F 64."""
    rs = np.random.RandomState(0)
    n_graphs, max_nodes = 40, 24
    sizes = rs.randint(5, max_nodes + 1, n_graphs)
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    n = int(sizes.sum())
    send, recv = [], []
    for s0, sz in zip(starts, sizes):
        for r in range(s0, s0 + sz):
            for j in rs.choice(np.arange(s0, s0 + sz), size=min(6, sz - 1), replace=False):
                if j != r:
                    send.append(j)
                    recv.append(r)
    send, recv = np.array(send), np.array(recv)
    o = np.argsort(recv, kind="stable")
    send, recv = send[o].astype(np.int32), recv[o].astype(np.int32)
    x = rs.randn(n, 64).astype(np.float32)
    filt = rs.randn(len(send), 64).astype(np.float32)
    perm = np.argsort(send, kind="stable").astype(np.int32)
    return n, max_nodes, x, filt, send, recv, perm


@pytest.fixture(scope="module")
def family_graph():
    """``tests/test_bilinear_family.py``'s ``_random_graph``: 5 graphs of up
    to 7 nodes, 3 padding edges at a dead last node, F 4."""
    rs = np.random.RandomState(0)
    sizes = rs.randint(2, 8, 5)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offs[-1]) + 1
    send, recv = [], []
    for g in range(5):
        for i in range(sizes[g]):
            for j in range(sizes[g]):
                if i != j and rs.rand() < 0.7:
                    send.append(offs[g] + j)
                    recv.append(offs[g] + i)
    send += [n - 1] * 3
    recv += [n - 1] * 3
    send, recv = np.asarray(send, np.int32), np.asarray(recv, np.int32)
    order = np.argsort(recv, kind="stable")
    send, recv = send[order], recv[order]
    perm = np.argsort(send, kind="stable").astype(np.int32)
    return n, send, recv, perm, 7, 4


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_plain_matches_jax_kernel_and_numpy(window_graph):
    n, max_nodes, x, filt, send, recv, _ = window_graph
    ref = np.zeros_like(x)
    np.add.at(ref, recv, x[send] * filt)
    jout = _fused_gather_mul_segsum(jnp.asarray(x), jnp.asarray(filt), jnp.asarray(send),
                                    jnp.asarray(recv), n, max_nodes, interpret=True,
                                    exact=True)
    tx, tf, ts, tr = _t(x, filt, send, recv)
    before = fa.launches
    for out in (fa.fused_gather_mul_segsum_plain(tx, tf, ts, tr, n),
                fa.fused_gather_mul_segsum_kernel(tx, tf, ts, tr, n)):
        _close(out, jout)
        _close(out, ref)
    assert fa.launches == before  # a CPU tensor launches nothing


def test_plain_edge_cases():
    """No edges, rows without edges, F 3 and 200, one edge, padding edges
    summed onto the dead last node; more output rows than node rows."""
    rs = np.random.RandomState(1)
    for e, n, f in ((0, 5, 8), (1, 4, 3), (40, 9, 200), (30, 12, 3)):
        recv = np.sort(rs.choice(np.arange(0, n - 1, 2), size=e)).astype(np.int32)
        send = rs.randint(0, n, size=e).astype(np.int32)
        if e >= 3:
            recv[-3:] = send[-3:] = n - 1
        x, filt = rs.randn(n, f).astype(np.float32), rs.randn(e, f).astype(np.float32)
        ref = np.zeros((n + 2, f), np.float32)
        np.add.at(ref, recv, x[send] * filt)
        out = fa.fused_gather_mul_segsum_kernel(*_t(x, filt, send, recv), n + 2)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_kernel_wrapper_checks_its_arguments():
    x, filt = torch.zeros(4, 3), torch.zeros(5, 3)
    ids = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        fa.fused_gather_mul_segsum_kernel(x, filt, ids.long(), ids, 4)
    with pytest.raises(ValueError):
        fa.fused_gather_mul_segsum_kernel(x, torch.zeros(5, 2), ids, ids, 4)
    with pytest.raises(ValueError):
        fa.fused_gather_mul_segsum_kernel(x, filt, ids[:4], ids, 4)


@pytest.mark.parametrize("with_perm", [False, True])
def test_custom_vjp_route_first_order_matches_jax(window_graph, with_perm):
    n, max_nodes, x, filt, send, recv, perm = window_graph
    sj, rj = jnp.asarray(send), jnp.asarray(recv)

    def jloss(x, filt):
        out = fused_gather_mul_segsum(x, filt, sj, rj, n, max_nodes, interpret=True,
                                      exact=True)
        return jnp.sum(jnp.tanh(out) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(filt))
    tx, tf, ts, tr, tp = _t(x, filt, send, recv, perm)
    tx.requires_grad_(True)
    tf.requires_grad_(True)
    out = fa.FusedGatherMulSegsum.apply(tx, tf, ts, tr, n, tp if with_perm else None)
    grads = torch.autograd.grad((torch.tanh(out) ** 2).sum(), (tx, tf))
    for g, r in zip(grads, jg):
        _close(g, r)


def test_auto_dispatch_matches_the_unfused_chain(window_graph):
    n, max_nodes, x, filt, send, recv, perm = window_graph
    tx, tf, ts, tr, tp = _t(x, filt, send, recv, perm)
    ref = torch.zeros(n, 64).index_add_(0, tr, tx[ts.long()] * tf)
    for kw in (dict(indices_are_sorted=True, sender_perm=tp),
               dict(indices_are_sorted=True), dict(indices_are_sorted=False)):
        _close(fa.gather_mul_segsum_auto(tx, tf, ts, tr, n, max_nodes, **kw), ref.numpy())


def _chain(x, m, send, recv, n):
    return jax.ops.segment_sum(jnp.take(x, send, axis=0) * m, recv, n,
                               indices_are_sorted=True)


def test_gms_value_and_first_order_match_jax(family_graph):
    n, send, recv, perm, max_nodes, f = family_graph
    rs = np.random.RandomState(1)
    x, m = rs.randn(n, f).astype(np.float32), rs.randn(len(send), f).astype(np.float32)

    def jloss(x, m):
        return jnp.sum(jnp.tanh(jbilinear(x, m, send, recv, perm, max_nodes)))

    jx, jm = jnp.asarray(x), jnp.asarray(m)
    _close(kb.bilinear_gather_mul_segsum(*_t(x, m, send, recv, perm), max_nodes),
           jbilinear(jx, jm, send, recv, perm, max_nodes))
    tx, tm, ts, tr, tp = _t(x, m, send, recv, perm)
    tx.requires_grad_(True)
    tm.requires_grad_(True)
    out = kb.bilinear_gather_mul_segsum(tx, tm, ts, tr, tp, max_nodes)
    grads = torch.autograd.grad(torch.tanh(out).sum(), (tx, tm))
    for g, r in zip(grads, jax.grad(jloss, argnums=(0, 1))(jx, jm)):
        _close(g, r)


def _force_training(graph, theta, r, x0):
    """``tests/test_bilinear_family.py``'s ``_force_training_setup`` in
    PyTorch: a two-layer energy through GMS, force = d energy / d r, loss =
    energy + sum(sin(force)^2)."""
    n, send, recv, perm, max_nodes, f = graph
    ts, tr, tp = _t(send, recv, perm)

    def B(x, m):
        return kb.bilinear_gather_mul_segsum(x, m, ts, tr, tp, max_nodes)

    def energy(theta, r):
        m = torch.tanh(r @ theta)
        y = torch.tanh(B(x0 @ theta, m))
        return (B(y, m * 2.0) ** 2).sum()

    (force,) = torch.autograd.grad(energy(theta, r), r, create_graph=True)
    return energy(theta, r) + (torch.sin(force) ** 2).sum()


def _jax_force_training(graph):
    n, send, recv, perm, max_nodes, f = graph
    rs = np.random.RandomState(3)
    x0 = jnp.asarray(rs.randn(n, f))

    def energy(theta, r):
        m = jnp.tanh(r @ theta)
        y = jnp.tanh(jbilinear(x0 @ theta, m, send, recv, perm, max_nodes))
        return jnp.sum(jbilinear(y, m * 2.0, send, recv, perm, max_nodes) ** 2)

    def loss(theta, r):
        return energy(theta, r) + jnp.sum(jnp.sin(jax.grad(energy, argnums=1)(theta, r)) ** 2)

    theta = jnp.asarray(rs.randn(f, f))
    r = jnp.asarray(rs.randn(len(send), f))
    return loss, theta, r, x0


def _leaves(*arrays):
    return [t.requires_grad_(True) for t in _t(*map(np.asarray, arrays))]


# The force-training pattern takes sin of forces of about 100: float32
# rounding in either package moves its derivatives by some 3e-4 relative
# (the JAX package's own test allows 2e-4 between its two paths). The
# comparison runs in float64, where only the algorithm can differ.


def test_gms_grad_of_grad_training_pattern_matches_jax(family_graph):
    with jax.enable_x64():
        loss, theta, r, x0 = _jax_force_training(family_graph)
        refs = [jax.jit(jax.grad(loss, argnums=a))(theta, r) for a in (0, 1)]
        tt, trr, tx0 = _leaves(theta, r, x0)
    grads = torch.autograd.grad(_force_training(family_graph, tt, trr, tx0.detach()),
                                (tt, trr))
    for g, ref in zip(grads, refs):
        _close(g, ref)


def test_gms_third_order_matches_jax(family_graph):
    with jax.enable_x64():
        loss, theta, r, x0 = _jax_force_training(family_graph)
        ref = jax.grad(lambda th: jnp.sum(jax.grad(loss)(th, r) ** 2))(theta)
        tt, trr, tx0 = _leaves(theta, r, x0)
    (g,) = torch.autograd.grad(_force_training(family_graph, tt, trr, tx0.detach()), tt,
                               create_graph=True)
    (third,) = torch.autograd.grad((g ** 2).sum(), tt)
    _close(third, ref)


def test_gms_gradcheck_to_second_order(family_graph):
    """float64 finite differences of GMS and of its backward, the inputs as
    leaves."""
    n, send, recv, perm, max_nodes, f = family_graph
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(n, f)).requires_grad_(True)
    m = torch.from_numpy(rs.randn(len(send), f)).requires_grad_(True)
    ts, tr, tp = _t(send, recv, perm)

    def fn(x, m):
        return kb.gms(x, m, ts, tr, tp, max_nodes=max_nodes)

    assert torch.autograd.gradcheck(fn, (x, m))
    assert torch.autograd.gradgradcheck(fn, (x, m))


def test_invert_perm_and_permute_rows():
    perm = torch.from_numpy(np.random.RandomState(2).permutation(11).astype(np.int32))
    inv = kb.invert_perm(perm)
    assert torch.equal(perm[inv.long()], torch.arange(11, dtype=torch.int32))
    v = torch.randn(11, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(lambda v: kb.PermuteRows.apply(v, perm, inv), (v,))


@pytest.mark.parametrize("fused", [True, "vjp"])
def test_gather_mul_pool_edges_fused_routes(fused):
    """Both fused routes against the unfused chain on a batch, values and
    gradients, and the route without a ``sender_perm``."""
    rs = np.random.RandomState(4)
    graphs = []
    for n in (5, 9, 3):
        ei = np.array([[i, j] for i in range(n) for j in range(n) if i != j and rs.rand() < 0.6])
        graphs.append({"node_number": np.ones(n, int), "edge_indices": ei.reshape(-1, 2)})
    b = batch_graphs(graphs, device="cpu")
    x = torch.randn(b.n_node, 6, requires_grad=True)
    filt = torch.randn(b.n_edge, 6, requires_grad=True)
    for batch in (b, b.replace(edges={k: v for k, v in b.edges.items() if k != "sender_perm"})):
        outs = [gather_mul_pool_edges(batch, x, filt, fused=fu) for fu in (False, fused)]
        grads = [torch.autograd.grad((o ** 2).sum(), (x, filt)) for o in outs]
        _close(outs[1], outs[0].detach().numpy())
        for g, r in zip(grads[1], grads[0]):
            _close(g, r.numpy())
