"""The port's segment ops, activations and the sorted segment-sum autograd
pair against the JAX package.

On the CPU the kernel's wrapper runs its plain version, so these tests
exercise the wiring of ``SortedSegmentSum`` / ``GatherWithSortedTranspose``;
``test_torch_cuda.py`` holds the kernel itself against the plain version on
a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcnn_keras_tpu.ops import activ as jactiv
from gcnn_keras_tpu.ops import segment as jseg
from gcnn_keras_tpu.ops.pallas.segment_sum import _sorted_segment_sum_pallas_v2
from gcnn_keras_tpu_torch.ops import activ as tactiv
from gcnn_keras_tpu_torch.ops import segment as tseg
from gcnn_keras_tpu_torch.ops.cuda import segment_sum as kseg
from gcnn_keras_tpu_torch.ops.cuda.fused_aggregate import gather_with_sorted_transpose

torch.set_num_threads(1)


def _sorted_case(seed, e, n, f, empty_every=3):
    """Ascending ids over n segments, every ``empty_every``-th one empty,
    plus the last (a dead padding row)."""
    rs = np.random.RandomState(seed)
    allowed = np.array([r for r in range(n - 1) if r % empty_every])
    ids = np.sort(rs.choice(allowed, size=e)).astype(np.int32)
    vals = rs.randn(e, f).astype(np.float32)
    return vals, ids


def _hold_to_jax(vals, ids, n):
    """SortedSegmentSum against ``jax.ops.segment_sum`` and the Pallas kernel
    in interpret mode; returns the port's sum."""
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), n,
                                         indices_are_sorted=True))
    pallas = np.asarray(_sorted_segment_sum_pallas_v2(
        jnp.asarray(vals), jnp.asarray(ids), n, exact=True, interpret=True))
    out = kseg.SortedSegmentSum.apply(torch.from_numpy(vals), torch.from_numpy(ids),
                                      n).numpy()
    assert out.shape == (n, vals.shape[1])
    scale = 1.0 + np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-6 * scale
    assert np.abs(out - pallas).max() <= 1e-6 * scale
    return out


# the kernel's layouts split at F <= 8 (a thread a row) and F a multiple of 4
# (float4 columns); 130 takes scalar columns
@pytest.mark.parametrize("f", [1, 3, 4, 5, 64, 128, 130])
def test_sorted_segment_sum_matches_jax(f):
    vals, ids = _sorted_case(f, 3000, 700, f)
    out = _hold_to_jax(vals, ids, 700)
    assert not out[0].any() and not out[699].any()  # empty segments are 0


@pytest.mark.parametrize("f", [3, 128])
def test_sorted_segment_sum_ids_above_zero_matches_jax(f):
    """Ids from row 1000 of 2000: the first 1000 rows and the last 100 are
    empty."""
    rs = np.random.RandomState(f + 11)
    ids = np.sort(rs.randint(1000, 1900, size=3000)).astype(np.int32)
    out = _hold_to_jax(rs.randn(3000, f).astype(np.float32), ids, 2000)
    assert not out[:1000].any() and not out[1900:].any()


@pytest.mark.parametrize("shape", [(40,), (40, 2, 3)])
def test_segment_sum_trailing_dims(shape):
    rs = np.random.RandomState(1)
    vals = rs.randn(*shape).astype(np.float32)
    ids = np.sort(rs.randint(0, 9, size=shape[0])).astype(np.int32)
    ref = np.asarray(jseg.segment_sum(jnp.asarray(vals), jnp.asarray(ids), 10,
                                      indices_are_sorted=True))
    for sorted_ in (True, False):
        out = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 10,
                               indices_are_sorted=sorted_).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mean", "max", "min", "segment_sum"])
def test_segment_ops_by_name_match_jax(name):
    rs = np.random.RandomState(2)
    vals = rs.randn(50, 4).astype(np.float32)
    ids = np.sort(rs.randint(0, 12, size=50)).astype(np.int32)
    ids[ids == 5] = 6  # an empty segment
    ref = np.asarray(jseg.segment_ops_by_name(name, jnp.asarray(vals),
                                              jnp.asarray(ids), 13, True))
    out = tseg.segment_ops_by_name(name, torch.from_numpy(vals),
                                   torch.from_numpy(ids), 13, True).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_segment_ops_by_name_unknown():
    with pytest.raises(ValueError):
        tseg.segment_ops_by_name("median", torch.zeros(2, 1),
                                 torch.zeros(2, dtype=torch.int32), 1)


def test_segment_softmax_matches_jax():
    rs = np.random.RandomState(3)
    vals = rs.randn(30, 2).astype(np.float32)
    ids = rs.randint(0, 7, size=30).astype(np.int32)
    mask = rs.rand(30) > 0.2
    ref = np.asarray(jseg.segment_softmax(jnp.asarray(vals), jnp.asarray(ids), 8,
                                          mask=jnp.asarray(mask)))
    out = tseg.segment_softmax(torch.from_numpy(vals), torch.from_numpy(ids), 8,
                               mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def _gather_case(seed=5, n=11, e=60, trailing=(3,)):
    rs = np.random.RandomState(seed)
    senders = rs.randint(0, n - 1, size=e).astype(np.int32)
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    vals = rs.randn(n, *trailing)
    return vals, senders, perm


@pytest.mark.parametrize("trailing", [(3,), (2, 4)])
def test_gather_transpose_equals_scatter_by_senders(trailing):
    vals, senders, perm = _gather_case(trailing=trailing)
    v = torch.tensor(vals, dtype=torch.float32, requires_grad=True)
    out = gather_with_sorted_transpose(v, torch.from_numpy(senders),
                                       torch.from_numpy(perm))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  vals.astype(np.float32)[senders])
    ct = torch.from_numpy(np.random.RandomState(6).randn(*out.shape).astype(np.float32))
    (grad,) = torch.autograd.grad(out, v, ct)
    ref = np.zeros(vals.shape, np.float32)
    np.add.at(ref, senders, ct.numpy())
    np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_gradcheck_pair_float64():
    vals, senders, perm = _gather_case()
    s, p = torch.from_numpy(senders), torch.from_numpy(perm)
    s_sorted = s[p]

    def chain(v):
        # gather by unsorted senders, then sum by ascending ids
        g = gather_with_sorted_transpose(v, s, p)
        return kseg.SortedSegmentSum.apply(g * g, s_sorted, 11)

    v = torch.tensor(vals, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(chain, (v,))
    assert torch.autograd.gradgradcheck(chain, (v,))
    w = torch.randn(60, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: kseg.SortedSegmentSum.apply(x, s_sorted, 11) ** 2, (w,))
    assert torch.autograd.gradgradcheck(
        lambda x: kseg.SortedSegmentSum.apply(x, s_sorted, 11) ** 2, (w,))


def test_wrapper_rejects_bad_inputs():
    v = torch.zeros(4, 2)
    with pytest.raises(TypeError):
        kseg.segment_sum(v, torch.zeros(4, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        kseg.segment_sum(v, torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        kseg.segment_sum(torch.zeros(4), torch.zeros(4, dtype=torch.int32), 3)


def test_wrapper_cpu_takes_plain_and_counts_no_launch():
    before = kseg.launches
    vals, ids = _sorted_case(7, 100, 20, 5)
    out = kseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 20)
    plain = kseg.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids), 20)
    assert torch.equal(out, plain)
    assert kseg.launches == before


@pytest.mark.parametrize("name", sorted(jactiv._ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.linspace(-30.0, 30.0, 241).astype(np.float32)
    ref = np.asarray(jactiv.get_activation(name)(jnp.asarray(x)))
    out = tactiv.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)


def test_get_activation_serialized_and_unknown():
    fn = tactiv.get_activation({"class_name": "leaky_relu", "config": {"alpha": 0.2}})
    assert float(fn(torch.tensor(-1.0))) == pytest.approx(-0.2)
    assert tactiv.get_activation(torch.tanh) is torch.tanh
    with pytest.raises(ValueError):
        tactiv.get_activation("nope")
