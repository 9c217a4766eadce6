"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so on a machine without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from gcnn_keras_tpu_torch.ops.cuda import segment_sum as kseg
from gcnn_keras_tpu_torch.ops.cuda.fused_aggregate import gather_with_sorted_transpose

torch.set_num_threads(1)

# max|kernel - plain| <= TOL * (1 + max|plain|): index_add_ sums with
# atomics in no fixed order, the kernel in edge order
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sorted_case(seed, e, n, f):
    rs = np.random.RandomState(seed)
    allowed = np.array([r for r in range(n - 1) if r % 3])  # empty segments
    ids = np.sort(rs.choice(allowed, size=e)).astype(np.int32)
    return rs.randn(e, f).astype(np.float32), ids


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,f", [(54784, 8192, 128), (54784, 8192, 3),
                                   (8192, 513, 64), (1000, 50, 1), (1000, 50, 5),
                                   (1000, 50, 300)])
def test_kernel_matches_plain(cuda_device, e, n, f):
    vals, ids = _sorted_case(e + f, e, n, f)
    v = torch.from_numpy(vals).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    before = kseg.launches
    out = kseg.segment_sum(v, i, n)
    torch.cuda.synchronize()
    assert kseg.launches == before + 1
    plain = kseg.segment_sum_plain(v, i, n)
    assert (out - plain).abs().max().item() <= TOL * (1.0 + plain.abs().max().item())


@pytest.mark.cuda
def test_kernel_edge_cases(cuda_device):
    v = torch.randn(500, 7, device=cuda_device)
    one = torch.zeros(500, dtype=torch.int32, device=cuda_device)
    out = kseg.segment_sum(v, one, 4)
    torch.cuda.synchronize()
    assert torch.allclose(out[0], v.sum(0), rtol=1e-5, atol=1e-5)
    assert not out[1:].any()
    empty = kseg.segment_sum(torch.zeros(0, 3, device=cuda_device),
                             torch.zeros(0, dtype=torch.int32, device=cuda_device), 6)
    torch.cuda.synchronize()
    assert empty.shape == (6, 3) and not empty.any()


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    ids = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kseg.segment_sum(torch.zeros(4, 2, dtype=torch.float64, device=cuda_device), ids, 2)
    with pytest.raises(ValueError):
        kseg.segment_sum(torch.zeros(2, 4, device=cuda_device).t(), ids, 2)
    with pytest.raises(ValueError):
        kseg.segment_sum(torch.zeros(4, 2, device=cuda_device), ids.cpu(), 2)


@pytest.mark.cuda
def test_gather_transpose_runs_on_the_kernel(cuda_device):
    rs = np.random.RandomState(0)
    senders = rs.randint(0, 99, size=3000).astype(np.int32)
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    x = torch.randn(100, 16, device=cuda_device, requires_grad=True)
    s = torch.from_numpy(senders).to(cuda_device)
    p = torch.from_numpy(perm).to(cuda_device)
    ct = torch.randn(3000, 16, device=cuda_device)
    before = kseg.launches
    (grad,) = torch.autograd.grad(gather_with_sorted_transpose(x, s, p), x, ct)
    torch.cuda.synchronize()
    assert kseg.launches == before + 1
    ref = torch.zeros(100, 16, device=cuda_device).index_add_(0, s, ct)
    assert (grad - ref).abs().max().item() <= TOL * (1.0 + ref.abs().max().item())
