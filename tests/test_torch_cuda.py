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


def _sorted_case(seed, e, n, f, layout="every third row empty"):
    """Ascending ids over n rows: every third row empty; or from row n / 2
    on, with empty rows at both ends; or one row of 5000 of the e edges."""
    rs = np.random.RandomState(seed)
    if layout == "every third row empty":
        allowed = np.array([r for r in range(n - 1) if r % 3])
        ids = rs.choice(allowed, size=e)
    elif layout == "from row n / 2":
        ids = rs.randint(n // 2, n - n // 20, size=e)
    else:
        ids = np.concatenate([rs.randint(0, n, size=e - 5000), np.full(5000, n // 2)])
    return rs.randn(e, f).astype(np.float32), np.sort(ids).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,f,layout", [
    (54784, 8192, 128, "every third row empty"), (54784, 8192, 3, "every third row empty"),
    (8192, 513, 64, "every third row empty"), (1000, 50, 1, "every third row empty"),
    (1000, 50, 5, "every third row empty"), (1000, 50, 300, "every third row empty"),
    (54784, 8192, 4, "every third row empty"), (1000, 50, 130, "every third row empty"),
    (6000, 2000, 3, "from row n / 2"), (6000, 2000, 128, "from row n / 2"),
    (7000, 300, 3, "one long row"), (7000, 300, 64, "one long row"),
    (7000, 300, 130, "one long row"),
    # PAiNN's equivariant messages (E, 3 x 128) and GCN's at Cora scale
    (54784, 8192, 384, "every third row empty"), (21000, 2709, 140, "every third row empty"),
    # the zoo's: GIN's, GAT's and RGCN's messages, INorp's, SAGE's readout
    (54784, 8192, 64, "every third row empty"), (54784, 8192, 50, "every third row empty"),
    (8192, 513, 32, "every third row empty")])
def test_kernel_matches_plain(cuda_device, e, n, f, layout):
    vals, ids = _sorted_case(e + f, e, n, f, layout)
    v = torch.from_numpy(vals).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    before = kseg.launches
    out = kseg.segment_sum(v, i, n)
    torch.cuda.synchronize()
    assert kseg.launches == before + 1
    plain = kseg.segment_sum_plain(v, i, n)
    assert (out - plain).abs().max().item() <= TOL * (1.0 + plain.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,f,layout", [
    (54784, 8192, 128, "every third row empty"), (54784, 8192, 22, "every third row empty"),
    (417024, 8192, 10, "every third row empty"), (1000, 50, 1, "every third row empty"),
    (1000, 50, 3, "every third row empty"), (1000, 50, 130, "every third row empty"),
    (6000, 2000, 128, "from row n / 2"), (7000, 300, 1, "one long row"),
    (7000, 300, 64, "one long row"), (54784, 8192, 384, "every third row empty")])
def test_bf16_kernel_matches_plain(cuda_device, e, n, f, layout):
    """The bfloat16 instance against its plain version (a float32
    ``index_add_`` rounded once): one bfloat16 ulp, ``chip_smoke``'s
    ``BF16_KERNEL_TOL``; empty segments come out 0. It counts on
    ``launches_bf16`` only."""
    import chip_smoke
    vals, ids = _sorted_case(e + f, e, n, f, layout)
    v = torch.from_numpy(vals).to(cuda_device).to(torch.bfloat16)
    i = torch.from_numpy(ids).to(cuda_device)
    before = (kseg.launches, kseg.launches_bf16)
    out = kseg.segment_sum(v, i, n)
    torch.cuda.synchronize()
    assert (kseg.launches, kseg.launches_bf16) == (before[0], before[1] + 1)
    plain = kseg.segment_sum_plain(v, i, n)
    assert out.dtype == plain.dtype == torch.bfloat16
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= chip_smoke.BF16_KERNEL_TOL * (1.0 + plain.float().abs().max().item())
    empty = torch.ones(n, dtype=torch.bool, device=cuda_device)
    empty[i.long()] = False
    assert not out[empty].float().any()


@pytest.mark.cuda
def test_bf16_kernel_edge_cases(cuda_device):
    """One segment, no edges, and values 2 bytes off the 8-byte alignment
    of the 4-wide loads (the scalar layout)."""
    v = torch.randn(500, 8, device=cuda_device).to(torch.bfloat16)
    one = torch.zeros(500, dtype=torch.int32, device=cuda_device)
    out = kseg.segment_sum(v, one, 4)
    torch.cuda.synchronize()
    assert out[0].float().allclose(v.float().sum(0).bfloat16().float(), rtol=2.0 ** -7)
    assert not out[1:].float().any()
    empty = kseg.segment_sum(torch.zeros(0, 3, dtype=torch.bfloat16, device=cuda_device),
                             torch.zeros(0, dtype=torch.int32, device=cuda_device), 6)
    assert empty.shape == (6, 3) and empty.dtype == torch.bfloat16 and not empty.float().any()
    base = torch.randn(4000 * 16 + 1, device=cuda_device).to(torch.bfloat16)
    shifted = base[1:].view(4000, 16)
    ids = torch.sort(torch.randint(0, 300, (4000,), device=cuda_device))[0].to(torch.int32)
    out = kseg.segment_sum(shifted, ids, 300)
    plain = kseg.segment_sum_plain(shifted, ids, 300)
    torch.cuda.synchronize()
    assert (out.float() - plain.float()).abs().max().item() <= 2.0 ** -7 * (
        1 + plain.float().abs().max().item())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kseg.segment_sum(torch.zeros(4, 2, dtype=torch.float16, device=cuda_device),
                         torch.zeros(4, dtype=torch.int32, device=cuda_device), 2)


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


# ------------------------------------------------------------ ACSF G2/G4

# the HDNNP2nd serving tables (elements H, C, N, O, F): R*m = 20 and 120
ACSF_ELEMENTS = [1, 6, 7, 8, 9]
G2_KW = dict(eta=[0.0, 0.3], rs=[0.0, 3.0], rc=4.0)
G4_KW = dict(eta=[0.0, 0.3], zeta=[1.0, 8.0], lamda=[-1.0, 1.0], rc=4.0,
             multiplicity=2.0)
# max|kernel - plain| <= tol * (1 + max|plain|): the forward passes sum in
# another order than index_add_ (G2 with shared-memory atomics); the force
# and tangent passes add terms of both signs, the force passes and the G2
# tangent pass with atomics, in an order that varies from run to run
ACSF_FWD_TOL, ACSF_VJP_TOL = 1e-5, 1e-4
ACSF_NAMES = ["g2_fwd", "g4_fwd", "g4_vjp", "g2_vjp", "g4_jvp", "g2_jvp"]
# each kernel with the HDNNP tables (G4: 2 eta, 4 (zeta, lambda), 1 r_c, the
# G4 fwd and jvp kernels' exact instance), and the G4 kernels with a table of
# other unique counts (their kMaxUniq instance)
ACSF_CASES = ([pytest.param(n, False, id=n) for n in ACSF_NAMES]
              + [pytest.param(n, True, id=f"{n}-other-g4-table")
                 for n in ("g4_fwd", "g4_vjp", "g4_jvp")])


def _acsf_graphs(seed, n_mols, elements=(1, 6, 7, 8, 9)):
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle, set_range
    rs = np.random.RandomState(seed)
    graphs = []
    for n in rs.randint(3, 21, size=n_mols):
        g = {"node_number": rs.choice(list(elements), size=n),
             "node_coordinates": (rs.randn(n, 3) * 2.0).astype(np.float32)}
        g = set_range(g, max_distance=4.0, max_neighbours=25)
        g["edge_indices"] = g.pop("range_indices")
        graphs.append(set_angle(g, range_indices="edge_indices"))
    return graphs


def _acsf_layers():
    from gcnn_keras_tpu_torch.layers.conv.acsf import ACSFG2, ACSFG4
    return (ACSFG2(**ACSFG2.make_param_table(**G2_KW, elements=ACSF_ELEMENTS)),
            ACSFG4(**ACSFG4.make_param_table(**G4_KW, elements=ACSF_ELEMENTS)))


def _g4_other_static():
    """A shared G4 table of 8 eta, 1 (zeta, lambda) and 3 r_c (m = 24)."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    grid = [[eta, 4.0, 1.0, rc] for eta in np.linspace(0.0, 0.7, 8) for rc in (3.0, 3.5, 4.0)]
    n_pairs = len(ACSF_ELEMENTS) * (len(ACSF_ELEMENTS) + 1) // 2
    table = np.broadcast_to(np.asarray(grid, np.float32), (n_pairs, len(grid), 4))
    return ka.make_static(table, ACSF_ELEMENTS, False, 2.0)


def _acsf_static(name, other_g4_table):
    g2, g4 = _acsf_layers()
    if other_g4_table:
        return _g4_other_static()
    return (g4 if name.startswith("g4") else g2)._static


def _acsf_args(name, b):
    pos = b.nodes["node_coordinates"]
    z = b.nodes["node_number"].to(torch.int32)
    if name.startswith("g4"):
        return pos, z, b.angles, b.angle_mask
    return pos, z, b.senders, b.receivers, b.edge_mask


def _acsf_check(name, b, st, ct_seed=0):
    """Launch kernel ``name`` once on batch ``b`` and hold it against its
    plain version; returns the kernel's output."""
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    kernel, plain = {"g2_fwd": (ka.g2_forward, ka.g2_forward_plain),
                     "g4_fwd": (ka.g4_forward, ka.g4_forward_plain),
                     "g2_vjp": (ka.g2_vjp, ka.g2_vjp_plain),
                     "g4_vjp": (ka.g4_vjp, ka.g4_vjp_plain),
                     "g2_jvp": (ka.g2_jvp, ka.g2_jvp_plain),
                     "g4_jvp": (ka.g4_jvp, ka.g4_jvp_plain)}[name]
    args = _acsf_args(name, b)
    gen = torch.Generator(device=b.senders.device).manual_seed(ct_seed)
    if name.endswith("vjp"):
        width = st.num_rel * (len(st.eta_inv) if name.startswith("g4") else len(st.sets))
        args = args + (torch.randn(b.n_node, width, generator=gen, device=b.senders.device),)
    elif name.endswith("jvp"):
        args = args + (torch.randn(b.n_node, 3, generator=gen, device=b.senders.device),)
    before = dict(ka.launches)
    out = kernel(*args, st)
    torch.cuda.synchronize()
    assert ka.launches[name] == before[name] + 1
    ref = plain(*args, st)
    tol = ACSF_FWD_TOL if name.endswith("fwd") else ACSF_VJP_TOL
    scale = 1.0 + (ref.abs().max().item() if ref.numel() else 0.0)
    err = (out - ref).abs().max().item() if ref.numel() else 0.0
    assert out.shape == ref.shape and err <= tol * scale, (name, err, scale)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,other_g4_table", ACSF_CASES)
def test_acsf_kernel_matches_plain(cuda_device, name, other_g4_table):
    from gcnn_keras_tpu_torch.batch import batch_graphs
    b = batch_graphs(_acsf_graphs(0, 96), device=cuda_device)
    _acsf_check(name, b, _acsf_static(name, other_g4_table))


@pytest.mark.cuda
@pytest.mark.parametrize("name,other_g4_table", ACSF_CASES)
def test_acsf_kernel_edge_cases(cuda_device, name, other_g4_table):
    """With the HDNNP tables (the G4 kernels also with a table of other
    unique counts), ``chip_smoke.acsf_edge_batch``: the G4 fwd and jvp
    kernels' block layout (a centre whose angles span three or more blocks,
    one whose first angle is a block's first, rows without angles inside a
    block's range, the last block), a collinear triple (the clamped cosine derivative), an
    atom with one neighbour and one with none (no angles), elements outside
    the table (S, Cl); the G2 kernels also ``chip_smoke.acsf_g2_edge_batch``
    (a receiver whose edges span three of the G2 fwd kernel's ranges,
    receivers without edges inside a range and after the last edge, senders
    further apart than the vjp kernel's window); then all rows masked, and
    no rows at all."""
    import chip_smoke
    b = chip_smoke.acsf_edge_batch(cuda_device)
    st = _acsf_static(name, other_g4_table)
    out = _acsf_check(name, b, st)
    assert torch.isfinite(out).all()
    if not name.endswith("vjp"):
        assert not out[b.n_node - 1].any()  # the dead node gets nothing
    if name.startswith("g2"):
        assert torch.isfinite(_acsf_check(name, chip_smoke.acsf_g2_edge_batch(cuda_device),
                                          st)).all()
    masked = b.replace(angle_mask=torch.zeros_like(b.angle_mask),
                       edge_mask=torch.zeros_like(b.edge_mask))
    assert not _acsf_check(name, masked, st).any()
    dev = cuda_device
    empty = b.replace(angles=torch.zeros(0, 3, dtype=torch.int32, device=dev),
                      angle_mask=torch.zeros(0, dtype=torch.bool, device=dev),
                      senders=torch.zeros(0, dtype=torch.int32, device=dev),
                      receivers=torch.zeros(0, dtype=torch.int32, device=dev),
                      edge_mask=torch.zeros(0, dtype=torch.bool, device=dev))
    assert not _acsf_check(name, empty, st).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g2_fwd", "g4_fwd", "g4_jvp", "g2_jvp"])
def test_acsf_kernels_give_the_same_bits_run_to_run(cuda_device, name):
    """The G2 and G4 fwd and jvp kernels sum in a fixed order, without
    atomics: two launches on the HDNNP2nd serving batch give identical
    bits."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    pred = chip_smoke.make_hdnnp_predictor("cuda")
    _, b = pred.make_batch(chip_smoke.qm9_like_mols(0, 512))
    model = pred.model.energy_model
    st = (model.acsf_g2 if name.startswith("g2") else model.acsf_g4)._static
    args = chip_smoke.acsf_call_args(name, st, b)
    kernel = {"g2_fwd": ka.g2_forward, "g4_fwd": ka.g4_forward, "g4_jvp": ka.g4_jvp,
              "g2_jvp": ka.g2_jvp}[name]
    first, second = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all() and first.abs().max().item() > 0.0
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_acsf_layers_run_the_kernels_forward_and_backward(cuda_device):
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    graphs = _acsf_graphs(1, 32)
    layers = _acsf_layers()
    for layer, fwd, vjp in zip(layers, ("g2_fwd", "g4_fwd"), ("g2_vjp", "g4_vjp")):
        outs = []
        for dev in (cuda_device, torch.device("cpu")):
            b = batch_graphs(graphs, device=dev)
            pos = b.nodes["node_coordinates"].clone().requires_grad_(True)
            before = dict(ka.launches)
            out = layer(b, positions=pos)
            (g,) = torch.autograd.grad(out.sum(), pos)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert ka.launches[fwd] == before[fwd] + 1
                assert ka.launches[vjp] == before[vjp] + 1
            outs.append((out.detach().cpu(), g.cpu()))
        (o, g), (ro, rg) = outs
        assert (o - ro).abs().max().item() <= ACSF_FWD_TOL * (1 + ro.abs().max().item())
        assert (g - rg).abs().max().item() <= ACSF_VJP_TOL * (1 + rg.abs().max().item())


@pytest.mark.cuda
def test_acsf_force_loss_gradient_on_the_card_matches_the_cpu(cuda_device):
    """A loss on the force pass, differentiated along a weight on the
    descriptors: the vjp kernels' backward launches the jvp kernels once
    each; a derivative along positions raises."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    graphs = _acsf_graphs(5, 32)
    layers = _acsf_layers()
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch_graphs(graphs, device=dev)
        before = dict(ka.launches)
        grads, hessians = [], []
        for layer in layers:
            w = torch.from_numpy(np.random.RandomState(6).randn(
                b.n_node, layer.out_features).astype(np.float32)).to(dev).requires_grad_(True)
            pos = b.nodes["node_coordinates"].clone().requires_grad_(True)
            energy = (torch.tanh(layer(b, positions=pos)) * w).sum()
            (force,) = torch.autograd.grad(energy, pos, create_graph=True)
            loss = (force ** 2).sum()
            (gw,) = torch.autograd.grad(loss, w, retain_graph=True)
            grads.append(gw.cpu())
            hessians.append((loss, pos))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: v - before[k] for k, v in ka.launches.items()} == dict.fromkeys(
                ka.KERNELS, 1)
        for loss, pos in hessians:
            with pytest.raises(NotImplementedError, match="position Hessian"):
                torch.autograd.grad(loss, pos)
        results.append(grads)
    for g, ref in zip(*results):
        assert (g - ref).abs().max().item() <= ACSF_VJP_TOL * (1 + ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("path,size", [("schnet_train", 16), ("hdnnp2nd_train", 16),
                                       ("hdnnp4th_train", 16), ("schnet_chain_train", 16),
                                       ("painn_train", 16), ("gcn_cora_train", 2708),
                                       ("hdnnp4th_mol520_train", 520), ("schnet_bf16_train", 16),
                                       ("schnet_dense_train", 16), ("schnet_remat_train", 16),
                                       ("schnet_chain_remat_train", 16),
                                       ("hdnnp2nd_weighted_train", 16),
                                       ("hdnnp4th_norm_train", 16)])
def test_training_step_on_the_card_matches_the_cpu(cuda_device, path, size):
    """One full-width training step of ``chip_smoke.py`` on 16 molecules
    (GCN: the 2708-node citation graph of ``sec_gcn_cora``, seed 7; the
    molecule-scale path: one molecule of 520 atoms from seed 7): the
    loss and every parameter gradient equal the CPU's (within the path's
    ``loss_tol`` and ``grad_tol``, where it sets them), and each kernel
    launches as often as ``TRAIN_PATHS`` derives."""
    import chip_smoke

    results = []
    for dev in ("cuda", "cpu"):
        model, trainer, state = chip_smoke.make_trainer(path, dev)
        batch = chip_smoke.train_batch(path, 7, size, dev)
        before = chip_smoke.kernel_counts()
        state, metrics = trainer.step_fn()(state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
            assert launched == chip_smoke.TRAIN_PATHS[path]["launches"]
        results.append((metrics["loss"].item(), [p.grad.cpu() for p in model.parameters()]))
    (loss, grads), (ref_loss, ref_grads) = results
    assert abs(loss - ref_loss) <= chip_smoke.TRAIN_PATHS[path].get(
        "loss_tol", chip_smoke.TRAIN_TOL) * abs(ref_loss)
    grad_tol = chip_smoke.TRAIN_PATHS[path].get("grad_tol", chip_smoke.TRAIN_TOL)
    for g, ref in zip(grads, ref_grads):
        assert (g - ref).abs().max().item() <= grad_tol * ref.abs().max().item()


@pytest.mark.cuda
def test_acsf_kernels_reject_what_they_cannot_take(cuda_device):
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    b = batch_graphs(_acsf_graphs(2, 4), device=cuda_device)
    _, g4 = _acsf_layers()
    pos, z, angles, mask = _acsf_args("g4_fwd", b)
    with pytest.raises(TypeError):
        ka.g4_forward(pos.double(), z, angles, mask, g4._static)
    with pytest.raises(TypeError):
        ka.g4_forward(pos, z, angles.long(), mask, g4._static)
    with pytest.raises(ValueError):
        ka.g4_forward(pos, z, angles, mask.cpu(), g4._static)


@pytest.mark.cuda
def test_hdnnp2nd_serving_on_the_card_matches_the_cpu(cuda_device):
    import functools
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp2nd import make_model_behler
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    kw = dict(g2_kwargs=dict(G2_KW, elements=ACSF_ELEMENTS),
              g4_kwargs=dict(G4_KW, elements=ACSF_ELEMENTS),
              mlp_kwargs={"units": [64, 64, 1], "num_relations": 10,
                          "activation": ["swish", "swish", "linear"]})
    frames = [{k: g[k] for k in ("node_number", "node_coordinates", "edge_indices")}
              for g in _acsf_graphs(3, 16)]
    pre = [functools.partial(set_angle, range_indices="edge_indices")]
    answers = []
    for dev in (cuda_device, torch.device("cpu")):
        before = dict(ka.launches)
        model = make_model_behler(device=dev, **kw)
        answers.append(MolDynamicsModelPredictor(
            EnergyForceModel(model, device=dev), graph_preprocessors=pre, device=dev)(frames))
        launched = {k: v - before[k] for k, v in ka.launches.items()}
        # serving runs no tangent pass
        assert launched == {k: int(dev.type == "cuda" and not k.endswith("jvp"))
                            for k in ka.KERNELS}
    gpu, cpu = answers
    for key in ("energy", "force"):
        a = np.concatenate([r[key] for r in gpu])
        b = np.concatenate([r[key] for r in cpu])
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


# ------------------------------------------------------------ SPD solve

# max|kernel - plain| <= SPD_TOL * (1 + max|plain|) and
# max|A x - b| <= SPD_RESIDUAL_TOL * (1 + max|b|); the kernel does the
# plain version's arithmetic, rounded the same way
SPD_TOL, SPD_RESIDUAL_TOL = 1e-5, 1e-4


def _random_spd(g, m, k, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    half = torch.randn(g, m, m, generator=gen) / m ** 0.5
    a = half @ half.transpose(1, 2) + 2.0 * torch.eye(m)
    return a.to(dev), torch.randn(g, m, k, generator=gen).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,k", [(513, 20, 2), (1, 20, 2), (7, 1, 2), (4, 239, 2),
                                   (3, 20, 1), (2, 100, 5), (2, 239, 1),
                                   # the warp kernel's last M (M + K past 32 columns)
                                   # and the block kernel's first; several right-hand
                                   # sides in the warp kernel
                                   (5, 32, 2), (5, 33, 2), (513, 20, 5),
                                   # small systems in the warp kernel's padded rows
                                   (7, 5, 2), (7, 12, 2), (7, 27, 2)])
def test_spd_kernel_matches_plain(cuda_device, g, m, k):
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    assert ks.fits_shared_memory(m, k)
    a, b = _random_spd(g, m, k, g + m + k, cuda_device)
    before = ks.launches
    x = ks.spd_solve(a, b)
    torch.cuda.synchronize()
    assert ks.launches == before + 1
    plain = ks.spd_solve_plain(a, b)
    assert (x - plain).abs().max().item() <= SPD_TOL * (1 + plain.abs().max().item())
    assert (a @ x - b).abs().max().item() <= SPD_RESIDUAL_TOL * (1 + b.abs().max().item())


@pytest.mark.cuda
def test_spd_kernel_equals_plain_bit_for_bit(cuda_device):
    """At the Qeq serving shape the warp kernel does the plain version's
    arithmetic, rounded the same way: the same bits."""
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    a, b = _random_spd(513, 20, 2, 5, cuda_device)
    x = ks.spd_solve(a, b)
    torch.cuda.synchronize()
    assert torch.equal(x.view(torch.int32), ks.spd_solve_plain(a, b).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(33, 1), (33, 2), (33, 5), (64, 1), (64, 2), (64, 5),
                                 (100, 1), (100, 2), (100, 5), (160, 1), (160, 2),
                                 (160, 5), (239, 1), (239, 2)])
def test_spd_block_kernel_equals_plain_bit_for_bit(cuda_device, m, k):
    """The block kernel (M > 32; 239 at K = 5 is past the gate) takes the
    steps in pairs, and each entry still goes through the plain version's
    operations in its order: the same bits, at an odd and an even M, one
    and several right-hand sides."""
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    assert ks.fits_shared_memory(m, k)
    a, b = _random_spd(9, m, k, m + k, cuda_device)
    before = ks.launches
    x = ks.spd_solve(a, b)
    torch.cuda.synchronize()
    assert ks.launches == before + 1
    assert torch.equal(x.view(torch.int32), ks.spd_solve_plain(a, b).view(torch.int32))


@pytest.mark.cuda
def test_spd_gate_beyond_shared_memory(cuda_device):
    """Beyond the gate the kernel refuses, and the Qeq solve takes the
    Cholesky path without a launch."""
    from gcnn_keras_tpu_torch.layers.conv.qeq_solver import solve_qeq_dense_cholesky
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    m = ks.max_kernel_m(2) + 1
    a, b = _random_spd(2, m, 2, 0, cuda_device)
    with pytest.raises(ValueError, match="shared"):
        ks.spd_solve(a, b)
    mask = torch.ones(2, m, device=cuda_device)
    qtot = torch.tensor([0.0, 1.0], device=cuda_device)
    corner = torch.zeros(2, device=cuda_device)
    before = ks.launches
    q = solve_qeq_dense_cholesky(a, mask, b[..., 0], qtot, corner)
    torch.cuda.synchronize()
    assert ks.launches == before
    ref = solve_qeq_dense_cholesky(a.cpu(), mask.cpu(), b[..., 0].cpu(), qtot.cpu(),
                                   corner.cpu())
    assert (q.cpu() - ref).abs().max().item() <= 1e-4 * (1 + ref.abs().max().item())
    assert (q.sum(1) - qtot).abs().max().item() <= 1e-4 * (1 + q.abs().sum().item())


@pytest.mark.cuda
def test_spd_gradients_on_the_card_match_the_cpu(cuda_device):
    """First and second derivatives of sum(sin(x)) through a symmetric A(p):
    each backward is a kernel launch on the card."""
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    a0, b0 = _random_spd(16, 20, 2, 3, "cpu")
    p0 = 0.05 * torch.randn(16, 20, 20, generator=torch.Generator().manual_seed(4))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        p = p0.to(dev).requires_grad_(True)
        b = b0.to(dev).requires_grad_(True)
        before = ks.launches
        x = ks.SPDSolve.apply(a0.to(dev) + p + p.transpose(1, 2), b)
        gp, gb = torch.autograd.grad(torch.sin(x).sum(), (p, b), create_graph=True)
        (hp,) = torch.autograd.grad((gp ** 2).sum() + (gb ** 2).sum(), p)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ks.launches - before >= 4
        results.append([t.detach().cpu() for t in (x, gp, gb, hp)])
    for k, c in zip(*results):
        assert (k - c).abs().max().item() <= 1e-4 * (1 + c.abs().max().item())


@pytest.mark.cuda
def test_hdnnp4th_serving_on_the_card_matches_the_cpu(cuda_device):
    import functools
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.models.hdnnp4th import make_model_behler
    from gcnn_keras_tpu_torch.moldyn.base import MolDynamicsModelPredictor
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    mlp = {"units": [64, 64, 1], "num_relations": 10,
           "activation": ["swish", "swish", "linear"]}
    kw = dict(g2_kwargs=dict(G2_KW, elements=ACSF_ELEMENTS),
              g4_kwargs=dict(G4_KW, elements=ACSF_ELEMENTS),
              mlp_charge_kwargs=mlp, mlp_local_kwargs=mlp,
              electrostatic_kwargs={"param_trainable": False})
    rs = np.random.RandomState(5)
    frames = []
    for i, g in enumerate(_acsf_graphs(4, 16)):
        n = len(g["node_number"])
        frames.append({"node_number": g["node_number"],
                       "node_coordinates": g["node_coordinates"],
                       "edge_indices": g["edge_indices"],
                       "esp": (rs.randn(n) * 0.02).astype(np.float32),
                       "esp_grad": (rs.randn(n, 3) * 0.02).astype(np.float32),
                       "total_charge": np.array([float(i % 3 - 1)], np.float32)})
    pre = [functools.partial(set_angle, range_indices="edge_indices")]
    expected = {"g2_fwd": 1, "g4_fwd": 1, "g4_vjp": 1, "g2_vjp": 1, "g4_jvp": 0,
                "g2_jvp": 0, "sorted_segment_sum": 5, "spd_solve": 2}
    answers = []
    for dev in (cuda_device, torch.device("cpu")):
        def counts():
            return dict(ka.launches, sorted_segment_sum=kseg.launches, spd_solve=ks.launches)
        before = counts()
        model = make_model_behler(device=dev, **kw)
        answers.append(MolDynamicsModelPredictor(
            EnergyForceModel(model, use_esp_coupling=True, device=dev),
            graph_preprocessors=pre, device=dev)(frames))
        launched = {k: v - before[k] for k, v in counts().items()}
        assert launched == (expected if dev.type == "cuda" else dict.fromkeys(expected, 0))
    gpu, cpu = answers
    for key in ("energy", "force", "charge"):
        a = np.concatenate([r[key] for r in gpu])
        b = np.concatenate([r[key] for r in cpu])
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
    for r, f in zip(gpu, frames):
        assert abs(r["charge"].sum() - f["total_charge"][0]) <= 1e-4 * (
            1 + np.abs(r["charge"]).sum())


# ------------------------------------------------------------ SchNet MD kernels


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather_mul_segsum", "fused_cfconv"])
def test_md_kernels_match_plain_at_the_edge_cases(cuda_device, kernel):
    """Each kernel against its plain version at ``chip_smoke.py`` phase 11's
    edge cases (no edges, rows without edges, F or U 3 and 200, one edge,
    padding edges), one launch each (with no edges it writes the zero rows)."""
    import chip_smoke
    before = chip_smoke.kernel_counts()[kernel]
    cases = {"gather_mul_segsum": chip_smoke.gms_edge_cases,
             "fused_cfconv": chip_smoke.cfconv_edge_cases}[kernel](cuda_device)
    assert chip_smoke.kernel_counts()[kernel] == before + len(cases)


@pytest.mark.cuda
def test_md_kernels_match_plain_at_the_serving_shapes(cuda_device):
    import chip_smoke
    from gcnn_keras_tpu_torch.models.schnet import make_model
    gpu = chip_smoke.make_predictor(cuda_device)
    _, batch = gpu.make_batch(chip_smoke.qm9_like_mols(0, 512))
    recs = chip_smoke.phase_schnet_kernels(batch, make_model(device=cuda_device))
    assert recs["gather_mul_segsum"][0]["bound_by"] == "bytes"
    assert recs["fused_cfconv"][0]["bound_by"] == "operations"
    # both also timed at the MD step's shape, where an MD step launches each 4 times
    for kernel in ("gather_mul_segsum", "fused_cfconv"):
        md = [r for r in recs[kernel] if r["case"].startswith("MD shape") and "ms" in r]
        assert len(md) == 1 and md[0]["N"] == 128


@pytest.mark.cuda
@pytest.mark.parametrize("u", [128, 200])
def test_fused_cfconv_matches_plain_at_the_serving_shape(cuda_device, u):
    """The tiled kernel (U 128) and the wide one (U 200) at the serving shape
    (E 54784 receiver-sorted edges onto 8192 rows, B 20), one launch each."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    n, e, b = 8192, 54784, 20
    _, ids = _sorted_case(u, e, n, 1)
    gen = torch.Generator(device=cuda_device).manual_seed(u)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=cuda_device) * scale
    before = fc.launches
    chip_smoke.check_fused_cfconv(
        torch.rand(e, b, generator=gen, device=cuda_device), rnd(e, u),
        torch.from_numpy(ids).to(cuda_device), n, rnd(b, u, scale=b ** -0.5),
        rnd(u, scale=0.1), rnd(u, u, scale=u ** -0.5), rnd(u, scale=0.1), f"U={u}", False)
    assert fc.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 128, 200])
def test_gms_matches_plain_past_the_staged_window(cuda_device, f):
    """The gms kernel against its plain version, one launch: 3000 rows, one
    of them 3000 edges long (past a block's staged window, so its sum reads
    the rest from device memory), senders 1000-2000 rows from their
    receivers."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    n, e, long_row = 3000, 9000, 3000
    rs = np.random.RandomState(f)
    recv = np.sort(np.concatenate([rs.randint(0, n, e - long_row), np.full(long_row, n // 2)]))
    send = (recv + 1000 + rs.randint(0, 1000, e)) % n
    recv, send = (torch.from_numpy(a.astype(np.int32)).to(cuda_device) for a in (recv, send))
    gen = torch.Generator(device=cuda_device).manual_seed(f)
    before = fa.launches
    chip_smoke.check_gms(torch.randn(n, f, generator=gen, device=cuda_device),
                         torch.randn(e, f, generator=gen, device=cuda_device), send, recv, n,
                         f"F={f}, a row of {long_row} edges", False)
    assert fa.launches == before + 1


@pytest.mark.cuda
def test_gms_second_order_pattern_on_the_card(cuda_device):
    import chip_smoke
    rec = chip_smoke.phase_gms_second_order()
    # the 4 forward applications; the backward runs on the segment-sum
    assert rec["launches"]["gather_mul_segsum"] == 4


@pytest.mark.cuda
def test_md_kernel_wrappers_reject_what_they_cannot_take(cuda_device):
    from gcnn_keras_tpu_torch.ops.cuda import fused_aggregate as fa
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    ids = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    x = torch.zeros(4, 3, device=cuda_device)
    with pytest.raises(TypeError):
        fa.fused_gather_mul_segsum_kernel(x.double(), torch.zeros(5, 3, device=cuda_device),
                                          ids, ids, 4)
    with pytest.raises(ValueError):
        fa.fused_gather_mul_segsum_kernel(x, torch.zeros(3, 5, device=cuda_device).t(),
                                          ids, ids, 4)
    import ctypes
    from gcnn_keras_tpu_torch.ops.cuda.build import load_library
    smem = load_library("fused_cfconv").gcnn_fused_cfconv_smem_bytes
    smem.restype = ctypes.c_longlong
    for b, u in ((20, 128), (20, 200), (8, 3), (20, 256)):  # the gate's formula is the source's
        assert smem(b, u) == fc.shared_memory_bytes(b, u)
    u = 256  # W2 alone is 256 KB: beyond a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        fc.fused_cfconv_kernel(torch.zeros(5, 20, device=cuda_device),
                               torch.zeros(5, u, device=cuda_device), ids, 4,
                               torch.zeros(20, u, device=cuda_device),
                               torch.zeros(u, device=cuda_device),
                               torch.zeros(u, u, device=cuda_device),
                               torch.zeros(u, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "accurate", "chain"])
def test_schnet_md_mode_serving_on_the_card_matches_the_cpu(cuda_device, mode):
    """Full-width SchNet in each MD mode, and with the fused chain, on 16
    molecules: the card against
    the CPU and against the unfused model on the card, with the launches
    per evaluation of ``chip_smoke.schnet_launches``."""
    import chip_smoke
    frames = chip_smoke.qm9_like_mols(9, 16)
    answers = {}
    for key, dev, m in (("gpu", "cuda", mode), ("cpu", "cpu", mode), ("unfused", "cuda", "unfused")):
        before = chip_smoke.kernel_counts()
        answers[key] = chip_smoke.make_predictor(dev, m)(frames)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
        assert launched == (chip_smoke.schnet_launches(m) if dev == "cuda"
                            else chip_smoke.launch_counts())
    chip_smoke.compare_answers(answers["gpu"], answers["cpu"])
    chip_smoke.compare_answers(answers["gpu"], answers["unfused"])


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["bf16", "dense", "remat"])
def test_schnet_option_serving_on_the_card_matches_the_cpu(cuda_device, option):
    """Full-width SchNet in bfloat16, in the dense block and under remat, on
    64 molecules: the card against the CPU and against the float32 unfused
    model on the card (bfloat16 within ``BF16_TOL``), with the launches
    per evaluation of ``SCHNET_OPTION_LAUNCHES``; a bfloat16 CUDA tensor
    reaches the bfloat16 kernel, never its plain version."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import segment_sum as ss
    frames = chip_smoke.qm9_like_mols(0, 64)
    plain, plain_calls = ss.segment_sum_plain, []
    ss.segment_sum_plain = lambda *a: plain_calls.append(a[0].device) or plain(*a)
    try:
        answers = {}
        for key, dev in (("gpu", "cuda"), ("cpu", "cpu")):
            before = chip_smoke.kernel_counts()
            answers[key] = chip_smoke.make_option_predictor(option, dev)(frames)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
            assert launched == (chip_smoke.SCHNET_OPTION_LAUNCHES[option] if dev == "cuda"
                                else chip_smoke.launch_counts())
    finally:
        ss.segment_sum_plain = plain
    assert all(d.type == "cpu" for d in plain_calls)
    answers["unfused"] = chip_smoke.make_predictor("cuda")(frames)
    tol = chip_smoke.option_tol(option)
    chip_smoke.check_request(answers["gpu"], frames, option)
    chip_smoke.compare_answers(answers["gpu"], answers["cpu"], tol=tol)
    chip_smoke.compare_answers(answers["gpu"], answers["unfused"], tol=tol)


@pytest.mark.cuda
def test_wacsf_serving_on_the_card_matches_the_cpu(cuda_device):
    """HDNNP2nd's default (wACSF) model on 16 molecules: the card against
    the CPU, with ``WACSF_LAUNCHES`` a request."""
    import chip_smoke
    frames = chip_smoke.qm9_like_mols(9, 16)
    answers = {}
    for dev in ("cuda", "cpu"):
        before = chip_smoke.kernel_counts()
        answers[dev] = chip_smoke.make_wacsf_predictor(dev)(frames)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
        assert launched == (chip_smoke.WACSF_LAUNCHES if dev == "cuda"
                            else chip_smoke.launch_counts())
    chip_smoke.check_request(answers["cuda"], frames, "wacsf")
    chip_smoke.compare_answers(answers["cuda"], answers["cpu"])


@pytest.mark.cuda
def test_option_phase_parts_on_the_card(cuda_device):
    """Phase 21's multistate evaluation on 16 molecules and PAiNN MD at a few
    steps and 4 replicas, on the card against the CPU."""
    import chip_smoke
    from gcnn_keras_tpu_torch.batch import batch_graphs
    batch = batch_graphs(chip_smoke.qm9_like_mols(0, 16), device="cuda")
    assert chip_smoke.phase_multistate(batch, "card") == chip_smoke.MULTISTATE_LAUNCHES
    paths, recs = chip_smoke.phase_painn_md("card", steps=(4, 8), pairs=1, replicas=4,
                                            segment_steps=4, segments=1)
    assert paths["painn_md_ensemble"]["sorted_segment_sum"] == 5 * chip_smoke.PAINN_LAUNCHES[
        "sorted_segment_sum"]


@pytest.mark.cuda
def test_painn_serving_on_the_card_matches_the_cpu(cuda_device):
    """The bench-width PAiNN on 16 molecules: the card against the CPU, with
    the segment-sum launches per evaluation of ``chip_smoke.PAINN_LAUNCHES``."""
    import chip_smoke
    frames = chip_smoke.qm9_like_mols(9, 16)
    answers = {}
    for dev in ("cuda", "cpu"):
        before = chip_smoke.kernel_counts()
        answers[dev] = chip_smoke.make_painn_predictor(dev)(frames)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
        assert launched == (chip_smoke.PAINN_LAUNCHES if dev == "cuda"
                            else chip_smoke.launch_counts())
    chip_smoke.check_request(answers["cuda"], frames, "painn")
    chip_smoke.compare_answers(answers["cuda"], answers["cpu"])


# ------------------------------------------------ the fused interaction chain


def _chain_case(n, e, u, b, seed, dev, window=40, masked=0.1):
    """Receiver-sorted edges with senders within ``window`` rows, a share
    ``masked`` of them masked, and the inputs of ``chip_smoke.chain_inputs``."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    rs = np.random.RandomState(seed)
    recv = np.sort(rs.randint(0, n, e))
    send = np.clip(recv + rs.randint(-window, window + 1, e), 0, n - 1)
    edges = tuple(torch.from_numpy(a).to(dev) for a in (
        send.astype(np.int32), recv.astype(np.int32), rs.rand(e) >= masked))
    st = fi.CFStatic(bins=b, distance_max=4.0, offset=0.0, sigma=0.4, units=u)
    return chip_smoke.chain_inputs(n, u, b, seed, dev), edges, st


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,u,b,masked", [(150, 600, 16, 8, 0.1), (8192, 54784, 128, 20, 0.1),
                                             (8192, 54784, 128, 20, 0.0),
                                             (600, 3000, 136, 20, 0.1)])
def test_chain_kernels_match_plain(cuda_device, n, e, u, b, masked):
    """The three fused-chain kernels against their plain versions, one
    launch each, within ``chip_smoke.check_chain``'s tolerances; at full
    width also with every edge real; at U 136 cf_fwd's and cf_hesjvp's wide
    kernels."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    (x, pos, weights, ct, tangents), edges, st = _chain_case(n, e, u, b, n, cuda_device,
                                                             masked=masked)
    for name in fi.KERNELS:
        before = fi.launches[name]
        chip_smoke.check_chain(name, chip_smoke.chain_args(name, x, pos, weights, ct, tangents,
                                                           edges, st), f"N={n}", False)
        assert fi.launches[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,u,b", [(150, 600, 16, 8), (8192, 54784, 128, 20)])
@pytest.mark.parametrize("training", [True, False])
def test_hesjvp_variants_match_plain(cuda_device, n, e, u, b, training):
    """The second-reverse kernel as a force loss calls it (its weight
    tangents absent: the variant that leaves their terms out) and with every
    tangent, against its plain version, one launch each."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    (x, pos, weights, ct, tangents), edges, st = _chain_case(n, e, u, b, n + 1, cuda_device)
    before = fi.launches["cf_hesjvp"]
    rec = chip_smoke.check_chain("cf_hesjvp", chip_smoke.chain_args(
        "cf_hesjvp", x, pos, weights, ct, tangents, edges, st, training), f"N={n}", False)
    assert rec["weight_tangents"] is not training
    assert fi.launches["cf_hesjvp"] == before + 1


@pytest.mark.cuda
def test_chain_kernels_match_plain_at_the_edge_cases(cuda_device):
    """Each fused-chain kernel at ``chip_smoke.py`` phase 15's edge cases,
    one launch each."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    before = dict(fi.launches)
    recs = chip_smoke.chain_edge_case_checks(cuda_device)
    assert {k: v - before[k] for k, v in fi.launches.items()} == {
        k: len(recs[k]) for k in fi.KERNELS}


@pytest.mark.cuda
def test_chain_shared_memory_gate(cuda_device):
    """The gate's formula is the source's, and beyond it the wrapper raises."""
    import ctypes
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    from gcnn_keras_tpu_torch.ops.cuda.build import load_library
    smem = load_library("fused_interaction").gcnn_cf_smem_bytes
    smem.restype = ctypes.c_longlong
    for kind, name in enumerate(fi.KERNELS):
        for b, u in ((20, 128), (8, 3), (20, 148), (20, 200)):
            assert smem(kind, b, u) == fi.shared_memory_bytes(name, b, u)
    (x, pos, weights, ct, tangents), edges, st = _chain_case(40, 100, 200, 20, 0, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        fi.cf_hesjvp(x, pos, *weights, ct, *tangents, *edges, st)


@pytest.mark.cuda
def test_chain_third_derivative_raises_on_the_card(cuda_device):
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    (x, pos, weights, ct, _), edges, st = _chain_case(60, 200, 16, 8, 1, cuda_device)
    pos = pos.clone().requires_grad_(True)
    w1 = weights[0].clone().requires_grad_(True)
    y = fi.cfconv_fused_chain(x, pos, w1, *weights[1:], *edges, st)
    (g,) = torch.autograd.grad((y * ct).sum(), pos, create_graph=True)
    (h,) = torch.autograd.grad((g * g).sum(), w1, create_graph=True)
    with pytest.raises(RuntimeError, match="third derivative"):
        torch.autograd.grad(h.sum(), w1)


# A kernel that leaves NaN in every word of shared memory that a block can
# take, on every SM: the tiled kernels must read no word they did not write.
_NAN_FILL_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void fill_shared_nan(int n) {
  extern __shared__ float s[];
  volatile float* v = s;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = __int_as_float(0x7fc00000);
}
extern "C" int fill_shared_nan_on_every_sm(void* stream) {
  int dev, bytes, sms;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(fill_shared_nan, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  fill_shared_nan<<<4 * sms, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(bytes / 4);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.fixture(scope="module")
def fill_shared_nan(tmp_path_factory):
    """Fills each SM's shared memory with NaN on the current stream."""
    import ctypes
    import subprocess
    from gcnn_keras_tpu_torch.ops.cuda import build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = tmp_path_factory.mktemp("nan_fill")
    (d / "fill.cu").write_text(_NAN_FILL_SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "libfill.so"),
                    str(d / "fill.cu")], check=True, capture_output=True)
    fill = ctypes.CDLL(str(d / "libfill.so")).fill_shared_nan_on_every_sm
    fill.argtypes = [ctypes.c_void_p]

    def run():
        assert fill(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) == 0
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("u", [3, 40])
@pytest.mark.parametrize("kernel", ["fused_cfconv", "cf_fwd"])
def test_tiled_kernels_read_no_unwritten_shared_memory(cuda_device, fill_shared_nan, kernel, u):
    """The tiled fused cfconv and cf_fwd at U not a multiple of 32 (W2's
    rows padded in shared memory), launched once (which loads the kernel's
    module), then right after a kernel that left NaN in all of every SM's
    shared memory: finite, and within the kernel's tolerance of its plain
    version, both times."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import fused_cfconv as fc
    from gcnn_keras_tpu_torch.ops.cuda import fused_interaction as fi
    n, e, b = 300, 1500, 20
    if kernel == "cf_fwd":
        (x, pos, weights, ct, tangents), edges, st = _chain_case(n, e, u, b, u, cuda_device)
        args = chip_smoke.chain_args("cf_fwd", x, pos, weights, ct, tangents, edges, st)

        def check(label):
            chip_smoke.check_chain("cf_fwd", args, label, False)

        def count():
            return fi.launches["cf_fwd"]
    else:
        _, ids = _sorted_case(u, e, n, 1)
        gen = torch.Generator(device=cuda_device).manual_seed(u)

        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=cuda_device) * scale
        args = (torch.rand(e, b, generator=gen, device=cuda_device), rnd(e, u),
                torch.from_numpy(ids).to(cuda_device), n, rnd(b, u, scale=b ** -0.5),
                rnd(u, scale=0.1), rnd(u, u, scale=u ** -0.5), rnd(u, scale=0.1))

        def check(label):
            chip_smoke.check_fused_cfconv(*args, label, False)

        def count():
            return fc.launches
    before = count()
    check(f"U={u}")
    torch.cuda.synchronize()
    fill_shared_nan()
    check(f"U={u} after NaN")
    assert count() == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g4_fwd", "g4_jvp", "g4_vjp", "g2_fwd", "g2_vjp", "g2_jvp"])
def test_acsf_kernels_read_no_unwritten_shared_memory(cuda_device, fill_shared_nan, name):
    """The G4 and G2 kernels (set values and carried rows in shared memory;
    the vjp kernels' dpos window) on their edge
    batches (G2: ``chip_smoke.acsf_g2_edge_batch``), launched once, then
    right after a kernel that left NaN in all of every SM's shared memory:
    finite, and within the tolerance of their plain version, both times."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import acsf as ka
    g2, g4 = _acsf_layers()
    if name.startswith("g2"):
        args = chip_smoke.acsf_call_args(name, g2._static,
                                         chip_smoke.acsf_g2_edge_batch(cuda_device))
    else:
        args = chip_smoke.acsf_call_args(name, g4._static,
                                         chip_smoke.acsf_edge_batch(cuda_device))
    before = ka.launches[name]
    chip_smoke.check_acsf_call(name, args, "edge batch", False)
    torch.cuda.synchronize()
    fill_shared_nan()
    chip_smoke.check_acsf_call(name, args, "edge batch after NaN", False)
    assert ka.launches[name] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("m", [20, 32, 33, 239])
def test_spd_kernel_reads_no_unwritten_shared_memory(cuda_device, fill_shared_nan, m):
    """The warp kernel at M = 20 (K = 2: registers only) and at M = 32 (its
    second pass over the columns past 32 reads the first pass's steps from
    shared memory), and the block kernel at M = 33 and 239 ([A | B] in
    shared memory, the last rows a lane partly past M), launched once, then
    right after a kernel that left NaN in all of every SM's shared memory:
    within the tolerance of the plain version both times."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    a, b = _random_spd(64, m, 2, m, cuda_device)
    before = ks.launches
    chip_smoke.check_spd(a, b, f"M={m}", False)
    torch.cuda.synchronize()
    fill_shared_nan()
    chip_smoke.check_spd(a, b, f"M={m} after NaN", False)
    assert ks.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("other_g4_table", [False, True])
def test_g4_vjp_matches_plain_past_the_shared_window(cuda_device, other_g4_table):
    """A molecule whose angles join nodes further apart in id than the vjp
    kernel's shared window (the first block adds to dpos with global
    atomics), then small molecules (the later blocks, through the window)."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.ops.cuda.acsf import vjp_window
    import chip_smoke
    rs = np.random.RandomState(4)
    n = vjp_window() + 2
    graphs = ([set_angle(chip_smoke.wide_graph(n, rs), range_indices="edge_indices")]
              + _acsf_graphs(2, 8))
    b = batch_graphs(graphs, device=cuda_device)
    live = b.angles[b.angle_mask]
    assert (live.max() - live.min()).item() >= vjp_window()
    out = _acsf_check("g4_vjp", b, _acsf_static("g4_vjp", other_g4_table))
    assert out[2:n - 1].abs().max().item() == 0.0  # the atoms without neighbours
    assert out[[0, 1, n - 1]].abs().max().item() > 0.0


@pytest.mark.cuda
def test_g2_vjp_matches_plain_past_the_shared_window(cuda_device):
    """A molecule whose edges join nodes further apart in id than the G2 vjp
    kernel's shared window (the first block adds to dpos with global
    atomics), then small molecules (the later blocks, through the window)."""
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.graph.preprocess import set_angle
    from gcnn_keras_tpu_torch.ops.cuda.acsf import vjp_window
    import chip_smoke
    rs = np.random.RandomState(5)
    n = vjp_window() + 2
    graphs = ([set_angle(chip_smoke.wide_graph(n, rs), range_indices="edge_indices")]
              + _acsf_graphs(3, 8))
    b = batch_graphs(graphs, device=cuda_device)
    ends = torch.stack([b.senders, b.receivers])[:, b.edge_mask]
    assert (ends.max() - ends.min()).item() >= vjp_window()
    out = _acsf_check("g2_vjp", b, _acsf_static("g2_vjp", False))
    assert out[2:n - 1].abs().max().item() == 0.0  # the atoms without neighbours
    assert out[[0, 1, n - 1]].abs().max().item() > 0.0


# ------------------------------------------ HDNNP4th at molecule scale, ML/MM


def _qeq_system(m, n_real, seed):
    """A Qeq system of ``tests/test_qeq_solver.py``'s kind: ``m`` slots,
    ``n_real`` atoms of H, C and O in a 40-unit box, the CENT tables."""
    import math
    from gcnn_keras_tpu_torch.layers.conv.hdnnp_electro import CENT_HARDNESS, CENT_RADII
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=m)
    pos = (rs.rand(m, 3) * 40).astype(np.float32)
    mask = np.arange(m) < n_real
    chi = (rs.randn(m) * 0.1).astype(np.float32) * mask
    sigma = CENT_RADII[z]
    hard = np.where(mask, CENT_HARDNESS[z] + 1.0 / (sigma * math.sqrt(math.pi) + 1e-12), 1.0)
    return [torch.from_numpy(a) for a in (pos, sigma, hard.astype(np.float32), chi, mask)]


@pytest.mark.cuda
def test_iterative_qeq_on_the_card_matches_the_cpu(cuda_device):
    """The CG solve of a 1024-slot system (1000 atoms) and its position
    gradient on the card against the CPU; the charges sum to the total."""
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver as qs
    pos, sigma, hard, chi, mask = _qeq_system(1024, 1000, 0)
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        p = pos.to(dev).requires_grad_()
        q = qs.solve_qeq_iterative(p, sigma.to(dev), hard.to(dev), chi.to(dev), 1.0,
                                   mask.to(dev))
        (g,) = torch.autograd.grad(torch.sum(q ** 2), p)
        results.append((q.detach().cpu(), g.cpu()))
    (q, g), (q_ref, g_ref) = results
    assert (q - q_ref).abs().max().item() <= 5e-5
    assert abs(q.sum().item() - 1.0) < 1e-4
    assert (g - g_ref).abs().max().item() <= 1e-3 * g_ref.abs().max().item()


@pytest.mark.cuda
def test_iterative_training_step_on_the_card_matches_dense(cuda_device):
    """One 200-atom force-loss step with the iterative Qeq against the dense
    (SPD kernel) one on the card, same weights, to
    ``chip_smoke.CG_LOSS_RTOL``/``CG_GRAD_TOL``; 4 CG solves, no SPD."""
    import chip_smoke
    batch = chip_smoke.train_batch("hdnnp4th_mol200_train", 3, 200, "cuda")
    res = {}
    for solver in ("dense", "iterative"):
        model, trainer, state = chip_smoke.make_trainer("hdnnp4th_mol200_train", "cuda", solver)
        before = chip_smoke.kernel_counts()
        with chip_smoke.cg_rounds() as rounds:
            state, metrics = trainer.step_fn()(state, batch)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
        res[solver] = (metrics["loss"].item(), [p.grad for p in model.parameters()], launched,
                       rounds)
    (loss, grads, launched, rounds), (ref_loss, ref_grads, ref_launched, ref_rounds) = (
        res["iterative"], res["dense"])
    expected = chip_smoke.mol_launches(200, train=True)
    assert ref_launched == expected and ref_rounds == []
    assert launched == dict(expected, spd_solve=0)
    assert len(rounds) == chip_smoke.CG_SOLVES["train"] and max(rounds) < 2000
    assert abs(loss - ref_loss) <= chip_smoke.CG_LOSS_RTOL * abs(ref_loss)
    for g, ref in zip(grads, ref_grads):
        assert (g - ref).abs().max().item() <= chip_smoke.CG_GRAD_TOL * ref.abs().max().item()


@pytest.mark.cuda
def test_mol200_evaluation_spd_calls_give_the_plain_bits(cuda_device):
    """A 200-atom evaluation runs the SPD block kernel twice (the solve
    and its adjoint), each call giving the plain version's bits; energies,
    forces and charges against the CPU."""
    import chip_smoke
    from gcnn_keras_tpu_torch.ops.cuda import spd_solve as ks
    launches, recs = chip_smoke.phase_mol_serving(200, "test", "cuda")
    assert launches == chip_smoke.mol_launches(200) and launches["spd_solve"] == 2
    with chip_smoke.captured_calls() as calls:
        chip_smoke.energy_force_model("hdnnp4th_mol", "cuda").apply(
            chip_smoke.train_batch("hdnnp4th_mol200_train", 3, 200, "cuda"))
    assert len(calls["spd_solve"]) == 2
    for a, b in calls["spd_solve"]:
        assert a.shape[1] == 200
        x = ks.spd_solve(a, b)
        assert torch.equal(x.view(torch.int32), ks.spd_solve_plain(a, b).view(torch.int32))


@pytest.mark.cuda
def test_mlmm_on_the_card_matches_the_cpu(cuda_device):
    """``MLMMEnergyForceModel`` around the bench-width HDNNP4th on 16
    molecules with ESP: the card against the CPU, launches per evaluation
    of ``chip_smoke.MLMM_LAUNCHES``."""
    import chip_smoke
    frames = chip_smoke.with_esp(chip_smoke.qm9_like_mols(9, 16), 9)
    answers = {}
    for dev in ("cuda", "cpu"):
        before = chip_smoke.kernel_counts()
        answers[dev] = chip_smoke.make_mlmm_predictor(dev)(frames)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in chip_smoke.kernel_counts().items()}
        assert launched == (chip_smoke.MLMM_LAUNCHES if dev == "cuda"
                            else chip_smoke.launch_counts())
    chip_smoke.check_charged_request(answers["cuda"], frames, "mlmm")
    chip_smoke.compare_answers(answers["cuda"], answers["cpu"],
                               ("energy", "force", "charge", "qmmm_energy_correction"))


# the port's training scripts at their CONFIG widths on a few small folds
SCRIPT_TEST_CUTS = dict(epochs=2, synthetic_frames=48, batch_size=4, make_plots=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["force_schnet", "force_painn", "force_hdnnp2nd",
                                  "force_hdnnp4th", "energy_hdnnp4th", "charge_hdnnp4th"])
def test_script_phase_on_the_card(cuda_device, name):
    """``chip_smoke.py`` phase 19 for one script on 48 frames: its first
    step against the CPU, every kernel call of it against its plain
    version, the launches of every step (``SCRIPT_PATHS``' path), falling
    losses, the artifacts and the reloaded checkpoint; every kernel of the
    first step launched in the run."""
    import chip_smoke
    launches, recs = chip_smoke.phase_script(name, "test", "cuda", cuts=SCRIPT_TEST_CUTS)
    assert recs and all(launches[k] > 0 for k in recs)
    path = chip_smoke.SCRIPT_PATHS[name]
    if path:
        expected = chip_smoke.TRAIN_PATHS[path]["launches"]
        assert {k: len(r) for k, r in recs.items()} == {k: v for k, v in expected.items() if v}


@pytest.mark.cuda
def test_loader_on_the_card_yields_the_cpu_batches(cuda_device):
    """``GraphBatchLoader`` on the card: batches built in pinned host memory
    and copied without blocking equal the CPU loader's, epoch by epoch."""
    from gcnn_keras_tpu_torch.data.datasets.synthetic import SyntheticMDDataset
    from gcnn_keras_tpu_torch.data.loader import GraphBatchLoader, host_batch
    ds = SyntheticMDDataset(num_frames=40, seed=3)
    ds.map_list("set_range", max_distance=5.0, max_neighbours=8)
    ds.map_list("set_angle")
    for g in ds:
        g["edge_indices"] = g["range_indices"]
    hint = ds.batch_shape_hint(6)
    pinned = host_batch([dict(g) for g in ds[:6]], True, global_keys=("energy",), **hint)
    assert pinned.senders.is_pinned() and pinned.nodes["force"].is_pinned()
    loaders = {dev: GraphBatchLoader(list(ds), 6, seed=2, device=dev, global_keys=("energy",),
                                     **hint) for dev in ("cuda", "cpu")}
    for _ in range(2):
        for gb, cb in zip(*(list(loaders[d]) for d in ("cuda", "cpu"))):
            assert gb.senders.is_cuda
            for name in ("senders", "receivers", "node_mask", "angles"):
                assert torch.equal(getattr(gb, name).cpu(), getattr(cb, name))
            for k, v in cb.nodes.items():
                assert torch.equal(gb.nodes[k].cpu(), v), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["force_schnet", "force_painn", "force_hdnnp2nd",
                                  "force_hdnnp4th", "charge_hdnnp4th"])
def test_workflow_phase_on_the_card(cuda_device, name):
    """``chip_smoke.py`` phase 20 for one script on the ensemble phase 19
    trains on 48 frames: evaluate_models (launches, artifacts, each member
    and the report against the CPU, member 0's kernel calls against their
    plain versions), calc_prediction_std and load_model against the CPU,
    transfer_learning (frozen bit for bit, its first step against the
    CPU)."""
    import chip_smoke
    seen = {}
    chip_smoke.phase_script(name, "test", "cuda", cuts=SCRIPT_TEST_CUTS,
                            after=lambda cfg: seen.update(
                                out=chip_smoke.phase_workflow(name, cfg, "test", "cuda")))
    paths, recs = seen["out"]
    assert recs and sorted(paths) == [f"{name}_evaluate", f"{name}_transfer"]


@pytest.mark.cuda
def test_search_phase_on_the_card(cuda_device, tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 20's five searches on 40 frames."""
    import chip_smoke
    monkeypatch.chdir(tmp_path)
    paths, recs = chip_smoke.phase_searches("test", "cuda", frames=40)
    assert len(paths) == 5 and recs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["GIN", "GraphSAGE", "GAT", "GATv2", "RGCN", "GNNFilm",
                                  "INorp", "DMPNN", "CMPNN", "NMPN", "AttentiveFP", "HamNet",
                                  "MEGAN", "EGNN", "Megnet", "CGCNN", "DimeNetPP", "MXMNet",
                                  "CGCNN-crystal", "Megnet-crystal", "DimeNetPP-crystal",
                                  "MAT", "Unet"])
def test_zoo_phase_on_the_card(cuda_device, name):
    """``chip_smoke.py`` phase 22's (23's, 24's) checks of one model on 32
    molecules: the forward and first step against the CPU, every kernel call
    against its plain version, the launches of a forward and of every
    step."""
    import chip_smoke

    class Everything(set):
        def __contains__(self, item):
            return True
    paths, recs = chip_smoke.phase_zoo_model(name, "card test", Everything(), [],
                                             device="cuda", n_mols=32)
    fwd, step = chip_smoke.ZOO_LAUNCHES[name]
    assert paths[f"{name}_zoo_forward"]["sorted_segment_sum"] == fwd
    assert paths[f"{name}_zoo_train"]["sorted_segment_sum"] == chip_smoke.ZOO_STEPS * step
    assert len(recs) == fwd + step


@pytest.mark.cuda
@pytest.mark.parametrize("script,model", [("train_tudataset", "GIN"),
                                          ("train_moleculenet", "GAT"),
                                          ("train_moleculenet", "AttentiveFP")])
def test_zoo_driver_phase_on_the_card(cuda_device, script, model):
    import chip_smoke
    paths, recs = chip_smoke.phase_zoo_driver(script, model, "card test")
    assert len(recs["sorted_segment_sum"]) == chip_smoke.ZOO_LAUNCHES[model][1]
    assert paths[f"{script}_{model}"]["sorted_segment_sum"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["MXMNet", "EGNN"])
def test_force_driver_phase_on_the_card(cuda_device, model):
    """``chip_smoke.py`` phase 24's ``train_force`` run: the first step
    against the CPU, its kernel calls against their plain versions, every
    step's launches."""
    import chip_smoke
    paths, recs = chip_smoke.phase_zoo_driver("train_force", model, "card test")
    assert len(recs["sorted_segment_sum"]) == chip_smoke.ZOO_LAUNCHES[model][1]
    assert paths[f"train_force_{model}"]["sorted_segment_sum"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["Schnet", "PAiNN"])
def test_hyper_force_driver_phase_on_the_card(cuda_device, model):
    """``chip_smoke.py`` phase 25's ``train_force --hyper
    hyper_synthetic_md.py`` run at the config's widths: the first step
    against the CPU, its kernel calls against their plain versions, every
    step's launches."""
    import chip_smoke
    paths, recs = chip_smoke.phase_zoo_driver("train_force_hyper", model, "card test")
    assert len(recs["sorted_segment_sum"]) == {"Schnet": 19, "PAiNN": 25}[model]
    assert paths[f"train_force_hyper_{model}"]["sorted_segment_sum"] > 0


@pytest.mark.cuda
def test_compat_phase_on_the_card(cuda_device):
    """``chip_smoke.py`` phase 25's compatibility layer on 64 molecules:
    every output against the CPU, the segment-sum calls against their plain
    version, 3 launches a pass."""
    import chip_smoke
    paths, recs = chip_smoke.phase_compat("card test", set(), n_mols=64)
    assert paths["compat_pools"]["sorted_segment_sum"] == chip_smoke.COMPAT_LAUNCHES
    assert len(recs) == chip_smoke.COMPAT_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("order", range(7))
def test_spherical_bessel_gradients_finite_on_the_card(cuda_device, order):
    """``j_l`` and its first two derivatives at 1e-6 to 20 on the card: the
    CPU's values, and finite."""
    from gcnn_keras_tpu_torch.ops import polynom
    pts = torch.tensor([1e-6, 1e-3, 0.5, 1.0, 3.0, 7.0, 20.0])
    outs = []
    for dev in ("cpu", cuda_device):
        x = pts.to(dev).requires_grad_(True)
        y = polynom.spherical_bessel_jn_all(x, 7)[..., order]
        d1, = torch.autograd.grad(y.sum(), x, create_graph=True)
        d2, = torch.autograd.grad(d1.sum(), x)
        outs.append([t.detach().cpu() for t in (y, d1, d2)])
    for got, want in zip(*outs[::-1]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-5 * (1 + want.abs().max())
