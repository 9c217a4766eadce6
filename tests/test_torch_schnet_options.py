"""SchNet's remaining options in the port against the JAX package, on the
CPU: ``dtype="bfloat16"`` (with the segment-sum's bfloat16 plain version),
``dense_block=True`` and ``remat=True``; and their launch counts as
``chip_smoke.py`` derives them.

Tolerances:
- float32 paths (dense block, remat): energies to ``rtol 1e-5, atol 1e-5 x
  max|reference|`` (``tests/test_torch_schnet.py``'s) and forces within
  ``1e-4`` of the largest reference value;
- bfloat16: ``chip_smoke.BF16_TOL``, one tolerance per key of the largest
  value (the graph pool's input per atom 0.27, energies 0.37, forces 0.14,
  a first step's loss 1.1e-3 and gradients 0.43), each twice the JAX
  package's own bfloat16-against-float32 gap for that key on the CPU on
  ``chip_smoke.py``'s SchNet weights, which
  ``test_jax_bf16_gap_is_what_bf16_tol_rests_on`` and
  ``test_jax_bf16_loss_gap_over_twenty_batches_is_what_the_loss_tol_rests_on``
  measure; a model with a force term or an interaction missing lies
  outside the force one;
- remat: a force loss's parameter gradients equal the plain step's bit for
  bit (the checkpoint recomputes the same operations in the same order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.graph import preprocess as jpre
from gcnn_keras_tpu.layers import dense_block as jdense
from gcnn_keras_tpu.model.force import EnergyForceModel as JEnergyForceModel
from gcnn_keras_tpu.models.schnet import make_model as jmake_model
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.layers import dense_block
from gcnn_keras_tpu_torch.layers.conv.schnet import SchNetInteractionDense
from gcnn_keras_tpu_torch.model.force import EnergyForceModel
from gcnn_keras_tpu_torch.models.schnet import make_model
from gcnn_keras_tpu_torch.ops.cuda import segment_sum as kseg
from gcnn_keras_tpu_torch.ops.cuda.segment_sum import GatherWithSortedTranspose, SortedSegmentSum
from gcnn_keras_tpu_torch.utils import convert
from gcnn_keras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

E_TOL, F_TOL = 1e-5, 1e-4
BF16_TOL = chip_smoke.BF16_TOL
SMALL = dict(depth=2, interaction_args={"units": 32},
             gauss_args={"bins": 8, "distance_max": 4.0},
             input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
             last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})
MODE_ARGS = {"unfused": {}, "fused": {"fused_aggregate": True},
             "accurate": {"accurate_cfconv": True}, "chain": {"fused_chain": True}}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _graphs(seed, n_mols):
    return [{k: v for k, v in g.items() if k != "force"}
            for g in chip_smoke.labelled_mols(seed, n_mols)]


def _batches(graphs):
    return (jbatch_graphs(graphs, global_keys=("energy",)),
            batch_graphs(graphs, global_keys=("energy",), device="cpu"))


def _shared(kw, jb, jax_kw=None, port_kw=None):
    """The JAX EnergyForceModel and the port's on one set of init weights;
    ``jax_kw``/``port_kw`` add options to one side only."""
    jm = JEnergyForceModel(jmake_model(**kw, **(jax_kw or {})))
    params = _tree(jax.jit(lambda k, b: jm.init(k, b))(jax.random.PRNGKey(1), jb))
    tm = params_from_jax(make_model(device="cpu", **kw, **(port_kw or {})), params)
    return jm, params, EnergyForceModel(tm, device="cpu")


def _energies(out, n_graphs):
    return out["energy"][:n_graphs]


def _energies_close(out, ref):
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, rtol=E_TOL, atol=E_TOL * np.abs(ref).max())


# ------------------------------------------------- the bfloat16 segment-sum


@pytest.mark.parametrize("f", [1, 3, 22, 128, 130])
def test_bf16_plain_sums_in_float32_and_rounds_once(f):
    """The bfloat16 plain version is the float32 sum of the values rounded
    to bfloat16 once (the kernel's semantics), with empty segments."""
    rs = np.random.RandomState(f)
    ids = np.sort(rs.choice([r for r in range(40) if r % 3], size=500)).astype(np.int32)
    vals = torch.from_numpy(rs.randn(500, f).astype(np.float32)).to(torch.bfloat16)
    out = kseg.segment_sum(vals, torch.from_numpy(ids), 41)
    ref = torch.zeros(41, f, dtype=torch.float64).index_add_(
        0, torch.from_numpy(ids).long(), vals.double())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)
    assert not out[::3].any()


def test_bf16_autograd_pair_keeps_its_type_to_any_order():
    """SortedSegmentSum and GatherWithSortedTranspose on bfloat16: each
    backward is the other, in bfloat16, at the second order too."""
    rs = np.random.RandomState(2)
    ids = torch.from_numpy(np.sort(rs.randint(0, 30, 400)).astype(np.int32))
    x = torch.from_numpy(rs.randn(400, 8).astype(np.float32)).to(torch.bfloat16)
    x.requires_grad_(True)
    out = SortedSegmentSum.apply(x, ids, 30)
    (g,) = torch.autograd.grad((out.float() ** 2).sum(), x, create_graph=True)
    assert out.dtype == g.dtype == torch.bfloat16
    (gg,) = torch.autograd.grad(g.float().sum(), x)
    assert gg.dtype == torch.bfloat16 and torch.isfinite(gg.float()).all()
    nodes = torch.randn(30, 4, dtype=torch.bfloat16, requires_grad=True)
    gathered = GatherWithSortedTranspose.apply(nodes, ids, None, ids)
    (gn,) = torch.autograd.grad(gathered.float().sum(), nodes)
    assert gn.dtype == torch.bfloat16
    torch.testing.assert_close(gn.float(), torch.bincount(ids.long(), minlength=30)
                               .float()[:, None].expand(30, 4), rtol=0, atol=0)


# --------------------------------------------------------- SchNet bfloat16


def _flax_tree(model):
    """The flax variables of a port model's weights (``params_from_jax``
    in reverse)."""
    tree = {}
    for key, tensor, transposed in convert._flax_leaves(model):
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        value = tensor.detach().numpy()
        node[leaf] = value.T if transposed else value
    return {"params": tree}


def _jax_pool_input(kw, params, jb):
    _, state = jmake_model(**kw).apply(params, jb, mutable=["intermediates"],
                                       capture_intermediates=lambda m, _: m.name == "last_mlp")
    return np.asarray(state["intermediates"]["last_mlp"]["__call__"][0])


def _faulty(model, fault):
    """``model`` with a fault the bfloat16 tolerance must refuse: its last
    interaction's filters cut from the geometry (a force term missing, the
    energies unchanged), or its last interaction skipped."""
    last = model.interaction_3
    if fault == "missing_force_term":
        last.register_forward_pre_hook(lambda m, args: (*args[:2], args[2].detach()))
    elif fault == "missing_interaction":
        last.register_forward_hook(lambda m, args, out: args[1])
    return model


def _port_run(model, tb):
    out = EnergyForceModel(model, device="cpu").apply(tb)
    return {"atom": chip_smoke.pool_input(model, tb).numpy(), "energy": _np(out["energy"]),
            "force": _np(out["force"])[tb.node_mask.numpy()]}


@pytest.fixture(scope="module")
def bf16_runs():
    """SchNet at the bench width with ``chip_smoke.py``'s weights (seed 0)
    in float32 and bfloat16, in JAX and in the port, and the port's
    bfloat16 model with each of ``_faulty``'s faults, on the first 64
    molecules of its first request: the graph pool's input on the real
    atoms (``atom``), the energies and the real atoms' forces; and
    (``jax_gaps``) JAX's bfloat16-against-float32 gap in each on the first
    64 molecules of each request (seeds 0-2)."""
    graphs = chip_smoke.qm9_like_mols(0, 64)
    jb, tb = jbatch_graphs(graphs), batch_graphs(graphs, device="cpu")
    g, mask = len(graphs), tb.node_mask.numpy()
    port_f32 = chip_smoke.schnet_model("unfused", "cpu")
    params = _flax_tree(port_f32)
    runs = {}
    for name, kw in (("jax_f32", {}), ("jax_bf16", {"dtype": "bfloat16"})):
        out = JEnergyForceModel(jmake_model(**kw)).apply(params, jb)
        runs[name] = {"atom": _jax_pool_input(kw, params, jb)[mask],
                      "energy": np.asarray(out["energy"]), "force": np.asarray(out["force"])[mask]}
    runs["port_f32"] = _port_run(port_f32, tb)
    runs["port_bf16"] = _port_run(chip_smoke.schnet_model("unfused", "cpu", dtype="bfloat16"), tb)
    for fault in ("missing_force_term", "missing_interaction"):
        runs[fault] = _port_run(_faulty(chip_smoke.schnet_model(
            "unfused", "cpu", dtype="bfloat16"), fault), tb)
    for run in runs.values():
        run["energy"] = run["energy"][:g]
    runs["jax_gaps"] = {key: [_rel(runs["jax_bf16"][key], runs["jax_f32"][key])]
                        for key in ("atom", "energy", "force")}
    for seed in (1, 2):
        graphs = chip_smoke.qm9_like_mols(seed, 64)
        jb = jbatch_graphs(graphs)
        mask = np.asarray(jb.node_mask)
        out = {}
        for name, kw in (("f32", {}), ("bf16", {"dtype": "bfloat16"})):
            res = JEnergyForceModel(jmake_model(**kw)).apply(params, jb)
            out[name] = {"atom": _jax_pool_input(kw, params, jb)[mask],
                         "energy": np.asarray(res["energy"])[:len(graphs)],
                         "force": np.asarray(res["force"])[mask]}
        for key, gaps in runs["jax_gaps"].items():
            gaps.append(_rel(out["bf16"][key], out["f32"][key]))
    return runs


@pytest.fixture(scope="module")
def bf16_steps():
    """The first training step's loss (``chip_smoke.ef_loss_fn``, force
    weight 100) and parameter gradients of SchNet at the bench width
    (``chip_smoke.py``'s weights) on the batch the script's first step
    takes, ``_mols(RandomState(2), 64)``: JAX in float32 and bfloat16, the
    port in bfloat16, and the port's loss over the first half of the
    molecules; and (``jax_grad_gaps``) JAX's bfloat16-against-float32
    gradient gap on that batch and on the card test's, ``(7, 16)``."""
    from gcnn_keras_tpu.training import losses as jlosses
    params = _flax_tree(chip_smoke.schnet_model("unfused", "cpu"))
    steps = {}
    for seed, size in ((7, 16), (2, 64)):  # the card test's batch, then the script's
        graphs = chip_smoke.labelled_mols(seed, size)
        jb = jbatch_graphs(graphs, global_keys=("energy",))
        for name, kw in (("jax_f32", {}), ("jax_bf16", {"dtype": "bfloat16"})):
            jm = JEnergyForceModel(jmake_model(**kw))

            def jloss(p):
                out = jm.apply(p, jb)
                return (jlosses.masked_graph_mae(out["energy"], jb.globals["energy"],
                                                 jb.globals["graph_mask"])
                        + 100.0 * jlosses.masked_node_mae(out["force"], jb.nodes["force"],
                                                          jb.node_mask))
            loss, grads = jax.value_and_grad(jloss)(params)
            named = params_from_jax(chip_smoke.schnet_model("unfused", "cpu"), _tree(grads))
            steps[name] = (float(loss), {n: t.detach() for n, t in named.named_parameters()})
        steps.setdefault("jax_grad_gaps", []).append(
            _worst_grad(steps["jax_bf16"][1], steps["jax_f32"][1]))
    tb = batch_graphs(graphs, global_keys=("energy",), device="cpu")
    model = chip_smoke.schnet_model("unfused", "cpu", dtype="bfloat16")
    loss_fn = chip_smoke.ef_loss_fn(EnergyForceModel(model, device="cpu"), 100.0)
    loss, _ = loss_fn(tb)
    names, tensors = zip(*model.named_parameters())
    steps["port_bf16"] = (loss.item(), dict(zip(names, torch.autograd.grad(loss, tensors))))
    half = batch_graphs(graphs[:len(graphs) // 2], global_keys=("energy",), device="cpu")
    steps["port_bf16_half_batch"] = loss_fn(half)[0].item()
    return steps


def _worst_grad(grads, ref):
    return max(_rel(grads[n], r) for n, r in ref.items())


def _padded_jax_batches(size, seeds):
    """The labelled batches ``_mols(RandomState(s), size)`` of ``seeds``,
    padded alike, so that one compiled loss takes them all."""
    lists = [chip_smoke.labelled_mols(s, size) for s in seeds]
    pads = dict(n_node_pad=max(sum(len(g["node_number"]) for g in gl) for gl in lists) + 1,
                n_edge_pad=max(sum(len(g["edge_indices"]) for g in gl) for gl in lists),
                n_graph_pad=size + 1, max_nodes=max(len(g["node_number"]) for gl in lists
                                                    for g in gl))
    return [jbatch_graphs(gl, global_keys=("energy",), **pads) for gl in lists]


def jax_first_loss_gaps(sizes=(16, 64), seeds=range(10)):
    """JAX's own bfloat16-against-float32 gap in the first loss (force
    weight 100) of SchNet at the bench width with ``chip_smoke.py``'s
    weights, on the batches of ``seeds`` at each of ``sizes``."""
    from gcnn_keras_tpu.training import losses as jlosses
    params = _flax_tree(chip_smoke.schnet_model("unfused", "cpu"))
    losses = {}
    for name, kw in (("f32", {}), ("bf16", {"dtype": "bfloat16"})):
        jm = JEnergyForceModel(jmake_model(**kw))

        @jax.jit
        def loss(jb):
            out = jm.apply(params, jb)
            return (jlosses.masked_graph_mae(out["energy"], jb.globals["energy"],
                                             jb.globals["graph_mask"])
                    + 100.0 * jlosses.masked_node_mae(out["force"], jb.nodes["force"],
                                                      jb.node_mask))
        losses[name] = np.array([float(loss(jb)) for size in sizes
                                 for jb in _padded_jax_batches(size, seeds)])
    return np.abs(losses["bf16"] - losses["f32"]) / np.abs(losses["f32"])


def test_jax_bf16_gap_is_what_bf16_tol_rests_on(bf16_runs, bf16_steps):
    """The JAX package's own bfloat16-against-float32 gap, per key: each
    ``BF16_TOL`` is twice its largest over the inputs ``chip_smoke.py``
    names, rounded up (the outputs on seeds 0-2; the gradients on the two
    first-step batches), so that largest lies within 10% under half the
    tolerance; the port's float32 model equals JAX's at float32 tolerances
    on the same inputs."""
    r = bf16_runs
    gaps = dict(r["jax_gaps"], grad=bf16_steps["jax_grad_gaps"])
    for key, seen in gaps.items():
        assert 0.9 * BF16_TOL[key] / 2 < max(seen) <= BF16_TOL[key] / 2, gaps
    _energies_close(r["port_f32"]["energy"], r["jax_f32"]["energy"])
    assert _rel(r["port_f32"]["force"], r["jax_f32"]["force"]) <= F_TOL


def test_jax_bf16_loss_gap_over_twenty_batches_is_what_the_loss_tol_rests_on():
    """The first loss is one number a batch, and JAX's own bfloat16 gap in it
    spreads over orders of magnitude from batch to batch: ``BF16_TOL["loss"]``
    is twice its largest over the batches of ten seeds at each of the two
    sizes the first-step checks take (16 and 64 molecules), rounded up."""
    gaps = jax_first_loss_gaps()
    assert gaps.shape == (20,)
    assert 0.9 * BF16_TOL["loss"] / 2 < gaps.max() <= BF16_TOL["loss"] / 2, gaps


@pytest.mark.parametrize("key", ["atom", "energy", "force"])
@pytest.mark.parametrize("against", ["jax_bf16", "port_f32"])
def test_bf16_schnet_matches_within_bf16_tol(bf16_runs, key, against):
    """The port's bfloat16 SchNet against the JAX bfloat16 one and against
    its own float32 model, within ``BF16_TOL[key]``: the graph pool's input
    per atom, the energies and the forces; its outputs are float32 (the
    readout and the geometry stay float32)."""
    assert _rel(bf16_runs["port_bf16"][key], bf16_runs[against][key]) <= BF16_TOL[key]


@pytest.mark.parametrize("key", ["atom", "energy", "force"])
def test_bf16_schnet_rounds_as_the_jax_bf16_model_does(bf16_runs, key):
    """The port's bfloat16 model is not its float32 one: it stands at least
    half the JAX package's own bfloat16 gap from float32 on every key. (The
    port's float32 model against JAX's bfloat16 one is that gap itself,
    within the tolerance: two bfloat16 runs that round in other places
    differ from each other as much as from float32, so no tolerance on
    these outputs refuses it.)"""
    r = bf16_runs
    assert _rel(r["port_bf16"][key], r["port_f32"][key]) >= \
        _rel(r["jax_bf16"][key], r["jax_f32"][key]) / 2


@pytest.mark.parametrize("fault", ["missing_force_term", "missing_interaction"])
def test_bf16_tol_refuses_a_faulty_model(bf16_runs, fault):
    """The port's bfloat16 model with its last interaction's filters cut
    from the geometry, or with that interaction skipped, lies outside
    ``BF16_TOL["force"]`` of the JAX bfloat16 forces."""
    assert _rel(bf16_runs[fault]["force"], bf16_runs["jax_bf16"]["force"]) > BF16_TOL["force"]


def test_bf16_training_step_matches_jax_within_bf16_tol(bf16_steps):
    """The port's bfloat16 first step against JAX's bfloat16 one: the loss
    within ``BF16_TOL["loss"]`` and each parameter's gradient within
    ``BF16_TOL["grad"]`` of its largest entry; the loss over half the
    molecules lies outside the loss's tolerance."""
    (loss, grads), (ref_loss, ref_grads) = bf16_steps["port_bf16"], bf16_steps["jax_bf16"]
    assert abs(loss - ref_loss) <= BF16_TOL["loss"] * abs(ref_loss)
    assert _worst_grad(grads, ref_grads) <= BF16_TOL["grad"]
    assert abs(bf16_steps["port_bf16_half_batch"] - ref_loss) > BF16_TOL["loss"] * abs(ref_loss)


def test_bf16_interactions_compute_in_bf16_and_add_back_in_float32(monkeypatch):
    """The messages' sums and the sender-gather transposes are bfloat16
    calls of the segment-sum; the graph pool and edge_vectors' transposes
    float32 (``chip_smoke.schnet_launches``); the residual stream float32."""
    graphs = _graphs(1, 3)
    _, tb = _batches(graphs)
    model = make_model(device="cpu", dtype="bfloat16", **SMALL)
    seen = []
    run = kseg.segment_sum

    def counted(values, ids, n):
        seen.append(values.dtype)
        return run(values, ids, n)
    monkeypatch.setattr(kseg, "segment_sum", counted)
    inter_out = []
    model.interaction_0.register_forward_hook(lambda m, i, o: inter_out.append(o.dtype))
    EnergyForceModel(model, device="cpu").apply(tb)
    want = chip_smoke.schnet_launches("unfused", depth=2, dtype="bfloat16")
    assert seen.count(torch.bfloat16) == want["sorted_segment_sum_bf16"] == 3
    assert seen.count(torch.float32) == want["sorted_segment_sum"] == 3
    assert inter_out == [torch.float32]


def test_bf16_fused_aggregate_takes_the_unfused_chain_as_jax():
    """As the JAX gate (float32 only) sends bfloat16 away from the gms
    kernel, the port's fused_aggregate runs the unfused chain in bfloat16:
    the same answers as the default bfloat16 model."""
    graphs = _graphs(2, 3)
    jb, tb = _batches(graphs)
    kw = dict(SMALL, interaction_args={**SMALL["interaction_args"], **MODE_ARGS["fused"]})
    jm, params, _ = _shared(kw, jb)
    jh = JEnergyForceModel(jmake_model(dtype="bfloat16", **kw))
    tm = params_from_jax(make_model(device="cpu", dtype="bfloat16", **kw), params)
    assert not tm.interaction_0.cfconv.fused_aggregate
    out = EnergyForceModel(tm, device="cpu").apply(tb)
    ref = jh.apply(params, jb)
    assert _rel(out["force"], ref["force"]) <= BF16_TOL["force"]
    plain = params_from_jax(make_model(device="cpu", dtype="bfloat16", **SMALL), params)
    same = EnergyForceModel(plain, device="cpu").apply(tb)
    assert torch.equal(out["force"], same["force"])


@pytest.mark.parametrize("mode", ["accurate", "chain"])
def test_bf16_with_a_float32_kernel_mode_raises(mode):
    kw = dict(SMALL, interaction_args={**SMALL["interaction_args"], **MODE_ARGS[mode]})
    with pytest.raises(ValueError, match="f32|float32"):
        make_model(device="cpu", dtype="bfloat16", **kw)


# ------------------------------------------------------------ dense block


def test_dense_adjacency_and_distances_match_jax():
    """The dense adjacency (multi-edges collapse to 1), the pair distances
    and their position gradient, the padded node mask."""
    graphs = _graphs(3, 3)
    g = graphs[0]
    g["edge_indices"] = np.concatenate([g["edge_indices"], g["edge_indices"][:3]])
    jb, tb = _batches(graphs)
    adj = dense_block.dense_adjacency(tb)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jdense.dense_adjacency(jb)))
    assert adj.max() == 1.0
    ref_d = jdense.dense_pair_distances(jb.nodes["node_coordinates"], jb,
                                        jdense.dense_adjacency(jb))
    proj = np.random.RandomState(4).randn(*ref_d.shape).astype(np.float32)
    ref_g = jax.grad(lambda p: jnp.sum(jdense.dense_pair_distances(
        p, jb, jdense.dense_adjacency(jb)) * proj))(jb.nodes["node_coordinates"])
    pos = tb.nodes["node_coordinates"].clone().requires_grad_(True)
    d = dense_block.dense_pair_distances(pos, tb, adj)
    (grad,) = torch.autograd.grad((d * torch.from_numpy(proj)).sum(), pos)
    assert _rel(d, ref_d) <= E_TOL and _rel(grad, ref_g) <= F_TOL
    np.testing.assert_array_equal(dense_block.padded_node_mask(tb).numpy(),
                                  np.asarray(jdense.padded_node_mask(jb)))


DENSE_CASES = {"graph-sum": {}, "mean-pools": dict(
    interaction_args={"units": 32, "cfconv_pool": "mean"},
    node_pooling_args={"pooling_method": "mean"}), "remat": dict(remat=True)}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_block_matches_jax_and_the_flat_path(case):
    """``dense_block=True`` against the JAX dense block, and against the
    port's flat path on the same weights (one parameter tree). Mean pools
    divide the energies by the atom counts, leaving them small against the
    terms they average: those are held to the forces' ``1e-4``."""
    graphs = _graphs(4, 3)
    jb, tb = _batches(graphs)
    kw = {**SMALL, **DENSE_CASES[case], "dense_block": True}
    jm, params, fm = _shared(kw, jb)
    assert isinstance(fm.energy_model.interaction_0, SchNetInteractionDense)
    ref = jm.apply(params, jb)
    out = fm.apply(tb)
    flat = EnergyForceModel(params_from_jax(make_model(
        device="cpu", **{**kw, "dense_block": False}), params), device="cpu").apply(tb)
    for other in (ref, flat):
        if case == "mean-pools":
            assert _rel(out["energy"][:3], _np(other["energy"])[:3]) <= F_TOL
        else:
            _energies_close(out["energy"][:3], _np(other["energy"])[:3])
        assert _rel(out["force"], other["force"]) <= F_TOL


def test_dense_block_node_output_matches_jax_and_the_flat_path():
    """Per-atom outputs (no sum over a molecule to average the rounding)
    within ``1e-4`` of the largest."""
    graphs = _graphs(5, 3)
    jb, tb = _batches(graphs)
    kw = dict(SMALL, output_embedding="node", dense_block=True)
    jmodel = jmake_model(**kw)
    params = _tree(jmodel.init(jax.random.PRNGKey(2), jb))
    out = params_from_jax(make_model(device="cpu", **kw), params)(tb)["output"]
    flat = params_from_jax(make_model(device="cpu", **{**kw, "dense_block": False}),
                           params)(tb)["output"]
    real = tb.node_mask.numpy()
    for other in (jmodel.apply(params, jb)["output"], flat):
        assert _rel(out[real], _np(other)[real]) <= F_TOL


@pytest.mark.parametrize("kw,match", [
    (dict(make_distance=False), "make_distance"),
    (dict(node_pooling_args={"pooling_method": "max"}), "pooling"),
    (dict(interaction_args={"units": 32, "cfconv_pool": "max"}), "cfconv_pool")])
def test_dense_block_refuses_what_it_cannot_run(kw, match):
    with pytest.raises(ValueError, match=match):
        make_model(device="cpu", dense_block=True, **{**SMALL, **kw})


def test_dense_block_refuses_a_periodic_batch():
    rs = np.random.RandomState(5)
    lat = np.eye(3, dtype=np.float32) * 3.5
    g = {"node_number": np.array([8, 14]), "node_coordinates": (rs.rand(2, 3) @ lat)
         .astype(np.float32), "graph_lattice": lat}
    g = jpre.set_range_periodic(g, max_distance=3.0, backend="numpy")
    g["edge_indices"] = g.pop("range_indices")
    tb = batch_graphs([g], device="cpu")
    with pytest.raises(ValueError, match="periodic"):
        make_model(device="cpu", dense_block=True, **SMALL)(tb)


# ------------------------------------------------------------------ remat


def _force_loss_grads(model, tb, force_weight=100.0):
    fm = EnergyForceModel(model, device="cpu")
    loss, _ = chip_smoke.ef_loss_fn(fm, force_weight)(tb)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("mode", ["unfused", "fused", "chain", "dense", "bf16"])
def test_remat_force_loss_gradients_equal_the_plain_step(mode):
    """A force loss's parameter gradients through the checkpointed
    interactions equal those without, bit for bit, in every interaction
    mode (the fused chain's Functions included)."""
    labelled = chip_smoke.labelled_mols(6, 3)
    tb = batch_graphs(labelled, global_keys=("energy",), device="cpu")
    kw = dict(SMALL, interaction_args={**SMALL["interaction_args"],
                                       **MODE_ARGS.get(mode, {})})
    if mode == "dense":
        kw["dense_block"] = True
    if mode == "bf16":
        kw["dtype"] = "bfloat16"
    plain_loss, plain = _force_loss_grads(make_model(device="cpu", **kw), tb)
    loss, grads = _force_loss_grads(make_model(device="cpu", remat=True, **kw), tb)
    assert loss.item() == plain_loss.item()
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)


def test_remat_matches_jax_and_accurate_stays_first_order():
    """remat=True against the JAX remat model; with accurate_cfconv the
    forces equal the plain ones and a force loss raises, as without."""
    graphs = _graphs(7, 3)
    jb, tb = _batches(graphs)
    jm, params, fm = _shared({**SMALL, "remat": True}, jb)
    ref = jm.apply(params, jb)
    out = fm.apply(tb)
    _energies_close(out["energy"][:3], np.asarray(ref["energy"])[:3])
    assert _rel(out["force"], ref["force"]) <= F_TOL
    kw = dict(SMALL, interaction_args={**SMALL["interaction_args"], "accurate_cfconv": True})
    acc = EnergyForceModel(make_model(device="cpu", remat=True, **kw), device="cpu")
    plain = EnergyForceModel(make_model(device="cpu", **kw), device="cpu")
    assert torch.equal(acc.apply(tb)["force"], plain.apply(tb)["force"])
    labelled = batch_graphs(chip_smoke.labelled_mols(7, 3), global_keys=("energy",),
                            device="cpu")
    with pytest.raises(RuntimeError, match="first-order only"):
        _force_loss_grads(acc.energy_model, labelled)


# ------------------------------------------- launches, as chip_smoke derives


def _counted(monkeypatch):
    """Count each kernel wrapper's calls as the card counts its launches
    (a bfloat16 segment-sum on its own instance's count)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name, (mod, attr, _) in chip_smoke.kernel_wrappers().items():
        def counted(*args, _run=getattr(mod, attr), _mod=mod, _name=name):
            if isinstance(_mod.launches, dict):
                _mod.launches[_name] += 1
            elif _name == "sorted_segment_sum" and args[0].dtype == torch.bfloat16:
                _mod.launches_bf16 += 1
            else:
                _mod.launches += 1
            return _run(*args)
        monkeypatch.setattr(mod, attr, counted)


@pytest.mark.parametrize("mode,extra", [
    ("unfused", {"remat": True}), ("fused", {"remat": True}), ("chain", {"remat": True}),
    ("accurate", {"remat": True}), ("unfused", {"dtype": "bfloat16"}),
    ("fused", {"dtype": "bfloat16", "remat": True}), ("unfused", {"dense_block": True})])
def test_launches_per_evaluation_are_the_derived_counts(mode, extra, monkeypatch):
    _counted(monkeypatch)
    _, tb = _batches(_graphs(8, 3))
    model = chip_smoke.schnet_model(mode, "cpu", **extra)
    chip_smoke.reset_counts()
    EnergyForceModel(model, device="cpu").apply(tb)
    want = launch = chip_smoke.launch_counts() if extra.get("dense_block") else \
        chip_smoke.schnet_launches(mode, remat=extra.get("remat", False),
                                   dtype=extra.get("dtype"))
    assert chip_smoke.kernel_counts() == want, launch


@pytest.mark.parametrize("path", [p for p, c in chip_smoke.TRAIN_PATHS.items()
                                  if c.get("phase") == 21])
def test_phase_21_training_paths_launch_the_derived_counts(path, monkeypatch):
    """One step of each phase-21 training path (its model, loss and Adam,
    on a small batch of its kind), every kernel call counted."""
    _counted(monkeypatch)
    _, trainer, state = chip_smoke.make_trainer(path, "cpu")
    batch = chip_smoke.train_batch(path, 2, 6, "cpu")
    chip_smoke.reset_counts()
    state, metrics = trainer.step_fn()(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert chip_smoke.kernel_counts() == chip_smoke.TRAIN_PATHS[path]["launches"]
