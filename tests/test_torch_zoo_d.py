"""The port's padded-form models, MAT and the Graph U-Net, against the JAX
package on the CPU, and against the executed-kgcnn goldens.

As in ``tests/test_torch_zoo.py``: small graphs from a numpy seed, the JAX
``init`` variables perturbed by seeded noise and carried into the port by
``params_from_jax``; outputs within ``rtol=1e-5``, ``atol=1e-6`` of the
output's largest entry where that is above 1; a masked MAE's parameter
gradients within ``1e-5`` of each tensor's largest entry (by
``chip_smoke.check_grads``' float64 rules where not, as
``tests/test_torch_zoo_c.py``). The goldens take the recipes and tolerances
of ``tests/test_reference_parity.py`` (MAT 1e-4 / 2e-5, the Graph U-Net
2e-4 / 1e-4).
"""
import copy
import importlib
import os

import numpy as np
import pytest
import torch

import jax

from gcnn_keras_tpu.batch import batch_graphs as jbatch_graphs
from gcnn_keras_tpu.training import losses as jlosses
from gcnn_keras_tpu.training.hyper import HyperParameter as JHyperParameter
from gcnn_keras_tpu_torch.batch import batch_graphs
from gcnn_keras_tpu_torch.models import mat, registry, unet
from gcnn_keras_tpu_torch.training import losses
from gcnn_keras_tpu_torch.training.hyper import HyperParameter
from gcnn_keras_tpu_torch.utils.convert import params_from_jax
from tests.test_reference_parity import _apply_mapping, _load
from tests.test_torch_zoo import _close, _perturbed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER_DIR = os.path.join(ROOT, "training", "hyper")
GRAD_TOL = 1e-5


def _graphs(seed, n_graphs=6, node_features=None, edge="weights", coordinates=True):
    """``n_graphs`` random directed graphs of 3-10 nodes: integer node
    numbers below 20 (or ``node_features`` float columns), coordinates, a
    graph label and, by ``edge``: ``"weights"`` (E, 1) float edge weights,
    ``"classes"`` integer edge attributes below 5, an int for that many
    float edge-attribute columns, None for no edge values."""
    rs = np.random.RandomState(seed)
    graphs = []
    for _ in range(n_graphs):
        n = rs.randint(3, 11)
        pairs = rs.randint(0, n, size=(3 * n, 2))
        ei = np.unique(pairs[pairs[:, 0] != pairs[:, 1]], axis=0)
        m = len(ei)
        g = {"edge_indices": ei, "graph_labels": rs.randn(1).astype(np.float32)}
        if node_features is None:
            g["node_number"] = rs.randint(1, 20, size=n)
        else:
            g["node_attributes"] = rs.randn(n, node_features).astype(np.float32)
        if coordinates:
            g["node_coordinates"] = (rs.randn(n, 3) * 1.5).astype(np.float32)
        if edge == "weights":
            g["edge_weights"] = rs.rand(m, 1).astype(np.float32)
        elif edge == "classes":
            g["edge_attributes"] = rs.randint(0, 5, size=m)
        elif edge:
            g["edge_attributes"] = rs.randn(m, edge).astype(np.float32)
        graphs.append(g)
    return graphs


NODE16 = {"node": {"input_dim": 20, "output_dim": 16}, "edge": {"input_dim": 5, "output_dim": 8}}
MAT_SMALL = dict(depth=2, heads=3, embedding_units=16, input_embedding=NODE16,
                 attention_kwargs={"units": 4},
                 feed_forward_kwargs={"units": [16, 8], "activation": ["relu", "linear"]},
                 output_mlp={"units": [16, 1], "activation": ["relu", "linear"]})
UNET_SMALL = dict(depth=2, input_embedding=NODE16, hidden_dim={"units": 12},
                  output_mlp={"units": [8, 1], "activation": ["relu", "linear"],
                              "use_bias": [True, False]})

# name: (module, kwargs of both builders, the port's widths, graph keywords)
MODELS = {
    "MAT": ("mat", MAT_SMALL, dict(edge_in_features=1), {}),
    "MAT-add": ("mat", dict(MAT_SMALL, merge_heads="add"), dict(edge_in_features=1), {}),
    "MAT-softmax": ("mat", dict(MAT_SMALL, distance_matrix_kwargs={"trafo": "softmax"}),
                    dict(edge_in_features=1), {}),
    "MAT-no-coordinates": ("mat", MAT_SMALL, dict(edge_in_features=1),
                           dict(coordinates=False)),
    "MAT-identity": ("mat", dict(MAT_SMALL, attention_kwargs={
        "units": 4, "add_identity": True, "lambda_adjacency": 0.25}), {}, dict(edge=None)),
    "MAT-node": ("mat", dict(MAT_SMALL, output_embedding="node"), dict(edge_in_features=1), {}),
    "MAT-float": ("mat", MAT_SMALL, dict(in_features=5, edge_in_features=3),
                  dict(node_features=5, edge=3)),
    "Unet": ("unet", UNET_SMALL, {}, dict(edge="classes")),
    "Unet-no-reconnect": ("unet", dict(UNET_SMALL, use_reconnect=False), {},
                          dict(edge="classes")),
    "Unet-node": ("unet", dict(UNET_SMALL, output_embedding="node"), {}, dict(edge="classes")),
    "Unet-float": ("unet", dict(UNET_SMALL, top_k_args={"k": 0.4, "kernel_initializer":
                                                        "glorot_uniform"}),
                   dict(in_features=5, edge_in_features=2), dict(node_features=5, edge=2)),
    "Unet-no-edges": ("unet", dict(UNET_SMALL, depth=3), dict(edge_in_features=0),
                      dict(edge=None)),
}


def _case(name, seed=90, graphs=None):
    """The JAX model, its perturbed variables, the port model holding them
    and the two batches."""
    mod, kw, widths, gkw = MODELS[name]
    graphs = graphs or _graphs(seed, **gkw)
    keys = ("graph_labels",)
    jb = jbatch_graphs(graphs, global_keys=keys)
    tb = batch_graphs(graphs, global_keys=keys, device="cpu")
    jm = importlib.import_module(f"gcnn_keras_tpu.models.{mod}").make_model(**kw)
    variables = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jb), seed + 1)
    port = importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}")
    model = params_from_jax(port.make_model(device="cpu", **kw, **widths), variables)
    return jm, variables, model, jb, tb


def _node_output(name):
    return MODELS[name][1].get("output_embedding") == "node"


def _loss(name, out, b, pkg):
    """A masked graph MAE; for node outputs a masked node MAE against 0
    (MAT's node output is padded, ``(G, M, units)``: the mean of its
    absolute values)."""
    if not _node_output(name):
        return pkg.masked_graph_mae(out, b.globals["graph_labels"], b.globals["graph_mask"])
    if name.startswith("MAT"):
        return abs(out).mean()
    return pkg.masked_node_mae(out, out * 0, b.node_mask)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jm, variables, model, jb, tb = _case(name)
    out, ref = model(tb)["output"], jm.apply(variables, jb)["output"]
    assert torch.isfinite(out).all()
    _close(out, ref, 1e-5, 1e-6 * max(1.0, float(np.abs(np.asarray(ref)).max())))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_gradients_match_jax(name):
    """The loss and its gradients along every parameter against
    ``jax.value_and_grad``, by ``chip_smoke.check_grads`` against JAX's
    jitted gradients or, where they fail there, its eager ones. JAX's two
    float32 evaluations lie up to 10x apart in their distance from float64
    on MAT's 1x1 ``adj_proj`` kernel, a sum over every pair with some 26x
    cancellation (ROADMAP.md section 3), so neither alone is the reference's
    float32 noise."""
    import chip_smoke
    jm, variables, model, jb, tb = _case(name)

    def jloss(params):
        return _loss(name, jm.apply({**variables, "params": params}, jb)["output"], jb, jlosses)
    loss = _loss(name, model(tb)["output"], tb, losses)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    kw, widths = MODELS[name][1], MODELS[name][2]
    port = importlib.import_module(f"gcnn_keras_tpu_torch.models.{MODELS[name][0]}")

    def check(value_and_grad):
        ref_loss, ref_grads = value_and_grad(jloss)(variables["params"])
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        ref = {n: p.detach() for n, p in params_from_jax(
            port.make_model(device="cpu", **kw, **widths),
            {"params": jax.tree_util.tree_map(np.asarray, ref_grads)}).named_parameters()}
        for n, g in zip(names, grads):
            if g is None:
                assert not ref[n].any(), n
        chip_smoke.check_grads(
            f"{name} against JAX", {n: g for n, g in zip(names, grads) if g is not None}, ref,
            GRAD_TOL, lambda: chip_smoke.float64_grads(
                copy.deepcopy(model), lambda m, b: _loss(name, m(b)["output"], b, losses), tb))
    try:
        check(lambda f: jax.jit(jax.value_and_grad(f)))
    except AssertionError:
        check(jax.value_and_grad)


def _tie_graphs():
    """A star whose four leaves carry the same number and the same edges, so
    that their scores tie exactly at every gPool, beside random graphs."""
    star = {"node_number": np.array([6, 1, 1, 1, 1]),
            "edge_indices": np.array([[0, i] for i in range(1, 5)] + [[i, 0] for i in range(1, 5)]),
            "edge_attributes": np.full(8, 2), "graph_labels": np.ones(1, np.float32),
            "node_coordinates": np.zeros((5, 3), np.float32)}
    return [star] + _graphs(91, n_graphs=3, edge="classes")


def test_unet_breaks_a_planted_score_tie_by_slot_as_jax():
    """The star's four leaves tie: of the 2 nodes its first gPool removes
    (round(0.3 x 5), half to even), the tied leaves go lowest slot first;
    the output matches JAX's."""
    jm, variables, model, jb, tb = _case("Unet", graphs=_tie_graphs())
    out = model(tb)
    score, keep = out["score"][0, 0], out["keep"][0, 0]
    assert score[1] == score[2] == score[3] == score[4]
    leaves_kept = keep[1:5].tolist()
    removed = 4 - int(sum(leaves_kept))
    assert removed >= 1 and leaves_kept == [0.0] * removed + [1.0] * (4 - removed)
    _close(out["output"], jm.apply(variables, jb)["output"])


def test_unet_selection_imposed_reproduces_its_own():
    """``selection`` (chip_smoke.check_selection's lever) with the model's
    own keep masks gives its own answers; other masks give others."""
    _, _, model, _, tb = _case("Unet")
    out = model(tb)
    again = model(tb, selection=list(out["keep"]))
    assert torch.equal(again["output"], out["output"])
    flipped = model(tb, selection=[1 - k for k in out["keep"]])
    assert not torch.equal(flipped["output"], out["output"])


def test_unet_of_hyper_mutag_raises_when_built_as_jax_fails_at_its_first_call():
    """``hyper_mutag.py``'s Unet merges three output units with
    ``model_default``'s two biases: the JAX MLP asserts at the first call,
    the port raises ``ValueError`` when built."""
    path = os.path.join(HYPER_DIR, "hyper_mutag.py")
    jm = JHyperParameter(path, model_name="Unet").make_model()
    jb = jbatch_graphs(_graphs(92, edge="classes"))
    with pytest.raises(AssertionError, match="list length 2 != depth 3"):
        jm.init(jax.random.PRNGKey(0), jb)
    with pytest.raises(ValueError, match="use_bias"):
        HyperParameter(path, model_name="Unet").make_model(device="cpu")


def test_mat_keeps_its_use_bias_guard():
    """MAT's output MLP takes biases everywhere where the ``use_bias`` list
    is not as long as its units, as JAX's."""
    model = mat.make_model(device="cpu", output_mlp={"units": [8, 1],
                                                      "activation": ["relu", "linear"]})
    assert all(getattr(model.out_mlp, f"dense_{i}").bias is not None for i in range(2))


@pytest.mark.parametrize("name,kw,graphs", [
    ("mat", {}, dict(edge="weights")), ("mat", dict(in_features=4), dict(node_features=3)),
    ("unet", {}, dict(edge=None)), ("unet", dict(edge_in_features=0), dict(edge="classes"))])
def test_widths_at_build_are_checked(name, kw, graphs):
    model = importlib.import_module(f"gcnn_keras_tpu_torch.models.{name}").make_model(
        device="cpu", **kw)
    with pytest.raises(ValueError, match="in_features"):
        model(batch_graphs(_graphs(93, **graphs), device="cpu"))


def test_model_defaults_are_the_jax_ones():
    from gcnn_keras_tpu.models import mat as jmat
    from gcnn_keras_tpu.models import unet as junet
    for port, ref in ((mat, jmat), (unet, junet)):
        ours = {k: v for k, v in port.model_default.items() if not k.endswith("in_features")}
        assert ours == ref.model_default


@pytest.mark.parametrize("name", ["MAT", "Unet"])
def test_registry_builds_the_group(name):
    mod = {"MAT": mat, "Unet": unet}[name]
    assert registry.get_model_class(name) is mod.make_model
    assert registry.get_model_class(f"kgcnn.literature.{name}") is mod.make_model
    m = registry.make_model_by_name(name, config={"depth": 1}, device="cpu")
    assert sum(p.numel() for p in m.parameters()) > 0


def test_fresh_models_draw_from_a_torch_generator():
    for mod in (mat, unet):
        a, b = (dict(mod.make_model(device="cpu", generator=torch.Generator().manual_seed(s))
                     .named_parameters()) for s in (3, 3))
        c = dict(mod.make_model(device="cpu", generator=torch.Generator().manual_seed(4))
                 .named_parameters())
        assert all(torch.equal(a[n], b[n]) for n in a)
        assert any(not torch.equal(a[n], c[n]) for n in a)


# ------------------------------------------------------------- the goldens


def _mat_golden():
    graphs, weights, ref = _load("mat")
    for g in graphs:
        g.pop("z")
        g["node_coordinates"] = g.pop("xyz")
    mapping = ["proj/kernel", "ln1_0/scale", "ln1_0/bias", "adj_proj/kernel"]
    for i in range(2):
        if i > 0:
            mapping += [f"ln1_{i}/scale", f"ln1_{i}/bias"]
        for j in range(2):
            mapping += [f"att_{i}_{j}/dense_{x}/{leaf}" for x in "qkv"
                        for leaf in ("kernel", "bias")]
        mapping += [f"merge_{i}/kernel", f"ln2_{i}/scale", f"ln2_{i}/bias"]
        for k in range(3):
            mapping += [f"ff_{i}/dense_{k}/Dense_0/kernel", f"ff_{i}/dense_{k}/Dense_0/bias"]
        mapping += [f"ff_proj_{i}/kernel"]
    mapping += ["ln_out/scale", "ln_out/bias"]
    for k in range(3):
        mapping += [f"out_mlp/dense_{k}/Dense_0/kernel", f"out_mlp/dense_{k}/Dense_0/bias"]
    return graphs, weights, ref, "mat", dict(depth=2, heads=2), \
        dict(in_features=8, edge_in_features=1), mapping, (1e-4, 2e-5)


def _unet_golden():
    graphs, weights, ref = _load("unet")
    for g in graphs:
        g.pop("z", None)
        g.pop("xyz", None)
    mapping = ["proj/Dense_0/kernel", "proj/Dense_0/bias",
               "down_0/Dense_0/kernel", "down_0/Dense_0/bias", "topk_0_score",
               "down_1/Dense_0/kernel", "down_1/Dense_0/bias", "topk_1_score",
               "up_1/Dense_0/kernel", "up_1/Dense_0/bias",
               "up_0/Dense_0/kernel", "up_0/Dense_0/bias",
               "out_mlp/dense_0/Dense_0/kernel", "out_mlp/dense_0/Dense_0/bias",
               "out_mlp/dense_1/Dense_0/kernel"]
    return graphs, weights, ref, "unet", dict(depth=2), \
        dict(in_features=8, edge_in_features=1), mapping, (2e-4, 1e-4)


@pytest.mark.parametrize("recipe", [_mat_golden, _unet_golden], ids=["mat", "unet"])
def test_golden(recipe):
    """The reference's weights mapped into the JAX variables by the recipe
    of ``tests/test_reference_parity.py``, carried into the port; the port's
    graph outputs against the recorded ones."""
    graphs, weights, ref, mod, kw, widths, mapping, (rtol, atol) = recipe()
    jb = jbatch_graphs(graphs)
    jm = importlib.import_module(f"gcnn_keras_tpu.models.{mod}").make_model(**kw)
    variables = _apply_mapping(jm.init(jax.random.PRNGKey(0), jb), weights, mapping)
    model = params_from_jax(
        importlib.import_module(f"gcnn_keras_tpu_torch.models.{mod}").make_model(
            device="cpu", **kw, **widths), jax.tree_util.tree_map(np.asarray, variables))
    out = model(batch_graphs(graphs, device="cpu"))["output"].detach().numpy()[:len(graphs)]
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


# ------------------------------------------------ chip_smoke phase 25 on the CPU

from tests.test_torch_zoo_scripts import _Everything, counted_kernels  # noqa: E402,F401


@pytest.mark.parametrize("name", ["MAT", "Unet"])
def test_chip_smoke_phase_25_model_runs_on_the_cpu(name, counted_kernels):
    """Phase 25's checks of MAT (``hyper_esol.py``'s entry) and the Graph
    U-Net on 16 molecules: the forward (the U-Net's selections first) and
    first step against the CPU, no kernel launched (``ZOO_LAUNCHES``
    (0, 0)), falling losses."""
    cs = counted_kernels
    profiles = []
    paths, recs = cs.phase_zoo_model(name, "cpu", _Everything(), profiles, device="cpu",
                                     n_mols=16)
    assert cs.ZOO_LAUNCHES[name] == (0, 0) and cs.ZOO_MODELS[name][2] == 25
    assert paths[f"{name}_zoo_forward"] == cs.launch_counts()
    assert paths[f"{name}_zoo_train"] == cs.launch_counts()
    assert recs == [] and len(profiles) == 1


def test_phase_25_mat_is_the_hyper_esol_entry():
    """Phase 25's MAT: depth 5, 8 heads of 8, 64 units, output [64, 32, 1],
    built through the port's ``HyperParameter``."""
    import chip_smoke as cs
    model = cs.zoo_model("MAT", "cpu")
    cfg = model.config
    assert (cfg["depth"], cfg["heads"], cfg["embedding_units"]) == (5, 8, 64)
    assert cfg["attention_kwargs"]["units"] == 8
    assert cfg["output_mlp"]["units"] == [64, 32, 1]
    unet_cfg = cs.zoo_model("Unet", "cpu").config
    assert unet_cfg == {**unet.model_default}


def _selection_case():
    """The Graph U-Net of phase 25 on 32 molecules: the model, the batch and
    its CPU answers."""
    import chip_smoke as cs
    batch = cs.zoo_batch("Unet", "cpu", n_mols=32)
    model = cs.zoo_model("Unet", "cpu")
    with torch.no_grad():
        return model, batch, model(batch)


def test_check_selection_takes_a_near_tie_and_refuses_a_flip():
    """``chip_smoke.check_selection``: equal selections pass as they are; a
    selection that swaps two nodes at its cut whose scores the "card" has
    within its rounding passes with the CPU's selections imposed (answers
    equal to the CPU's); a swap of nodes far from each other raises."""
    import chip_smoke as cs
    model, batch, ref = _selection_case()
    outs, rec = cs.check_selection("Unet", model, batch, ref, ref)
    assert rec["nodes_differing"] == 0 and outs is ref
    keep, score = ref["keep"][0], ref["score"][0]
    cur = cs.flat_to_padded_mask(batch)
    g = next(g for g in range(batch.n_graphs)
             if (keep[g] > 0).any() and ((cur[g] > 0) & (keep[g] == 0)).any())
    kept = torch.nonzero(keep[g] > 0)[:, 0]
    gone = torch.nonzero((cur[g] > 0) & (keep[g] == 0))[:, 0]
    i = kept[score[g, kept].argmin()]
    j = gone[score[g, gone].argmax()]
    flipped = {k: v.clone() for k, v in ref.items()}
    flipped["keep"][0, g, i], flipped["keep"][0, g, j] = 0.0, 1.0
    # the "card's" scores: the two nodes within rounding of each other
    gap = float(score[g, i] - score[g, j])
    flipped["score"][0, g, j] = score[g, j] + gap / 2 + 1e-9
    flipped["score"][0, g, i] = score[g, i] - gap / 2
    outs, rec = cs.check_selection("Unet", model, batch, flipped, ref)
    assert rec["nodes_differing"] == 2 and rec["level"] == 0
    assert torch.equal(outs["output"], ref["output"]) and torch.equal(outs["keep"], ref["keep"])
    far = {k: v.clone() for k, v in ref.items()}
    far["keep"][0, g, kept[score[g, kept].argmax()]] = 0.0
    far["keep"][0, g, j] = 1.0
    with pytest.raises(AssertionError, match="beyond a near tie"):
        cs.check_selection("Unet", model, batch, far, ref)


def test_unet_first_cut_falls_on_exact_ties_on_phase_25_molecules():
    """On phase 25's 512 molecules the Graph U-Net's first gPool cuts 38
    graphs at an exact float32 tie between a kept and a removed node, whose
    float64 scores are equal too (nodes of one element with the same
    neighbours): which of them goes is the order of their last rounding,
    so another device's rounding can choose the other (ROADMAP.md section
    3). The float32 scores lie within 1.4e-8 of float64 (scale 0.11)."""
    import chip_smoke as cs
    batch = cs.zoo_batch("Unet", "cpu")
    model = cs.zoo_model("Unet", "cpu")
    with torch.no_grad():
        out = model(batch)
        out64 = copy.deepcopy(model).double()(batch._map(
            lambda v: v.double() if v.is_floating_point() else v))
    keep, score, score64 = out["keep"][0], out["score"][0], out64["score"][0]
    valid = cs.flat_to_padded_mask(batch)
    ties = 0
    for g in range(batch.n_graphs):
        kept, gone = keep[g] > 0, (valid[g] > 0) & (keep[g] == 0)
        if not (kept.any() and gone.any()):
            continue
        lo, hi = score[g][kept].min(), score[g][gone].max()
        if lo == hi:
            ties += 1
            tied = (score[g] == lo) & (valid[g] > 0)
            assert float(score64[g][tied].max() - score64[g][tied].min()) < 1e-15
    assert ties == 38
    assert float((score64 - score.double()).abs()[valid > 0].max()) < 2e-8
