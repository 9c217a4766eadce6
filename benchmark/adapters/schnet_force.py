"""SchNet energy+force: the port's model as ``scripts/force_schnet.py``
``build_model`` makes it for a user's run, with the configuration's
widths, and the shapes of the weights the benchmark draws for it."""
from __future__ import annotations

from benchmark.core.program import glorot


def weight_shapes(cfg: dict):
    """``(name, shape, limit)`` of every parameter, in the port's
    ``state_dict`` names: glorot limits for kernels and the embedding, 0.1
    for biases (drawn, not zero, so that the check sees them)."""
    m = cfg["model"]
    u, bins, out = m["units"], m["gauss_bins"], []

    def dense(name, fan_in, fan_out, bias=True):
        out.append((f"{name}.weight", (fan_out, fan_in), glorot(fan_in, fan_out)))
        if bias:
            out.append((f"{name}.bias", (fan_out,), 0.1))

    emb_in, emb_out = m["embedding_input_dim"], m["embedding_output_dim"]
    out.append(("embedding.weight", (emb_in, emb_out), glorot(emb_in, emb_out)))
    dense("embed_to_units", emb_out, u)
    for i in range(m["depth"]):
        dense(f"interaction_{i}.pre", u, u, bias=False)
        dense(f"interaction_{i}.cfconv.filter_1", bins, u)
        dense(f"interaction_{i}.cfconv.filter_2", u, u)
        dense(f"interaction_{i}.post_1", u, u)
        dense(f"interaction_{i}.post_2", u, u)
    fan = u
    for k, w in enumerate(m["last_mlp"]):
        dense(f"last_mlp.dense_{k}", fan, w)
        fan = w
    for k, w in enumerate(m["output_mlp"]):
        dense(f"output_mlp.dense_{k}", fan, w)
        fan = w
    return out


def build(cfg: dict, device):
    """The port's ``EnergyForceModel`` from the script's own ``build_model``; raises
    where the port's resulting model config departs from this file's."""
    from gcnn_keras_tpu_torch.scripts import force_schnet as script
    from gcnn_keras_tpu_torch.training.force_script import DEFAULTS
    m = cfg["model"]
    scfg = dict(DEFAULTS, **script.CONFIG)
    scfg["schnet"] = {"depth": m["depth"], "units": m["units"],
                      "gauss_bins": m["gauss_bins"], "gauss_distance": m["gauss_distance_max"]}
    fmodel = script.build_model(scfg, device=device)
    got = fmodel.energy_model.config
    want = {"gauss_args": {"bins": m["gauss_bins"], "distance_max": m["gauss_distance_max"],
                           "offset": m["gauss_offset"], "sigma": m["gauss_sigma"]},
            "depth": m["depth"],
            "input_embedding": {"node": {"input_dim": m["embedding_input_dim"],
                                         "output_dim": m["embedding_output_dim"]}}}
    for key, val in want.items():
        if got[key] != val:
            raise ValueError(f"the port built {key}={got[key]!r}, the configuration says {val!r}")
    inter = got["interaction_args"]
    if inter["units"] != m["units"] or inter["activation"] != m["activation"] \
            or any(inter.get(k) for k in ("fused_aggregate", "accurate_cfconv", "fused_chain")):
        raise ValueError(f"the port built interaction_args={inter!r}")
    return fmodel
