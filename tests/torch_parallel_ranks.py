"""The rank side of ``tests/test_torch_parallel.py``.

``gcnn_keras_tpu_torch.parallel.launch.spawn`` runs :func:`run_checks` on
each of D gloo ranks on the CPU. It imports neither ``jax`` nor the JAX
package: the test module computes the JAX side, hands its weights (plain
numpy trees) and inputs over, and asserts on the numpy results returned.
"""
import functools

import numpy as np
import torch

SCHNET_KW = dict(depth=2, interaction_args={"units": 32},
                 gauss_args={"bins": 16, "distance_max": 1.0, "sigma": 0.1},
                 last_mlp={"units": [32, 16], "activation": ["shifted_softplus"] * 2},
                 output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]})
# JAX's MD default: the fused gather-multiply-sum, which a partitioned
# shard takes unfused
SCHNET_FUSED_KW = dict(SCHNET_KW, interaction_args={"units": 32, "fused_aggregate": True})
PAINN_KW = dict(depth=2, input_embedding={"node": {"input_dim": 95, "output_dim": 32}},
                conv_args={"units": 32, "cutoff": None, "conv_pool": "sum"},
                update_args={"units": 32},
                bessel_basis={"num_radial": 8, "cutoff": 1.0, "envelope_exponent": 5},
                output_mlp={"units": [32, 1], "activation": ["swish", "linear"]})
# tests/test_torch_training.py's narrow SchNet and HDNNP4th, with their
# bench losses: E + 100 F, and 50 q + E + 200 F with ESP coupling
_MLP = {"units": [16, 16, 1], "num_relations": 10, "activation": ["swish", "swish", "linear"]}
DP_SCHNET_KW = dict(depth=2, interaction_args={"units": 32},
                    gauss_args={"bins": 8, "distance_max": 4.0},
                    input_embedding={"node": {"input_dim": 95, "output_dim": 16}},
                    last_mlp={"units": [32, 16]}, output_mlp={"units": [16, 1]})
DP_WEIGHTS = {"schnet": (0.0, 100.0), "hdnnp4th": (50.0, 200.0)}
DP_KEYS = {"schnet": ("energy",), "hdnnp4th": ("energy", "total_charge")}
MD_KW = dict(depth=2, interaction_args={"units": 32},
             gauss_args={"bins": 16, "distance_max": 4.0, "sigma": 0.4},
             last_mlp={"units": [32, 16], "activation": ["shifted_softplus"] * 2},
             output_mlp={"units": [16, 1], "activation": ["shifted_softplus", "linear"]})


def dp_kw(kind):
    if kind == "schnet":
        return DP_SCHNET_KW
    import chip_smoke
    acsf = {k: chip_smoke.HDNNP2ND_KW[k] for k in ("g2_kwargs", "g4_kwargs")}
    return dict(acsf, mlp_charge_kwargs=_MLP, mlp_local_kwargs=_MLP,
                electrostatic_kwargs={"param_trainable": False})


def port_model(kind, tree):
    """The port's model of ``kind`` on the CPU holding the flax ``tree``."""
    from gcnn_keras_tpu_torch.models import hdnnp4th, painn, schnet
    from gcnn_keras_tpu_torch.utils.convert import params_from_jax
    make, kw = {"schnet": (schnet.make_model, SCHNET_KW), "painn": (painn.make_model, PAINN_KW),
                "schnet_fused": (schnet.make_model, SCHNET_FUSED_KW),
                "md_schnet": (schnet.make_model, MD_KW),
                "dp_schnet": (schnet.make_model, DP_SCHNET_KW),
                "dp_hdnnp4th": (hdnnp4th.make_model_behler, None)}[kind]
    return params_from_jax(make(device="cpu", **(kw or dp_kw("hdnnp4th"))), tree)


def _np(t):
    return t.detach().cpu().numpy()


def aggregate(mesh, part, sidx, halo):
    """This rank's halo and all-gather aggregates of ``part``'s features."""
    from gcnn_keras_tpu_torch.parallel.edge_partition import (make_halo_aggregate,
                                                              make_partitioned_aggregate)
    r = mesh.rank
    t = lambda a: torch.as_tensor(np.asarray(a[r]))  # noqa: E731
    feats = t(part.node_feats).requires_grad_(True)
    out_h = make_halo_aggregate(mesh, halo)(feats, t(sidx), t(part.receivers_local),
                                            t(part.edge_mask))
    out_a = make_partitioned_aggregate(mesh)(feats, t(part.senders_global),
                                             t(part.receivers_local), t(part.edge_mask))
    # both transposes: the gradient of sum(out * feats-independent weights)
    w = torch.linspace(-1.0, 1.0, out_h.numel()).reshape(out_h.shape)
    (g_h,) = torch.autograd.grad((out_h * w).sum(), feats)
    (g_a,) = torch.autograd.grad((out_a * w).sum(), feats)
    return {"halo": _np(out_h), "all_gather": _np(out_a), "grad_halo": _np(g_h),
            "grad_all_gather": _np(g_a)}


def partitioned(mesh, kind, tree, pin, f_target=None, e_target=-3.0, w_e=1.0, w_f=10.0):
    """Energy and forces (ORIGINAL order) of the partitioned model, and with
    ``f_target`` one SGD(1.0) step's gradients and loss."""
    from gcnn_keras_tpu_torch.parallel import partitioned as P
    model = port_model(kind, tree)
    e, f = P.run_partitioned_energy_force(model, pin, mesh)
    out = {"energy": e, "force": f}
    if f_target is not None:
        step = P.make_partitioned_train_step(model, mesh,
                                             functools.partial(torch.optim.SGD, lr=1.0),
                                             w_energy=w_e, w_force=w_f)
        state = step.init_state()
        before = [_np(p).copy() for p in state.params]
        f_ref = torch.as_tensor(P.shard_node_array(pin, f_target)[mesh.rank])
        state, metrics = step(state, P.rank_shard(pin, mesh), e_target, f_ref)
        out.update(grads=[b - _np(p) for b, p in zip(before, state.params)],
                   loss=float(metrics["loss"]))
    return out


def dp(mesh, kind, tree, graph_lists, pads, lr):
    """Two ``Trainer(mesh=...)`` SGD steps, rank r taking batch 2k + r of
    ``graph_lists``: each step's loss and the parameters after."""
    import chip_smoke
    from gcnn_keras_tpu_torch.batch import batch_graphs
    from gcnn_keras_tpu_torch.model.force import EnergyForceModel
    from gcnn_keras_tpu_torch.parallel.data_parallel import dp_batch_iterator, make_dp_eval_step
    from gcnn_keras_tpu_torch.parallel.mesh import shard_stacked_batch, stack_batches
    from gcnn_keras_tpu_torch.training import Trainer
    model = port_model(f"dp_{kind}", tree)
    if mesh.rank:  # replicas built apart start from rank 0's weights
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    wq, wf = DP_WEIGHTS[kind]
    fm = EnergyForceModel(model, use_esp_coupling=kind == "hdnnp4th", device="cpu")
    trainer = Trainer(chip_smoke.ef_loss_fn(fm, wf, wq),
                      functools.partial(torch.optim.SGD, lr=lr), mesh=mesh)
    state = trainer.init_state(model.parameters())
    batches = [batch_graphs(g, global_keys=DP_KEYS[kind], device="cpu", **pads)
               for g in graph_lists]
    if kind == "schnet":
        mine = list(dp_batch_iterator(batches, mesh))
    else:  # the JAX package's other route: stack D batches, take this rank's
        mine = [shard_stacked_batch(stack_batches(batches[i:i + mesh.size]), mesh)
                for i in range(0, len(batches), mesh.size)]
    losses = []
    for b in mine:
        state, metrics = trainer.step(state, b)
        losses.append(float(metrics["loss"]))
    energies = make_dp_eval_step(lambda b: {"energy": fm.apply(b)["energy"]}, mesh)(mine[0])
    return {"losses": losses, "params": [_np(p) for p in model.parameters()],
            "names": [n for n, _ in model.named_parameters()],
            "eval_gathered": _np(energies["energy"]),
            "eval_own": _np(fm.apply(mine[0])["energy"])}


def md(mesh, tree, systems, kw, n_segments):
    """``run_ensemble(n_devices=mesh.size)`` of ``systems``."""
    from gcnn_keras_tpu_torch.moldyn.trajectory import ScannedMD
    out = ScannedMD(port_model("md_schnet", tree), device="cpu", **kw).run_ensemble(
        systems, n_segments, n_devices=mesh.size)
    return {k: out[k] for k in ("e_pot", "e_kin", "pos", "edge_counts")}


def qeq(mesh, a, rhs):
    from gcnn_keras_tpu_torch.layers.conv.qeq_solver import solve_qeq_batch_sharded
    return _np(solve_qeq_batch_sharded(torch.as_tensor(a), torch.as_tensor(rhs), mesh))


JOBS = {"aggregate": aggregate, "partitioned": partitioned, "dp": dp, "md": md, "qeq": qeq}


def run_checks(mesh, spec):
    """Every job of ``spec`` (``{name: (job, kwargs)}``) on this rank, in
    order; returns ``{name: result}`` and the transport counts."""
    torch.manual_seed(0)
    out = {name: JOBS[job](mesh, **kw) for name, (job, kw) in spec.items()}
    out["transport"] = {k: dict(v) for k, v in mesh.transport.items()}
    out["rank"] = mesh.rank
    return out
