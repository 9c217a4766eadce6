"""The rank side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_partitioned_hdnnp.py``.

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
# tests/test_partitioned_model.py _hdnnp_model("auto"): the partitioned
# HDNNP4th, its CG to a relative residual of 1e-10
HDNNP_PART_KW = dict(
    g2_kwargs={"eta": [0.0, 0.3], "rs": [0.0, 2.5], "rc": 3.0, "elements": [1, 6, 8]},
    g4_kwargs={"eta": [0.0, 0.3], "lamda": [-1.0, 1.0], "rc": 3.0, "zeta": [1.0, 4.0],
               "elements": [1, 6, 8], "multiplicity": 2.0},
    mlp_charge_kwargs={"units": [16, 1], "num_relations": 6, "activation": ["swish", "linear"]},
    mlp_local_kwargs={"units": [16, 1], "num_relations": 6, "activation": ["swish", "linear"]},
    electrostatic_kwargs={"param_trainable": False, "solver": "auto", "cg_tol": 1e-10})
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
                "dp_hdnnp4th": (hdnnp4th.make_model_behler, None),
                "hdnnp_part": (hdnnp4th.make_model_behler, HDNNP_PART_KW)}[kind]
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


def _gathered(mesh, pin, t):
    """A per-node tensor of every rank's shard in the ORIGINAL node order."""
    from gcnn_keras_tpu_torch.parallel.collectives import all_gather_tiled
    from gcnn_keras_tpu_torch.parallel.partitioned import unshard_node_array
    full = _np(all_gather_tiled(t.detach(), mesh))
    return unshard_node_array(pin, full.reshape(pin.z.shape + full.shape[1:]))


def _kernel_launches():
    import chip_smoke
    return {k: v for k, v in chip_smoke.kernel_counts().items() if v}


def hdnnp(mesh, tree, pin, esp, e_target, f_target=None, q_target=None, steps=()):
    """The partitioned HDNNP4th on this rank's shard: the energy, every
    node's forces and charges (ORIGINAL order), and for each ``(name,
    w_e, w_f, w_q)`` of ``steps`` one SGD(1.0) step's gradients and
    metrics; the kernel wrappers' calls, the CG's rounds a solve."""
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver
    from gcnn_keras_tpu_torch.parallel import partitioned as P
    model = port_model("hdnnp_part", tree)
    shard = P.rank_shard(pin, mesh, node_props={"esp": esp},
                         global_props={"total_charge": np.zeros(1, np.float32)})
    solves0, rounds0 = qeq_solver.solves, qeq_solver.rounds
    e, f = P.make_partitioned_energy_force(model, mesh)(shard)
    with torch.no_grad():
        q = model(shard)["charge"]
    out = {"energy": float(e), "force": _gathered(mesh, pin, f), "charge": _gathered(mesh, pin, q),
           "cg_rounds_per_solve": (qeq_solver.rounds - rounds0)
           / max(qeq_solver.solves - solves0, 1)}
    n = len(pin.order)
    for name, w_e, w_f, w_q in steps:
        step = P.make_partitioned_train_step(model, mesh,
                                             functools.partial(torch.optim.SGD, lr=1.0),
                                             w_energy=w_e, w_force=w_f, w_charge=w_q)
        state = step.init_state()
        ft = np.zeros((n, 3), np.float32) if f_target is None else f_target
        f_ref = torch.as_tensor(P.shard_node_array(pin, ft)[mesh.rank])
        q_ref = (None if q_target is None
                 else torch.as_tensor(P.shard_node_array(pin, q_target)[mesh.rank]))
        grads, metrics, _ = step.grads(state, shard, e_target, f_ref, q_ref)
        out[name] = {"grads": [_np(g) for g in grads],
                     "metrics": {k: float(v) for k, v in metrics.items()}}
    out["launches"] = _kernel_launches()
    return out


def acsf_layers(element_pair_mapping=False):
    """The partitioned HDNNP4th's ACSF layers; ``element_pair_mapping``: G4
    with its default pairs given explicitly, which takes the layer's own
    plain route instead of the G4 kernel's plain version."""
    from gcnn_keras_tpu_torch.layers.conv.acsf import ACSFG2, ACSFG4
    g4 = ACSFG4.make_param_table(**HDNNP_PART_KW["g4_kwargs"])
    if element_pair_mapping:
        elems = np.sort(np.asarray(HDNNP_PART_KW["g4_kwargs"]["elements"]))
        g4["element_pair_mapping"] = [(a, b) for i, a in enumerate(elems) for b in elems[i:]]
    return ACSFG2(**ACSFG2.make_param_table(**HDNNP_PART_KW["g2_kwargs"])), ACSFG4(**g4)


def acsf(mesh, pin):
    """ACSFG2 and ACSFG4 (both plain routes) on this rank's shard, and the
    gradient of each against fixed weights along this rank's positions."""
    from gcnn_keras_tpu_torch.parallel import partitioned as P
    shard = P.rank_shard(pin, mesh)
    pos = shard.nodes["node_coordinates"].detach().requires_grad_(True)
    b = shard.replace_nodes(node_coordinates=pos)
    g2, g4 = acsf_layers()
    _, g4_pairs = acsf_layers(element_pair_mapping=True)
    out = {}
    for name, layer in (("g2", g2), ("g4", g4), ("g4_pairs", g4_pairs)):
        val = layer(b)
        w = torch.linspace(-1.0, 1.0, val.numel()).reshape(val.shape)
        (grad,) = torch.autograd.grad((val * w).sum(), pos)
        out[name], out[f"grad_{name}"] = _np(val), _np(grad)
    out["reasons"] = g4.kernel_reasons(shard)
    out["launches"] = _kernel_launches()
    return out


def qeq_rows(mesh, system, qtot, tol, derivs):
    """``solve_qeq_iterative_sharded`` of the float32 ``system`` (pos, sigma,
    diag, chi, mask), and on the float64 ``derivs`` system its first and
    second derivatives and its forward-mode tangent beside the
    single-device ``_CGSolve``'s (through ``solve_qeq_iterative``)."""
    from gcnn_keras_tpu_torch.layers.conv import qeq_solver as Q
    pos, sig, diag, chi, mask = (torch.as_tensor(a) for a in system)
    out = {"q": _np(Q.solve_qeq_iterative_sharded(pos, sig, diag, chi, qtot, mask, mesh,
                                                  tol=tol))}
    pos, sig, diag, chi, mask = (torch.as_tensor(a) for a in derivs)
    rs = np.random.RandomState(11)
    w = torch.as_tensor(rs.randn(len(chi)))
    v = torch.as_tensor(rs.randn(len(chi), 3))
    tangent = {k: torch.as_tensor(rs.randn(*t.shape)) for k, t in
               (("pos", pos), ("sigma", sig), ("diag", diag))}

    def derivatives(solve):
        inputs = [t.clone().requires_grad_(True) for t in (pos, sig, diag, chi)]
        q = solve(*inputs, 0.5, mask, tol=1e-13)
        g = torch.autograd.grad((q * w).sum(), inputs, create_graph=True)
        g2 = torch.autograd.grad((g[0] * v).sum(), inputs)
        return [_np(t) for t in (q, *g, *g2)]

    out["sharded"] = derivatives(lambda *a, **k: Q.solve_qeq_iterative_sharded(*a[:5], a[5],
                                                                              mesh, **k))
    out["single"] = derivatives(Q.solve_qeq_iterative)
    # the row solve's jvp along this rank's rows of the tangents
    import torch.autograd.forward_ad as fwad
    m_loc = len(chi) // mesh.size
    rows = slice(mesh.rank * m_loc, (mesh.rank + 1) * m_loc)
    maskf = mask.to(pos.dtype)
    b = torch.stack([chi * maskf, maskf], dim=-1)
    with fwad.dual_level():
        x = Q._RowsCGSolve.apply(b[rows], fwad.make_dual(pos[rows], tangent["pos"][rows]),
                                 fwad.make_dual(sig[rows], tangent["sigma"][rows]),
                                 fwad.make_dual(diag[rows], tangent["diag"][rows]),
                                 maskf[rows], mesh, 1e-13, 10 * len(chi))
        out["jvp_rows"] = _np(fwad.unpack_dual(x).tangent)
        x1 = Q._CGSolve.apply(b[None], fwad.make_dual(pos, tangent["pos"])[None],
                              fwad.make_dual(sig, tangent["sigma"])[None],
                              fwad.make_dual(diag, tangent["diag"])[None], mask[None], 128,
                              1e-13, 10 * len(chi))
        out["jvp_single"] = _np(fwad.unpack_dual(x1).tangent[0, rows])
    return out


JOBS = {"aggregate": aggregate, "partitioned": partitioned, "dp": dp, "md": md, "qeq": qeq,
        "hdnnp": hdnnp, "acsf": acsf, "qeq_rows": qeq_rows}


def run_checks(mesh, spec):
    """Every job of ``spec`` (``{name: (job, kwargs)}``) on this rank, in
    order; returns ``{name: result}`` and the transport counts."""
    torch.manual_seed(0)
    if any(job in ("hdnnp", "acsf") for job, _ in spec.values()):
        import chip_smoke
        chip_smoke.count_kernels_on_cpu()
    out = {name: JOBS[job](mesh, **kw) for name, (job, kw) in spec.items()}
    out["transport"] = {k: dict(v) for k, v in mesh.transport.items()}
    out["rank"] = mesh.rank
    return out
