"""The fused SchNet interaction chain, closed to the second order that force
training needs; counterpart of ``gcnn_keras_tpu/ops/pallas/fused_interaction.py``.

For each receiver-sorted edge e = (i <- j) whose ``edge_mask`` is true:

    v = pos[j] - pos[i];  r = sqrt(max(|v|^2, 1e-12)), held at sqrt(1e-12)
                          (gradient 0) where |v|^2 <= 1e-12
    b_k = exp(-(r - offset - mu_k)^2 / (2 sigma^2)),  mu_k = k / bins * distance_max
    h = ssp(b @ W1 + b1),  F = h @ W2 + b2          (W1 (B, U), W2 (U, U), flax layout)
    y[i] += F * x[j]

Edges whose mask is false contribute nothing (the unfused path sums them
onto the dead node instead; real nodes agree). Three kernels
(``csrc/fused_interaction.cu``) replace the three TPU kernels:

- ``cf_fwd``    (``_cf_fwd``):    y(x, pos, W1, b1, W2, b2), (N, U);
- ``cf_vjp``    (``_cf_vjp``):    ct (N, U) -> the cotangents of x, pos and
  the four weights (the weights' summed over every edge);
- ``cf_hesjvp`` (``_cf_hesjvp``): (ct, u) -> J u (N, U) and the gradient of
  <ct, J(res) u> along res = (x, pos, W1, b1, W2, b2): the second reverse
  pass through the force pass.

:class:`CF` runs ``cf_fwd``; its backward is :class:`BWD`, which runs
``cf_vjp``; ``BWD``'s backward runs ``cf_hesjvp``. That is reverse over
reverse, the energy+force training traversal. A derivative of ``BWD``'s
backward (a third derivative) raises (:class:`SecondOrderOnly`); the chain
has no forward-mode rule, as in the JAX package.

The plain versions are one definition of the per-edge chain
(:func:`chain_plain`) with ``index_add_``, and ``torch.func`` over it for
the two derivative kernels, as the TPU kernels take theirs from
``jax.vjp``/``jax.jvp``/``jax.grad`` over ``_chain``. The CUDA kernels
write the derivatives out by hand (the header of the source has them).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``launches[name]`` counts each kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..activ import shifted_softplus
from .build import load_library

Tensor = torch.Tensor

KERNELS = ("cf_fwd", "cf_vjp", "cf_hesjvp")
launches = dict.fromkeys(KERNELS, 0)

EPS = 1e-12
SHARED_MEMORY_BYTES = 232448  # the dynamic shared memory a Hopper block may take
# kEdgesFwd, kEdgesTile, kEdges, kSlots and kMisc of csrc/fused_interaction.cu:
# edges per chunk of cf_fwd, cf_vjp and cf_hesjvp, float slots per edge, spare
# ints
_EDGES_FWD, _EDGES_VJP, _EDGES_BWD, _EDGE_SLOTS, _MISC_INTS = 16, 32, 8, 13, 4


class CFStatic(NamedTuple):
    """The chain's static configuration (the Gaussian basis and the width)."""
    bins: int
    distance_max: float
    offset: float
    sigma: float
    units: int

    @property
    def gamma(self) -> float:
        return -0.5 / (self.sigma * self.sigma)

    def shifts(self, dtype, device) -> Tensor:
        """``offset + mu_k`` per bin, rounded once from double as the JAX
        kernel's constants are."""
        return torch.tensor([self.offset + float(k) / float(self.bins) * self.distance_max
                             for k in range(self.bins)], dtype=dtype, device=device)


# ------------------------------------------------------------ plain versions

def chain_plain(st: CFStatic, pos_i: Tensor, pos_j: Tensor, xj: Tensor, w1: Tensor,
                b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """The per-edge chain of the module docstring, ``(E, 3), (E, 3), (E, U)
    -> (E, U)`` messages ``F * x[j]``."""
    v = pos_j - pos_i
    d2 = torch.sum(v * v, dim=-1, keepdim=True)
    d = torch.sqrt(d2.clamp_min(EPS))
    d = torch.where(d2 > EPS, d, torch.full_like(d, math.sqrt(EPS)))
    diff = d - st.shifts(d.dtype, d.device)
    basis = torch.exp(st.gamma * diff * diff)
    f = shifted_softplus(basis @ w1 + b1) @ w2 + b2
    return f * xj


def cf_fwd_plain(x: Tensor, pos: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
                 senders: Tensor, receivers: Tensor, edge_mask: Tensor,
                 st: CFStatic) -> Tensor:
    """Kernel #5's plain version: the chain, masked, and ``index_add``."""
    m = chain_plain(st, pos.index_select(0, receivers), pos.index_select(0, senders),
                    x.index_select(0, senders), w1, b1, w2, b2)
    m = m * edge_mask[:, None].to(m.dtype)
    return torch.zeros_like(x).index_add(0, receivers, m)


def cf_vjp_plain(x, pos, w1, b1, w2, b2, ct, senders, receivers, edge_mask, st):
    """Kernel #6's plain version: ``torch.func.vjp`` of :func:`cf_fwd_plain`
    along ``(x, pos, w1, b1, w2, b2)``, pulled back from ``ct``."""
    def fwd(*res):
        return cf_fwd_plain(*res, senders, receivers, edge_mask, st)
    _, pull = torch.func.vjp(fwd, x, pos, w1, b1, w2, b2)
    return pull(ct)


def cf_hesjvp_plain(x, pos, w1, b1, w2, b2, ct, u_x, u_pos, u_w1, u_b1, u_w2, u_b2,
                    senders, receivers, edge_mask, st):
    """Kernel #7's plain version: J u by ``torch.func.jvp`` of
    :func:`cf_fwd_plain` along ``u``, then the gradient of <ct, J u> along
    ``(x, pos, w1, b1, w2, b2)``. Returns ``(J u, w_x, w_pos, w_w1, w_b1,
    w_w2, w_b2)``."""
    u = (u_x, u_pos, u_w1, u_b1, u_w2, u_b2)

    def fwd(*res):
        return cf_fwd_plain(*res, senders, receivers, edge_mask, st)

    def inner(*res):
        ju = torch.func.jvp(fwd, res, u)[1]
        return torch.sum(ct * ju), ju

    grads, ju = torch.func.grad(inner, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
        x, pos, w1, b1, w2, b2)
    return (ju, *grads)


# ------------------------------------------------------------------ kernels

def shared_memory_bytes(kind: str, b: int, u: int) -> int:
    """What one block of kernel ``kind`` takes for B bins and U units
    (``gcnn_cf_smem_bytes`` in the source)."""
    if kind == "cf_fwd":
        # a chunk's hidden rows (U rounded up to 4), W2, W1, the Gaussian
        # centres, the chunk's basis rows and distances; 3 ints an edge
        e = _EDGES_FWD
        floats = e * ((u + 3) // 4 * 4) + u * u + b * u + b + e * b + e
        return 4 * (floats + 3 * e + _MISC_INTS)
    if kind == "cf_vjp":
        # W2 and W1 with U padded to a multiple of 32, the W1 sum, the
        # chunk's hidden, F-cotangent and z-cotangent rows, its basis rows,
        # the centres and per-edge scalars; 4 ints an edge (the W2 sum lives
        # in registers)
        e, p = _EDGES_VJP, (u + 31) // 32 * 32
        floats = p * p + 2 * b * p + 3 * e * p + e * b + b + _EDGE_SLOTS * e
        return 4 * (floats + 4 * e + _MISC_INTS)
    # cf_hesjvp: W2 with its rows padded to U + 1, its cotangent sum, the
    # centres, the chunk's basis rows and per-edge scalars, W1, u_W1 and the
    # W1 sum, hidden rows, their tangents and two cotangent rows an edge, two
    # block-sum scratch rows a warp; 4 ints an edge
    e, warps = _EDGES_BWD, (u + 31) // 32
    floats = (u * (u + 1) + u * u + b + e * b + _EDGE_SLOTS * e + 3 * b * u + 4 * e * u
              + 2 * warps * e)
    return 4 * (floats + 4 * e + _MISC_INTS)


def fits_shared_memory(b: int, u: int) -> bool:
    """Whether all three kernels take B bins and U units."""
    return all(shared_memory_bytes(k, b, u) <= SHARED_MEMORY_BYTES for k in KERNELS)


def _kernel(kind: str):
    """The C entry point of ``kind`` in ``csrc/fused_interaction.cu``, built
    on first use."""
    lib = load_library("fused_interaction")
    fn = getattr(lib, f"gcnn_{kind}_f32")
    n_ptr = {"cf_fwd": 10, "cf_vjp": 17, "cf_hesjvp": 25}[kind]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.c_double] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(kind, x, pos, weights, tensors, senders, receivers, edge_mask, st):
    """Shapes, types and devices the wrappers take; raises on anything else."""
    if x.dim() != 2 or pos.dim() != 2 or pos.shape != (x.shape[0], 3):
        raise ValueError(f"x must be (N, U) and pos (N, 3), got {tuple(x.shape)} "
                         f"and {tuple(pos.shape)}")
    n, u = x.shape
    if st.units != u:
        raise ValueError(f"x has {u} units, the chain {st.units}")
    b = st.bins
    for name, t, shape in zip(("w1", "b1", "w2", "b2"), weights,
                              ((b, u), (u,), (u, u), (u,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t, shape in tensors:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    e = senders.shape[0]
    for name, t in (("senders", senders), ("receivers", receivers), ("edge_mask", edge_mask)):
        if t.dim() != 1 or t.shape[0] != e:
            raise ValueError(f"{name} must be ({e},), got {tuple(t.shape)}")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32:
        raise TypeError(f"senders and receivers must be int32, got {senders.dtype} "
                        f"and {receivers.dtype}")
    if edge_mask.dtype != torch.bool:
        raise TypeError(f"edge_mask must be bool, got {edge_mask.dtype}")
    everything = [pos, *weights, *(t for _, t, _ in tensors), senders, receivers, edge_mask]
    for t in everything:
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but an input on {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused interaction-chain kernel for device {x.device}")
    if x.device.type == "cuda":
        floats = [x, pos, *weights, *(t for _, t, _ in tensors)]
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("the CUDA kernels take float32 tensors, got "
                            + ", ".join(str(t.dtype) for t in floats))
        need = shared_memory_bytes(kind, b, u)
        if need > SHARED_MEMORY_BYTES:
            raise ValueError(f"B={b}, U={u}: the {kind} kernel's block needs {need} bytes "
                             f"of shared memory, more than the {SHARED_MEMORY_BYTES} a "
                             "block has")


def _launch(kind, ins, outs, n, e, st):
    """Launch ``kind`` on the current stream with ``ins`` (made contiguous),
    then the contiguous ``outs``; raise on a refused launch."""
    fn = _kernel(kind)
    ins = [t.contiguous() for t in ins]
    dev = ins[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (*ins, *outs)), n, e, st.bins, st.units,
                float(st.distance_max), float(st.offset), float(st.gamma), stream)
    if rc != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {rc}")
    launches[kind] += 1


def cf_fwd(x, pos, w1, b1, w2, b2, senders, receivers, edge_mask, st: CFStatic) -> Tensor:
    """Kernel #5 on a CUDA tensor, its plain version on a CPU tensor."""
    weights = (w1, b1, w2, b2)
    _check("cf_fwd", x, pos, weights, (), senders, receivers, edge_mask, st)
    if x.device.type == "cpu":
        return cf_fwd_plain(x, pos, *weights, senders, receivers, edge_mask, st)
    n, e = x.shape[0], senders.shape[0]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if n == 0:
        return out
    _launch("cf_fwd", (x, pos, *weights, senders, receivers, edge_mask), [out], n, e, st)
    return out


def _zeros(*like):
    """Row-major zeros shaped as ``like`` (a weight may be a transposed view)."""
    return [torch.zeros(t.shape, dtype=t.dtype, device=t.device) for t in like]


def cf_vjp(x, pos, w1, b1, w2, b2, ct, senders, receivers, edge_mask, st: CFStatic):
    """Kernel #6 on a CUDA tensor, its plain version on a CPU tensor:
    ``(ct_x, ct_pos, ct_w1, ct_b1, ct_w2, ct_b2)``."""
    weights = (w1, b1, w2, b2)
    _check("cf_vjp", x, pos, weights, (("ct", ct, tuple(x.shape)),), senders, receivers,
           edge_mask, st)
    if x.device.type == "cpu":
        return cf_vjp_plain(x, pos, *weights, ct, senders, receivers, edge_mask, st)
    n, e = x.shape[0], senders.shape[0]
    # sender-side sums and the weights' sums are added with atomics into
    # zeros; the receiver side of ct_pos is written row by row (pos_recv)
    outs = _zeros(x, pos, *weights)
    if n == 0:
        return tuple(outs)
    pos_recv = torch.empty_like(outs[1])
    _launch("cf_vjp", (x, pos, *weights, ct, senders, receivers, edge_mask),
            outs + [pos_recv], n, e, st)
    outs[1] += pos_recv
    return tuple(outs)


def cf_hesjvp(x, pos, w1, b1, w2, b2, ct, u_x, u_pos, u_w1, u_b1, u_w2, u_b2,
              senders, receivers, edge_mask, st: CFStatic):
    """Kernel #7 on a CUDA tensor, its plain version on a CPU tensor:
    ``(J u, w_x, w_pos, w_w1, w_b1, w_w2, w_b2)``."""
    weights = (w1, b1, w2, b2)
    tangents = (u_x, u_pos, u_w1, u_b1, u_w2, u_b2)
    _check("cf_hesjvp", x, pos, weights,
           (("ct", ct, tuple(x.shape)),) + tuple(
               (f"u_{name}", t, tuple(ref.shape)) for name, t, ref in zip(
                   ("x", "pos", "w1", "b1", "w2", "b2"), tangents, (x, pos, *weights))),
           senders, receivers, edge_mask, st)
    if x.device.type == "cpu":
        return cf_hesjvp_plain(x, pos, *weights, ct, *tangents, senders, receivers,
                               edge_mask, st)
    n, e = x.shape[0], senders.shape[0]
    ju = torch.empty_like(x, memory_format=torch.contiguous_format)
    outs = _zeros(x, pos, *weights)
    if n == 0:
        return (ju, *outs)
    pos_recv = torch.empty_like(outs[1])
    # u_w2 is read by rows and by columns: the kernel takes both layouts
    _launch("cf_hesjvp", (x, pos, *weights, ct, *tangents, u_w2.t(), senders, receivers,
                          edge_mask), [ju] + outs + [pos_recv], n, e, st)
    outs[1] += pos_recv
    return (ju, *outs)


# ---------------------------------------------------------------- autograd

class SecondOrderOnly(torch.autograd.Function):
    """``value`` as it is, on a node that depends on ``deps``; its backward
    raises: a derivative of :class:`BWD`'s backward."""

    @staticmethod
    def forward(ctx, value: Tensor, *deps: Tensor) -> Tensor:
        return value.clone()

    @staticmethod
    def backward(ctx, ct: Tensor):
        raise RuntimeError(
            "the fused interaction chain (SchNet fused_chain=True) is closed to the second "
            "order, the reverse over reverse of force training, as the JAX package's: a "
            "third derivative is not computed. Use the default SchNet mode for it; the "
            "parameters are the same.")


class BWD(torch.autograd.Function):
    """The chain's first reverse pass (kernel #6), differentiable once more
    along every input: its backward is kernel #7."""

    @staticmethod
    def forward(ctx, ct, x, pos, w1, b1, w2, b2, senders, receivers, edge_mask, st):
        ctx.save_for_backward(ct, x, pos, w1, b1, w2, b2, senders, receivers, edge_mask)
        ctx.st = st
        return cf_vjp(x, pos, w1, b1, w2, b2, ct, senders, receivers, edge_mask, st)

    @staticmethod
    def backward(ctx, *u):
        saved = ctx.saved_tensors
        ct, x, pos, w1, b1, w2, b2, senders, receivers, edge_mask = saved
        ju, *w = cf_hesjvp(x, pos, w1, b1, w2, b2, ct, *u, senders, receivers, edge_mask,
                           ctx.st)
        grads = [ju, *w]
        if torch.is_grad_enabled():  # the caller records a graph through this backward
            deps = [t for t in (*u, *saved) if t.is_floating_point()]
            grads = [SecondOrderOnly.apply(t, *deps) for t in grads]
        return (*grads, None, None, None, None)


class CF(torch.autograd.Function):
    """The chain's forward (kernel #5); its backward is :class:`BWD`."""

    @staticmethod
    def forward(ctx, x, pos, w1, b1, w2, b2, senders, receivers, edge_mask, st):
        ctx.save_for_backward(x, pos, w1, b1, w2, b2, senders, receivers, edge_mask)
        ctx.st = st
        return cf_fwd(x, pos, w1, b1, w2, b2, senders, receivers, edge_mask, st)

    @staticmethod
    def backward(ctx, ct):
        x, pos, w1, b1, w2, b2, senders, receivers, edge_mask = ctx.saved_tensors
        grads = BWD.apply(ct, x, pos, w1, b1, w2, b2, senders, receivers,
                          edge_mask, ctx.st)
        return (*grads, None, None, None, None)


def cfconv_fused_chain(x: Tensor, pos: Tensor, w1: Tensor, b1: Tensor, w2: Tensor,
                       b2: Tensor, senders: Tensor, receivers: Tensor, edge_mask: Tensor,
                       st: CFStatic) -> Tensor:
    """``y[i] = sum_{e = (i <- j), edge_mask[e]} F_e * x[j]`` with the filter
    recomputed from the positions in the kernels; differentiable in reverse
    mode to the second order (the module docstring)."""
    return CF.apply(x, pos, w1, b1, w2, b2, senders.to(torch.int32),
                    receivers.to(torch.int32), edge_mask.to(torch.bool), st)


def fused_chain_ineligibility(batch) -> list:
    """Why ``batch`` cannot take the fused chain (an empty list: it can).
    The kernels apply no periodic image shift, and they walk each receiver's
    edges as one sorted run (a batch with ``sender_perm`` was built sorted
    by receiver). The JAX package's TPU gates (the backend, 128-row sender
    windows, ``bins`` < 128, ``E >= 8192``) weigh TPU costs and are not
    kept; U beyond the kernels' shared memory raises on the card."""
    reasons = []
    if "range_image" in batch.edges:
        reasons.append("periodic batch (range_image shifts)")
    if "sender_perm" not in batch.edges:
        reasons.append("edges not sorted by receiver (no sender_perm)")
    return reasons
