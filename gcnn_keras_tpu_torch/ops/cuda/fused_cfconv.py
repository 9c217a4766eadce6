"""Fused SchNet continuous-filter convolution for the MD path; counterpart of
``gcnn_keras_tpu/ops/pallas/fused_cfconv.py``.

``out[r] = sum_{e: receivers[e] = r} xj[e] * (ssp(basis[e] @ W1 + b1) @ W2 + b2)``
for ascending int32 ``receivers``, with ``W1`` (B, U) and ``W2`` (U, U) in
the flax layout (in, out). The kernel (``csrc/fused_cfconv.cu``) replaces
the TPU kernel ``_fused_cfconv_impl``: the filter MLP in float32 FMA (no
TF32), recomputed per edge so that the (E, U) filter never reaches memory.
Its header gives the bound (float32 operations: 31 us at the SchNet serving
shapes on the H100). Two kernels, both hand-written: a tiled one for U up
to 128 (SchNet's widths), a wide one above. Each keeps the weights in one
block's shared memory: :func:`fits_shared_memory` is the one gate (U up
to 222 at B 20).

:class:`FusedCfconv` is first-order only, as the JAX package's
``custom_vjp`` is: its backward recomputes the filter in PyTorch (the
weight products as ``torch.matmul``, which the JAX package leaves to XLA
outside the kernel) and a derivative through that backward raises. The
Function is the same on every device; on a CPU tensor its forward is the
plain version.

``torch.autograd.function.once_differentiable`` is not enough for that: the
error node it hangs on the backward's outputs is cut off from the inputs,
so ``torch.autograd.grad(force_loss, parameters)`` never reaches it and
returns the parameters' force-loss gradients as zeros. Here each output of
a backward that records a graph passes through :class:`FirstOrderOnly`,
which depends on every input of the backward and raises when the engine
runs its backward.

A CPU tensor takes :func:`fused_cfconv_plain`; a CUDA tensor launches the
kernel or raises. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from ..activ import shifted_softplus
from .autograd import input_needed
from .build import load_library

Tensor = torch.Tensor

launches = 0

SHARED_MEMORY_BYTES = 232448  # the dynamic shared memory a Hopper block may take
# kEdgesTile, kEdges and kTiledUnits of csrc/fused_cfconv.cu: edges per chunk
# of the tiled and of the wide kernel, and the U up to which the tiled runs
_EDGES_TILE, _EDGES_PER_CHUNK, TILED_UNITS = 32, 16, 128


def fused_cfconv_plain(basis: Tensor, xj: Tensor, receivers: Tensor, num_nodes: int,
                       w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """The kernel's plain PyTorch version (the JAX ``_reference_impl``):
    the filter MLP, the product with ``xj`` and ``index_add_``."""
    f = shifted_softplus(basis @ w1 + b1) @ w2 + b2
    return torch.zeros((num_nodes, xj.shape[1]), dtype=xj.dtype,
                       device=xj.device).index_add_(0, receivers, xj * f)


def shared_memory_bytes(b: int, u: int) -> int:
    """What one block of the kernel that takes B bins and U units needs
    (``gcnn_fused_cfconv_smem_bytes`` in the source): the tiled kernel W2
    and W1 padded to a multiple of 32 units, a chunk's hidden and message
    rows, its basis rows, receivers and the edge range; the wide one a
    chunk's hidden rows, W2, W1, b1, b2, its basis rows and receivers."""
    if u <= TILED_UNITS:
        e, p = _EDGES_TILE, (u + 31) // 32 * 32
        return 4 * (p * p + b * p + 2 * e * p + e * b) + 4 * (e + 2)
    uh = (u + 3) // 4 * 4
    floats = _EDGES_PER_CHUNK * uh + u * u + b * u + 2 * u + _EDGES_PER_CHUNK * b
    return 4 * (floats + _EDGES_PER_CHUNK + 2)


def fits_shared_memory(b: int, u: int) -> bool:
    """Whether the kernel takes B basis functions and U units."""
    return shared_memory_bytes(b, u) <= SHARED_MEMORY_BYTES


def _kernel():
    """The C entry point of ``csrc/fused_cfconv.cu``, built on first use."""
    fn = load_library("fused_cfconv").gcnn_fused_cfconv_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(basis, xj, receivers, num_nodes, w1, b1, w2, b2) -> None:
    if basis.dim() != 2 or xj.dim() != 2 or basis.shape[0] != xj.shape[0]:
        raise ValueError(f"basis must be (E, B) and xj (E, U), got {tuple(basis.shape)} "
                         f"and {tuple(xj.shape)}")
    b, u = basis.shape[1], xj.shape[1]
    for name, t, shape in (("w1", w1, (b, u)), ("b1", b1, (u,)), ("w2", w2, (u, u)),
                           ("b2", b2, (u,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if receivers.dim() != 1 or receivers.shape[0] != basis.shape[0]:
        raise ValueError(f"receivers must be ({basis.shape[0]},), got {tuple(receivers.shape)}")
    if receivers.dtype != torch.int32:
        raise TypeError(f"receivers must be int32, got {receivers.dtype}")
    for name, t in (("xj", xj), ("receivers", receivers), ("w1", w1), ("b1", b1),
                    ("w2", w2), ("b2", b2)):
        if t.device != basis.device:
            raise ValueError(f"basis on {basis.device} but {name} on {t.device}")
    if num_nodes < 0:
        raise ValueError(f"num_nodes={num_nodes} < 0")


def fused_cfconv_kernel(basis: Tensor, xj: Tensor, receivers: Tensor, num_nodes: int,
                        w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """The fused cfconv of the module docstring on the kernel (a CUDA
    tensor) or the plain version (a CPU tensor). Not differentiable by
    itself: see :class:`FusedCfconv`."""
    global launches
    _check(basis, xj, receivers, num_nodes, w1, b1, w2, b2)
    if basis.device.type == "cpu":
        return fused_cfconv_plain(basis, xj, receivers, num_nodes, w1, b1, w2, b2)
    if basis.device.type != "cuda":
        raise ValueError(f"no fused cfconv kernel for device {basis.device}")
    floats = (basis, xj, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("the CUDA kernel takes float32 basis, xj and weights, got "
                        + ", ".join(str(t.dtype) for t in floats))
    e, b = basis.shape
    u = xj.shape[1]
    if not fits_shared_memory(b, u):
        raise ValueError(f"B={b}, U={u}: the kernel's block needs "
                         f"{shared_memory_bytes(b, u)} bytes of shared memory, "
                         f"more than the {SHARED_MEMORY_BYTES} a block has")
    basis, xj, w1, b1, w2, b2 = (t.contiguous() for t in floats)
    receivers = receivers.contiguous()
    out = torch.empty((num_nodes, u), dtype=torch.float32, device=basis.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(basis.device):
        stream = torch.cuda.current_stream(basis.device).cuda_stream
        rc = fn(basis.data_ptr(), xj.data_ptr(), receivers.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                e, b, u, num_nodes, stream)
    if rc != 0:
        raise RuntimeError(f"fused_cfconv kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


_REVERSE_ONLY = (
    "FusedCfconv (SchNet accurate_cfconv=True) is reverse mode only, as the JAX "
    "package's fused cfconv, a custom_vjp that jax.jvp refuses: forward mode (the fast "
    "force step, training/fast_force_step.py) does not run it. Use the default or the "
    "fused_aggregate mode, whose parameters are the same")


class FirstOrderOnly(torch.autograd.Function):
    """``value`` as it is, on a node that depends on ``deps``; its backward
    raises: a derivative of :class:`FusedCfconv`'s backward."""

    @staticmethod
    def forward(ctx, value: Tensor, *deps: Tensor) -> Tensor:
        return value.clone()

    @staticmethod
    def backward(ctx, ct: Tensor):
        raise RuntimeError(
            "FusedCfconv (SchNet accurate_cfconv=True) is first-order only, as the JAX "
            "package's fused cfconv: energies and forces work, a derivative of the forces "
            "(a force loss in training) does not. Train with the default or the "
            "fused_aggregate mode, whose parameters are the same.")

    @staticmethod
    def jvp(ctx, *_):
        raise NotImplementedError(_REVERSE_ONLY)


class FusedCfconv(torch.autograd.Function):
    """The fused cfconv with the JAX package's first-order VJP (``_bwd``):
    the filter recomputed, then the cotangents of basis, xj and the four
    weights. A second derivative raises (:class:`FirstOrderOnly`), and so
    does forward mode: the JAX kernel is a ``custom_vjp``, which ``jax.jvp``
    refuses (``_REVERSE_ONLY``)."""

    @staticmethod
    def forward(ctx, basis: Tensor, xj: Tensor, receivers: Tensor, w1: Tensor,
                b1: Tensor, w2: Tensor, b2: Tensor, num_nodes: int) -> Tensor:
        ctx.save_for_backward(basis, xj, receivers, w1, b1, w2, b2)
        return fused_cfconv_kernel(basis, xj, receivers, num_nodes, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g: Tensor):
        saved = ctx.saved_tensors
        basis, xj, receivers, w1, b1, w2, b2 = saved
        need = [input_needed(ctx, i) for i in range(7)]
        with torch.no_grad():
            z1 = basis @ w1 + b1
            h = shifted_softplus(z1)
            g_e = g.index_select(0, receivers)
            d_f = g_e * xj
            d_z1 = (d_f @ w2.t()) * torch.sigmoid(z1)  # softplus' = sigmoid
            grads = [d_z1 @ w1.t() if need[0] else None,
                     g_e * (h @ w2 + b2) if need[1] else None, None,
                     basis.t() @ d_z1 if need[3] else None,
                     d_z1.sum(0) if need[4] else None,
                     h.t() @ d_f if need[5] else None,
                     d_f.sum(0) if need[6] else None]
        if torch.is_grad_enabled():  # the caller records a graph through this backward
            deps = [t for t in (g, *saved) if t.is_floating_point()]
            grads = [None if t is None else FirstOrderOnly.apply(t, *deps) for t in grads]
        return (*grads, None)

    @staticmethod
    def jvp(ctx, *_):
        raise NotImplementedError(_REVERSE_ONLY)


def fused_cfconv_auto(basis: Tensor, xj: Tensor, receivers: Tensor, num_nodes: int,
                      w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """:class:`FusedCfconv` on every device: the kernel on the card, the
    plain version on the CPU; first-order only on both (the JAX package
    runs its differentiable reference off the TPU)."""
    return FusedCfconv.apply(basis, xj, receivers.to(torch.int32), w1, b1, w2, b2,
                             num_nodes)
