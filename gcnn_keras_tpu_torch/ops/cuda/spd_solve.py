"""Batched SPD solve: the hand-written CUDA kernels, their plain version and
their autograd Function; counterpart of ``gcnn_keras_tpu/ops/pallas/spd_solve.py``.

``x = a^-1 b`` for ``a (G, M, M)`` symmetric positive definite and
``b (G, M, K)``, by Gauss-Jordan elimination without pivoting. The kernels
(``csrc/spd_solve.cu``) replace the TPU kernel ``_gj_solve_impl``
(``_gj_kernel``); the C entry point picks one by M:

- M <= 32 (every Qeq system of molecules up to 32 atoms): one warp a
  system, a lane a column of ``[A | B]`` in registers, the pivot column read
  by shuffle, no block barrier (columns past 32 in further passes of the
  warp);
- 32 < M: one thread block a system, ``[A | B]`` in shared memory
  column-major, a warp a round-robin set of columns, a lane a set of rows
  (one instance for each ceil(M / 32) from 2 to 8); the steps go in blocks
  of three, each live entry read and written once a block, one block
  barrier a block.

Both do the plain version's arithmetic, rounded the same way, so they agree
with :func:`spd_solve_plain` to the last bit.

Bound on the H100: at the Qeq serving shape (G=513, M=20, K=2) the call
must move 0.98 MB (about 0.29 us at 3.35 TB/s) and do some 5 MFLOP; the
warp kernel is bound by the latency of its M dependent steps instead, the
block kernel at large M by the instruction rate of its rounded operations
and its shared-memory traffic, at small M by the latency of its block
steps.

The block kernel's one limit is its shared memory, ``4 (M | 1) (M + K)``
bytes: :func:`fits_shared_memory` is the shape test a caller makes before
choosing the kernels, for every M, on the budget :func:`shared_bytes`
states (at least the kernel's; ``M <= 239`` at ``K = 2``).

A CPU tensor takes :func:`spd_solve_plain`; a CUDA tensor launches a kernel
or raises. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_library

Tensor = torch.Tensor

launches = 0

# dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SHARED_BYTES = 232448


def shared_bytes(m: int, k: int) -> int:
    """The gate's shared-memory budget of one system: ``[A | B]`` plus a row
    and a column. The block kernel takes ``[A | B]`` with its columns padded
    to an odd length, ``4 (m | 1) (m + k)`` bytes, which is never more."""
    return 4 * (m * (m + k) + m + (m + k))


def fits_shared_memory(m: int, k: int) -> bool:
    """Whether the kernel can take systems of size ``m`` with ``k``
    right-hand sides (``m <= 239`` for ``k = 2``)."""
    return shared_bytes(m, k) <= MAX_SHARED_BYTES


def max_kernel_m(k: int) -> int:
    """The largest ``m`` that :func:`fits_shared_memory` allows."""
    m = 1
    while fits_shared_memory(m + 1, k):
        m += 1
    return m


def spd_solve_plain(a: Tensor, b: Tensor) -> Tensor:
    """The kernel's elimination in PyTorch operations over the batch (any
    device, any float dtype)."""
    m = a.shape[-1]
    s = torch.cat([a, b], dim=-1)
    for k in range(m):
        rk = s[:, k, :] * (1.0 / s[:, k, k:k + 1])
        col = s[:, :, k].clone()
        col[:, k] = 0.0
        s = s - col[:, :, None] * rk[:, None, :]
        s[:, k, :] = rk
    return s[:, :, m:]


def _kernel():
    """The C entry point of ``csrc/spd_solve.cu``, built on first use."""
    fn = load_library("spd_solve").gcnn_spd_solve_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a: Tensor, b: Tensor) -> None:
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"a must be (G, M, M), got shape {tuple(a.shape)}")
    if b.dim() != 3 or b.shape[:2] != a.shape[:2]:
        raise ValueError(f"b must be ({a.shape[0]}, {a.shape[1]}, K), "
                         f"got shape {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    if a.dtype != b.dtype:
        raise TypeError(f"a is {a.dtype} but b is {b.dtype}")


def spd_solve(a: Tensor, b: Tensor) -> Tensor:
    """``x`` with ``a @ x = b`` for SPD ``a (G, M, M)``, ``b (G, M, K)``.
    Not differentiable by itself: see :class:`SPDSolve`."""
    global launches
    _check(a, b)
    if a.device.type == "cpu":
        return spd_solve_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no SPD solve kernel for device {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    g, m, _ = a.shape
    k = b.shape[2]
    if not fits_shared_memory(m, k):
        raise ValueError(f"M={m}, K={k} needs {shared_bytes(m, k)} bytes of shared "
                         f"memory, more than the {MAX_SHARED_BYTES} a block has")
    out = torch.empty_like(b)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, k, stream)
    if rc != 0:
        raise RuntimeError(f"spd_solve kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


class SPDSolve(torch.autograd.Function):
    """``x = a^-1 b`` for symmetric ``a``; the counterpart of the JAX
    package's ``custom_linear_solve(symmetric=True)``.

    The backward solves once more with the same ``a`` (``a`` is its own
    transpose): ``gb = a^-1 g`` and ``ga = -gb x^T``, written with
    ``SPDSolve.apply`` and differentiable operations, so that derivatives of
    any order stay on the kernel. Like the JAX solve, the ``ga`` it returns
    is right along symmetric directions of ``a``. The ``jvp`` is one more
    solve, ``dx = a^-1 (db - da x)``, on the kernel."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        x = spd_solve(a.contiguous(), b.contiguous())
        ctx.save_for_backward(a, x)
        ctx.save_for_forward(a, x)
        # an input without a tangent reaches jvp as None, not as zeros (and
        # an output without a cotangent the backward)
        ctx.set_materialize_grads(False)
        return x

    @staticmethod
    def backward(ctx, g: Tensor):
        if g is None:  # materialize_grads is off
            return None, None
        a, x = ctx.saved_tensors
        gb = SPDSolve.apply(a, g)
        ga = -(gb @ x.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        return ga, gb

    @staticmethod
    def jvp(ctx, da: Tensor, db: Tensor) -> Tensor:
        a, x = ctx.saved_tensors
        rhs = db if da is None else (-(da @ x) if db is None else db - da @ x)
        return SPDSolve.apply(a, rhs)
