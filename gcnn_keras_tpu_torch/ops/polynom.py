"""Spherical Bessel and Legendre polynomials; counterpart of
``gcnn_keras_tpu/ops/polynom.py`` (DimeNet++'s and MXMNet's spherical
basis).

The orders are static: each recursion is unrolled in Python. Order ``l``
of ``j_l`` takes a Taylor series below ``1 + 0.75 l`` and the upward
recursion from ``j_0``, ``j_1`` above, as in the JAX package. Unlike
``jnp.where``, whose unselected branch the JAX package leaves as it is,
each branch here is evaluated only on inputs where it stays finite (the
recursion at ``|x| >= 1``, the series at the selected inputs, 0
elsewhere): a zero cotangent times an infinite local derivative is NaN in
a reverse pass, and a force loss takes two of them. Where a branch is
selected its input is the JAX package's, so the values are its values.

``spherical_bessel_zeros`` runs on the host with numpy and
``scipy.special.spherical_jn``.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _int_pow(x: Tensor, n: int) -> Tensor:
    """``x ** n`` for a static integer ``n >= 0`` as a product (finite
    derivatives of every order at 0, unlike ``pow``'s at ``n = 0``)."""
    out = torch.ones_like(x)
    for _ in range(n):
        out = out * x
    return out


def _jl_series(x: Tensor, l: int, terms: int = 10) -> Tensor:
    """The Taylor series of ``j_l``: ``x^l / (2l+1)!! * sum_k (-x^2/2)^k /
    (k! (2l+3)(2l+5)...)``; accurate in float32 where the upward recursion
    cancels (x well below l)."""
    x2h = -0.5 * x * x
    dfact = 1.0
    for m in range(1, 2 * l + 2, 2):
        dfact *= m
    acc = torch.zeros_like(x)
    term = torch.ones_like(x)
    for k in range(terms):
        if k > 0:
            term = term * x2h / (k * (2 * l + 1 + 2 * k))
        acc = acc + term
    return _int_pow(x, l) / dfact * acc


def _recursion(x: Tensor, n_max: int) -> list:
    """``[j_0(x) ... j_{n_max-1}(x)]`` by the upward recursion."""
    j0 = torch.sin(x) / x
    rec = [j0]
    if n_max > 1:
        rec.append(torch.sin(x) / (x * x) - torch.cos(x) / x)
        for k in range(1, n_max - 1):
            rec.append((2 * k + 1) / x * rec[-1] - rec[-2])
    return rec


def _threshold(l: int) -> float:
    return 1.0 + 0.75 * l


def _jl_select(x: Tensor, l: int, rec_l: Tensor) -> Tensor:
    """Order ``l``: the series below its threshold, ``rec_l`` (the
    recursion, computed at ``|x| >= 1``) above it."""
    small = torch.abs(x) < _threshold(l)
    # the series of the JAX package reads x clamped away from 0 at 1e-8
    xs = torch.where(torch.abs(x) < 1e-8, torch.full_like(x, 1e-8), x)
    series = _jl_series(torch.where(small, xs, torch.zeros_like(x)), l)
    return torch.where(small, series, rec_l)


def _recursion_input(x: Tensor) -> Tensor:
    """``x``, or 1 where ``|x| < 1``: every order's threshold is at least 1,
    so the recursion is never selected there, and from 1 on it stays
    finite with its derivatives."""
    return torch.where(torch.abs(x) < 1.0, torch.ones_like(x), x)


def spherical_bessel_jn_all(x: Tensor, n_max: int) -> Tensor:
    """Stack ``[j_0(x) ... j_{n_max-1}(x)]`` along a trailing axis."""
    rec = _recursion(_recursion_input(x), n_max)
    return torch.stack([_jl_select(x, l, rec[l]) for l in range(n_max)], dim=-1)


def spherical_bessel_jn(x: Tensor, n: int) -> Tensor:
    """``j_n(x)`` for a static order ``n``."""
    return _jl_select(x, n, _recursion(_recursion_input(x), n + 1)[n])


def spherical_bessel_jn_diagonal(x: Tensor) -> Tensor:
    """``out[..., l, :] = j_l(x[..., l, :])`` for ``x`` of shape ``(..., L,
    n)``: the spherical basis's radial part, order ``l`` at its own zeros.
    The values of ``spherical_bessel_jn_all(x[..., l, :], L)[..., l]``, one
    recursion over all of ``x`` and one series an order."""
    n_orders = x.shape[-2]
    rec = _recursion(_recursion_input(x), n_orders)
    return torch.stack([_jl_select(x[..., l, :], l, rec[l][..., l, :])
                        for l in range(n_orders)], dim=-2)


def legendre_pn(x: Tensor, n: int) -> Tensor:
    """``P_n(x)`` by Bonnet's recursion (static ``n``)."""
    p0 = torch.ones_like(x)
    if n == 0:
        return p0
    p1 = x
    for k in range(1, n):
        p0, p1 = p1, ((2 * k + 1) * x * p1 - k * p0) / (k + 1)
    return p1


def legendre_pn_all(x: Tensor, n_max: int) -> Tensor:
    """Stack ``[P_0(x) ... P_{n_max-1}(x)]`` along a trailing axis."""
    out = [torch.ones_like(x)]
    if n_max > 1:
        out.append(x)
        for k in range(1, n_max - 1):
            out.append(((2 * k + 1) * x * out[-1] - k * out[-2]) / (k + 1))
    return torch.stack(out, dim=-1)


def spherical_bessel_zeros(n: int, k: int) -> np.ndarray:
    """The first ``k`` positive zeros of ``j_l`` for ``l = 0..n-1``, ``(n,
    k)``, on the host: the zeros of ``j_l`` interlace those of ``j_{l-1}``,
    each found by 80 bisections between two of them."""
    from scipy.special import spherical_jn

    zeros = np.zeros((n, k))
    grid = np.arange(1, k + n + 2) * np.pi  # the zeros of j_0: m pi
    zeros[0] = grid[:k]
    points = grid
    for l in range(1, n):
        def f(x, l=l):
            return spherical_jn(l, x)
        new_pts = []
        for i in range(len(points) - 1):
            a, b = points[i], points[i + 1]
            fa, fb = f(a), f(b)
            if fa * fb > 0:
                continue
            for _ in range(80):
                m = 0.5 * (a + b)
                fm = f(m)
                if fa * fm <= 0:
                    b, fb = m, fm
                else:
                    a, fa = m, fm
            new_pts.append(0.5 * (a + b))
        points = np.asarray(new_pts)
        zeros[l] = points[:k]
    return zeros
