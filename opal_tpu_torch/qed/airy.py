"""Airy function Ai(x) for real non-negative argument, vectorized
(``opal_tpu/qed/airy.py``; reference ``src/qed/special_functions/
airy.rs:19-69``).

The same piecewise intervals as the reference: the Maclaurin series for
x < 1, then the generalized Gauss-Laguerre quadrature of the integral
representation with 40/16/4 nodes for x < 2 / 10 / 50.  Beyond 50
(Ai < 4.5e-104) or below 0 the result is flagged invalid and returned
as 0.0.

As in opal_tpu, the series runs as two Horner chains in y = x^3, and
each quadrature branch's node sum I(s) = sum_i w_i (2 + t_i/s)^(-1/6)
is a Chebyshev fit in log(s), evaluated by the Clenshaw recurrence.
The coefficients and fits are computed once at import, on the host with
numpy and scipy, by a copy of opal_tpu's code; the evaluation is torch
on the input's device and in the input's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import roots_genlaguerre


def _taylor_coefficients(terms: int = 14) -> tuple[np.ndarray, np.ndarray]:
    """Maclaurin series of Ai split into the y = x^3 Horner chains:
    Ai(x) = f(y) + x g(y),  f = sum fk y^k,  g = sum gk y^k."""
    alpha = 3.0 ** (-2.0 / 3.0) / math.gamma(2.0 / 3.0)  # Ai(0)
    beta = -(3.0 ** (-1.0 / 3.0)) / math.gamma(1.0 / 3.0)  # Ai'(0)
    fk, gk = [], []
    af, ag = alpha, beta
    for k in range(terms):
        fk.append(af)
        gk.append(ag)
        # term_{k+1}/term_k = x^3 / ((3k+2)(3k+3)) for f,
        # x^3 / ((3k+3)(3k+4)) for g
        af = af / ((3 * k + 2) * (3 * k + 3))
        ag = ag / ((3 * k + 3) * (3 * k + 4))
    return np.asarray(fk), np.asarray(gk)


_TAYLOR_F, _TAYLOR_G = (
    tuple(float(c) for c in a) for a in _taylor_coefficients()
)

# Quadrature scale factor a(x) = s^(-1/6) e^(-s) / (sqrt(pi) 48^(1/6) Gamma(5/6))
_SCALE = 1.0 / (math.sqrt(math.pi) * 48.0 ** (1.0 / 6.0) * math.gamma(5.0 / 6.0))


def _fit_branch(x_lo: float, x_hi: float, n: int, deg: int):
    """Chebyshev coefficients (in u = affine(log s)) of the n-node
    generalized Gauss-Laguerre sum I(s), plus the u-map (a, b)."""
    t, w = roots_genlaguerre(n, -1.0 / 6.0)
    xs = np.linspace(x_lo, x_hi, 16 * (deg + 1))
    s = 2.0 * xs**1.5 / 3.0
    target = (w * (2.0 + t / s[:, None]) ** (-1.0 / 6.0)).sum(-1)
    ls = np.log(s)
    a, b = ls.min(), ls.max()
    u = 2.0 * (ls - a) / (b - a) - 1.0
    coef = np.polynomial.chebyshev.chebfit(u, target, deg)
    # plain floats: the evaluation keeps the input's dtype
    return tuple(float(c) for c in coef), float(a), float(b)


_BRANCHES = (
    (1.0, 2.0) + _fit_branch(1.0, 2.0, 40, 12),
    (2.0, 10.0) + _fit_branch(2.0, 10.0, 16, 16),
    (10.0, 50.0) + _fit_branch(10.0, 50.0, 4, 16),
)


def _coefficient_table() -> np.ndarray:
    """Every constant of :func:`airy_ai` as one flat f64 host array (the
    absorption walk's kernel reads them rearranged,
    ``ops/absorb_walk.py::airy_table``): the Taylor terms' count n, the n
    f then the n g
    coefficients, ``_SCALE``, the branches' count, then per branch its
    lower bound, its u-map's ``a`` and ``b - a`` (the plain code divides
    by that difference), its coefficients' count and the coefficients."""
    out = [len(_TAYLOR_F), *_TAYLOR_F, *_TAYLOR_G, _SCALE, len(_BRANCHES)]
    for x_lo, _x_hi, coef, a, b in _BRANCHES:
        out += [x_lo, a, b - a, len(coef), *coef]
    return np.asarray(out, dtype=np.float64)


COEFFICIENTS = _coefficient_table()


def _clenshaw(u, coef):
    """Chebyshev series at ``u`` by the Clenshaw recurrence; ``coef`` is
    a host tuple of plain floats."""
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    for c in coef[:0:-1]:
        b1, b2 = 2.0 * u * b1 - b2 + c, b1
    return u * b1 - b2 + coef[0]


def airy_ai(x):
    """Ai(x) for x >= 0; returns ``(value, valid)``, tensors on the
    input's device.

    ``valid`` is False outside [0, 50); the value there is 0.0 (also the
    physical limit for the absorption cross section, where an underflow
    of Ai means no interaction)."""
    x = torch.as_tensor(x)

    # series branch: two Horner chains in y = x^3
    x_t = torch.clamp(x, 0.0, 1.0)
    y = x_t * x_t * x_t
    f = torch.zeros_like(x_t)
    g = torch.zeros_like(x_t)
    for fk, gk in zip(_TAYLOR_F[::-1], _TAYLOR_G[::-1]):
        f = f * y + fk
        g = g * y + gk
    taylor = f + x_t * g

    # quadrature branches: a(x) I(s), I by Clenshaw in log s; s, log s
    # and the prefactor are shared by the three branches
    x_q = torch.clamp(x, 1.0, 50.0)
    s_q = 2.0 * x_q * torch.sqrt(x_q) / 3.0
    ls_q = torch.log(s_q)
    pref_q = _SCALE * torch.exp(-s_q - ls_q / 6.0)
    value = taylor
    for x_lo, _x_hi, coef, a, b in _BRANCHES:
        u = 2.0 * (ls_q - a) / (b - a) - 1.0
        value = torch.where(x < x_lo, value, pref_q * _clenshaw(u, coef))

    valid = (x >= 0.0) & (x < 50.0)
    return torch.where(valid, value, torch.zeros_like(value)), valid
