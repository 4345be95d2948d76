"""Particle-grid interpolation: b-spline weights, charge-conserving
flux, and the staggered field gather.

The grid staggering follows the reference's Yee cell
(``src/grid/yee.rs:70-92``): rho, jy, jz, Ey, Ez, Bx live on the cell's
left edge; jx, Ex, By, Bz at the cell centre.  The interpolation
function is the second-order b-spline of :func:`weight`
(``yee.rs:140-149``).
"""

from __future__ import annotations

import torch


def weight(xi):
    """Second-order b-spline interpolation weight (``yee.rs:140-149``).

    Non-zero for |xi| < 3/2; weights of all grid points within 3/2 of
    the particle centre sum to 1.
    """
    xhat = torch.abs(xi)
    inner = 0.75 - xhat * xhat
    outer = 1.125 - 1.5 * xhat + 0.5 * (xhat * xhat)
    return torch.where(
        xhat > 1.5, 0.0, torch.where(xhat < 0.5, inner, outer)
    )


def flux(x_i, x_f):
    """Amount of (triangle-shaped) particle crossing a boundary that
    moves from displacement ``x_i`` to ``x_f`` relative to the particle
    centre (``yee.rs:185-204``).  Positive for left-to-right motion;
    exactly conserves particle weight.  ``copysign`` honours signed
    zeros as Rust's ``f64::copysign`` does."""
    ai, af = torch.abs(x_i), torch.abs(x_f)
    hi = 0.5 * ((1.0 - ai) * (1.0 - ai))
    hf = 0.5 * ((1.0 - af) * (1.0 - af))
    # case 1: |x_i| < 1, |x_f| >= 1 -> sign of -x_i
    v1 = torch.copysign(hi, -x_i)
    # case 2: same sign -> difference of half-squares, sign of x_i - x_f
    v2 = torch.copysign(hf - hi, x_i - x_f)
    # case 3: opposite signs -> sum of both triangles, sign of x_i
    v3 = torch.copysign(ai * (1.0 - 0.5 * ai) + af * (1.0 - 0.5 * af), x_i)
    # case 4: |x_i| >= 1, |x_f| < 1 -> sign of x_f
    v4 = torch.copysign(hf, x_f)

    inner_i = ai < 1.0
    inner_f = af < 1.0
    same_sign = x_i * x_f >= 0.0
    return torch.where(
        inner_i,
        torch.where(~inner_f, v1, torch.where(same_sign, v2, v3)),
        torch.where(inner_f, v4, torch.zeros_like(v4)),
    )


def fields_at(E, B, idx, xi):
    """Gather (E, B) at per-particle positions.

    ``E``/``B`` are field slabs of shape (n, 3); ``idx`` the per-particle
    *array index* of its cell (caller adds the halo offset); ``xi`` the
    fractional offset in [0, 1).  The staggered 2nd-order b-spline of
    ``yee.rs:499-529``: edge quantities (Ey, Ez) gather from cells
    idx-1..idx+2, centred quantities (Ex, By, Bz) from idx-1..idx+1, and
    Bx is piecewise-constant.  Neighbour rows wrap around the slab and
    out-of-range indices clamp, as the JAX gather of a rolled table does.

    Returns ``(Ep, Bp)`` of shape (N, 3).
    """
    n = E.shape[0]
    i0 = torch.clamp(idx.long(), 0, n - 1)
    rows = [(i0 + k) % n for k in (-1, 0, 1, 2)]

    wc = [weight(0.5 + xi), weight(0.5 - xi), weight(1.5 - xi)]
    we = [weight(1.0 + xi), weight(xi), weight(1.0 - xi), weight(2.0 - xi)]

    def centred(F, c):
        return sum(w * F[r, c] for w, r in zip(wc, rows[:3]))

    def edge(F, c):
        return sum(w * F[r, c] for w, r in zip(we, rows))

    Ep = torch.stack([centred(E, 0), edge(E, 1), edge(E, 2)], dim=1)
    Bp = torch.stack([B[i0, 0], centred(B, 1), centred(B, 2)], dim=1)
    return Ep, Bp
