"""Charge-conserving current deposition (``src/grid/yee.rs:551-641``).

The longitudinal current ``jx`` uses the flux form that exactly
satisfies the discrete continuity equation; the transverse currents and
the charge density use b-spline weights.  Scatter-add (``index_add_``)
accumulates the taps.

Parity notes (deliberate bug-for-bug reproduction of the reference,
as in ``opal_tpu/ops/deposit.py:15-23``):

* ``yee.rs:597/602`` adds a ``weight(2 + x)`` contribution of j_perp at
  ``index+2``; for x in [0, 1) that weight is identically zero, so the
  term is omitted.
* ``yee.rs:609`` deposits the charge-density weight ``weight(2 - x)``
  at ``index-2`` (rather than ``index+2``); reproduced as-is.
"""

from __future__ import annotations

import torch

from .interp import flux, weight


def _particle_values(x, prev_x, macrocharge, vy, vz, dx, dt):
    """The 15 per-particle deposition values and their (offset, target)
    wiring.

    Returns ``(vals (N, 15), plan)`` where plan is a list of
    ``(column, offset, component)`` with component 0..2 = J columns,
    3 = rho.
    """
    w_m1 = weight(1.0 + x)
    w_0 = weight(x)
    w_p1 = weight(1.0 - x)
    w_m2q = weight(2.0 - x)  # the reference's index-2 rho quirk

    cols = []
    plan = []
    for off in (-2, -1, 0, 1, 2):
        b = off + 0.5
        cols.append(macrocharge * flux(b - prev_x, b - x) / dt)
        plan.append((len(cols) - 1, off, 0))
    for comp, v in ((1, vy), (2, vz)):
        for off, w in ((-1, w_m1), (0, w_0), (1, w_p1)):
            cols.append(macrocharge * v * w / dx)
            plan.append((len(cols) - 1, off, comp))
    for off, w in ((-1, w_m1), (0, w_0), (1, w_p1), (-2, w_m2q)):
        cols.append(macrocharge * w / dx)
        plan.append((len(cols) - 1, off, 3))
    return torch.stack(cols, dim=-1), plan


def deposit(J, rho, idx, x, prev_x, macrocharge, velocity, dx, dt):
    """Accumulate one species' contribution into slab arrays.

    ``J`` (n, 3) and ``rho`` (n,) are the slabs (new tensors are
    returned); ``idx`` the per-particle slab index of its cell;
    ``x``/``prev_x`` the fractional offsets at t and t - dt;
    ``macrocharge`` weight * charge (0 for dead particles); ``velocity``
    (N, 3) in SI.  Taps that land outside the slab, on either side, are
    dropped: a particle several cells out of domain between migration
    exchanges must not wrap onto the far end of the slab.
    """
    n = rho.shape[0]
    vals, plan = _particle_values(
        x, prev_x, macrocharge, velocity[:, 1], velocity[:, 2], dx, dt
    )
    idx = idx.long()
    J = J.clone()
    rho = rho.clone()
    targets = [J[:, 0], J[:, 1], J[:, 2], rho]
    acc = [torch.zeros_like(rho) for _ in range(4)]
    for col, off, comp in plan:
        ix = idx + off
        ok = (ix >= 0) & (ix < n)
        acc[comp].index_add_(
            0, torch.where(ok, ix, 0),
            torch.where(ok, vals[:, col], 0.0).to(rho.dtype),
        )
    for t, a in zip(targets, acc):
        t += a
    return J, rho
