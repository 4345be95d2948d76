"""Relativistic particle pushes, vectorized over SoA particle columns.

The Vay leapfrog push of ``src/particle/electron.rs:268-330`` (as in
``opal_tpu/ops/pusher.py``), including the quantum parameter, the work
integral and the optical-depth decrement against the photon emission
rate; the Boris push of ``ion.rs:168-214`` for ions; and the ballistic
photon push of ``photon.rs:150-183``.  Callers that run no emission
pass ``tau=None`` and the decrement is skipped, which is what the
reference's non-emission runs amount to (tau is never consumed there).

Positions stay in [0, 1) as fractional cell offsets and the integer
cell index moves by at most one cell per step (CFL).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as const
from ..qed import emission


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=1,
    )


def _cell_fixup(cell, x, prev_x):
    """Shift the cell index when the fractional offset leaves [0, 1)
    (``electron.rs:319-329``): by the sign of floor(x), not floor(x).
    A NaN offset (a dead photon row of zero momentum in f32) leaves the
    cell where it is."""
    fl = torch.floor(x)
    shift = torch.where(fl < 0.0, -1, torch.where(fl > 0.0, 1, 0)).to(
        cell.dtype)
    return cell + shift, x - fl, prev_x - fl


class PushResult(NamedTuple):
    cell: torch.Tensor
    x: torch.Tensor
    prev_x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor
    gamma: torch.Tensor
    chi: torch.Tensor
    tau: torch.Tensor | None
    work: torch.Tensor
    #: the Lorentz factor at the half step, which the emission rate reads
    gamma_half: torch.Tensor


def vay_push(cell, x, y, z, u, gamma, tau, work, E, B, dx, dt, *,
             classical_rates=False, compute_dtype=None):
    """Vay et al. leapfrog push for electrons (electron.rs:268-330).

    ``u`` is p/(mc) with shape (N, 3); ``E``, ``B`` the fields at the
    particle, (N, 3).  Updates momentum, gamma, chi, the work integral
    and, unless ``tau`` is ``None``, the optical depth against the
    quantum (or, with ``classical_rates``, classical) emission rate.

    ``compute_dtype``: run the push arithmetic in this dtype and round
    only the stored state back to its own (``tau`` and ``work`` keep
    theirs), as opal_tpu does for mixed-precision QED decks: the f32
    chain's field-phase-correlated rounding bias is what kept their
    radiated-energy ledger above 1e-5 (``opal_tpu/ops/pusher.py:59-157``).
    """
    out_dtype = x.dtype
    wide = compute_dtype is not None and compute_dtype != out_dtype
    if wide:
        x, y, z, u, gamma, E, B = (
            a.to(compute_dtype) for a in (x, y, z, u, gamma, E, B))
    c = const.SPEED_OF_LIGHT
    v = c * u / gamma[:, None]

    # u_i = u_{i-1/2} + (q dt / 2 m c) (E + v x B)
    alpha = const.ELECTRON_CHARGE * dt / (2.0 * const.ELECTRON_MASS * c)
    u_half = u + alpha * (E + _cross(v, B))
    gamma_half = torch.sqrt(1.0 + _dot(u_half, u_half))
    work = work + const.ELECTRON_CHARGE * c * _dot(u_half, E) * dt / gamma_half

    # quantum parameter from F.u at the half step
    F = gamma_half[:, None] * E + c * _cross(u_half, B)
    eu = _dot(E, u_half)
    chi = (
        torch.sqrt(torch.clamp(_dot(F, F) - eu * eu, min=0.0))
        / const.CRITICAL_FIELD
    )
    if tau is not None:
        rate = emission.classical_rate if classical_rates else emission.rate
        tau = (tau - rate(chi, gamma_half) * dt).to(tau.dtype)

    # u' = u_i + (q dt / 2 m c) E
    u_prime = u_half + alpha * E
    gamma_prime_sqd = 1.0 + _dot(u_prime, u_prime)

    tau_v = alpha * c * B  # the Vay paper's tau vector
    u_star = _dot(u_prime, tau_v)
    t2 = _dot(tau_v, tau_v)
    sigma = gamma_prime_sqd - t2
    gamma_new = torch.sqrt(
        0.5 * sigma + torch.sqrt(0.25 * sigma * sigma + t2 + u_star * u_star)
    )

    t_v = tau_v / gamma_new[:, None]
    s = 1.0 / (1.0 + _dot(t_v, t_v))
    u_new = s[:, None] * (
        u_prime + _dot(u_prime, t_v)[:, None] * t_v + _cross(u_prime, t_v)
    )

    prev_x = x
    dxi = c * u_new[:, 0] * dt / (dx * gamma_new)
    x_new = x + dxi
    # transverse positions advance with the *old* velocity, as in the
    # reference (electron.rs:315-316)
    y_new = y + v[:, 1] * dt
    z_new = z + v[:, 2] * dt

    cell, x_new, prev_x = _cell_fixup(cell, x_new, prev_x)
    if wide:
        x_new, prev_x, y_new, z_new, u_new, gamma_new, chi, gamma_half = (
            a.to(out_dtype) for a in (x_new, prev_x, y_new, z_new, u_new,
                                      gamma_new, chi, gamma_half))
    return PushResult(cell, x_new, prev_x, y_new, z_new, u_new, gamma_new,
                      chi, tau, work, gamma_half)


def boris_push(cell, x, y, z, u, charge, mass, E, B, dx, dt):
    """Boris push for a species of per-row ``charge`` and ``mass``, (N,)
    tensors (``ion.rs:168-214``, ``opal_tpu/ops/pusher.py:160-207``).

    Returns updated (cell, x, prev_x, y, z, u, gamma_m1).  The Lorentz
    factor is kept as gamma - 1 in the cancellation-free form
    u^2 / (1 + sqrt(1 + u^2)), which non-relativistic ions need.  The
    quantum parameter opal_tpu also returns is discarded by its ion
    callers and not computed here."""
    c = const.SPEED_OF_LIGHT
    cB = c * B
    alpha = charge * dt / (2.0 * mass * c)

    u_minus = u + alpha[:, None] * E
    um2 = _dot(u_minus, u_minus)
    gamma = 1.0 + um2 / (1.0 + torch.sqrt(1.0 + um2))
    t = alpha / gamma
    u_prime = u_minus + t[:, None] * _cross(u_minus, cB)
    t_prime = 2.0 * t / (1.0 + t * t * _dot(cB, cB))
    u_plus = u_minus + t_prime[:, None] * _cross(u_prime, cB)

    u_new = u_plus + alpha[:, None] * E
    un2 = _dot(u_new, u_new)
    gamma_m1 = un2 / (1.0 + torch.sqrt(1.0 + un2))

    prev_x = x
    v = c * u_new / (1.0 + gamma_m1[:, None])
    x_new = x + v[:, 0] * dt / dx
    # transverse positions advance with the *new* velocity (ion.rs:208-209)
    y_new = y + v[:, 1] * dt
    z_new = z + v[:, 2] * dt

    cell, x_new, prev_x = _cell_fixup(cell, x_new, prev_x)
    return cell, x_new, prev_x, y_new, z_new, u_new, gamma_m1


def electron_chi(ux, uy, uz, gamma, E, B):
    """Instantaneous electron quantum parameter from the local fields:
    chi = |F.u| / (m c E_crit), the invariant the Vay push evaluates at
    the half step (``electron.rs:283-285``), here from the full-step
    momentum.  Refreshes the stale chi diagnostic of lite fused runs."""
    c = const.SPEED_OF_LIGHT
    fx = gamma * E[:, 0] + c * (uy * B[:, 2] - uz * B[:, 1])
    fy = gamma * E[:, 1] + c * (uz * B[:, 0] - ux * B[:, 2])
    fz = gamma * E[:, 2] + c * (ux * B[:, 1] - uy * B[:, 0])
    eu = E[:, 0] * ux + E[:, 1] * uy + E[:, 2] * uz
    return (
        torch.sqrt(torch.clamp(fx * fx + fy * fy + fz * fz - eu * eu, min=0.0))
        / const.CRITICAL_FIELD
    )


def photon_chi(k, E, B):
    """Instantaneous photon quantum parameter from the local fields
    (``photon.rs:165-176``); ``k`` in units of m_e c."""
    c = const.SPEED_OF_LIGHT
    k0 = torch.sqrt(torch.clamp(_dot(k, k), min=1.0e-300))
    F = k0[:, None] * E + c * _cross(k, B)
    ek = _dot(E, k)
    return (
        torch.sqrt(torch.clamp(_dot(F, F) - ek * ek, min=0.0))
        / const.CRITICAL_FIELD
    )


def photon_push(cell, x, y, z, k, E, B, dx, dt):
    """Ballistic photon push with the chi update (``photon.rs:150-183``).

    ``k`` is the photon momentum in units of m_e c.  Returns the updated
    (cell, x, prev_x, y, z, chi).  With ``E = B = None`` chi is not
    updated and comes back ``None``: without an absorption pass nothing
    reads it while stepping, and it is refreshed at output time
    (``Simulation.refresh_photon_chi``)."""
    c = const.SPEED_OF_LIGHT
    k0 = torch.sqrt(torch.clamp(_dot(k, k), min=1.0e-300))
    v = c * k / k0[:, None]
    chi = None if E is None else photon_chi(k, E, B)

    prev_x = x
    x_new = x + v[:, 0] * dt / dx
    y_new = y + v[:, 1] * dt
    z_new = z + v[:, 2] * dt

    cell, x_new, prev_x = _cell_fixup(cell, x_new, prev_x)
    return cell, x_new, prev_x, y_new, z_new, chi
