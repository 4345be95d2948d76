"""1D Yee/FDTD field advance on a device-local slab.

Explicit second-order finite-difference time-domain update of
Maxwell's equations (reference: ``src/grid/yee.rs:839-867``); a slab is
the owned cells bracketed by halo cells, and the timestep sequence is
B(dt/2), E(dt), B(dt/2) (``yee.rs:345-349``).  The Silver-Müller
absorber is applied where ``sm_mask`` is set (always slab index 0, a
halo cell overwritten at the next exchange, as in the reference).
"""

from __future__ import annotations

import torch

from .. import constants as const


def advance_b(E, B, dt, dx):
    """Half/full B advance: B_y += dt d_x E_z, B_z -= dt d_x E_y over
    cells [0, n-1); the last cell is left untouched (``yee.rs:839-848``).
    """
    dEy = E[1:, 1] - E[:-1, 1]
    dEz = E[1:, 2] - E[:-1, 2]
    B = B.clone()
    B[:-1, 1] = B[:-1, 1] + dt * dEz / dx
    B[:-1, 2] = B[:-1, 2] - dt * dEy / dx
    return B


def advance_e(E, B, J, dt, dx, sm_mask):
    """Full E advance (``yee.rs:852-866``); ``sm_mask`` selects the
    cells where the Silver-Müller outgoing-wave update replaces the
    regular stencil."""
    c = const.SPEED_OF_LIGHT
    c2 = const.SPEED_OF_LIGHT_SQD
    eps0 = const.VACUUM_PERMITTIVITY

    kappa = 2.0 * c * dt / (c * dt + dx)
    sigma = 1.0 - kappa
    sm = torch.stack(
        [
            torch.zeros_like(E[:, 0]),
            sigma * E[:, 1] - c * kappa * B[:, 2],
            sigma * E[:, 2] + c * kappa * B[:, 1],
        ],
        dim=-1,
    )

    B_left = torch.roll(B, 1, dims=0)  # index 0 wraps; masked by sm below
    Ex = E[:, 0] - dt * J[:, 0] / eps0
    Ey = E[:, 1] + dt * c2 * (B_left[:, 2] - B[:, 2]) / dx - dt * J[:, 1] / eps0
    Ez = E[:, 2] + dt * c2 * (B[:, 1] - B_left[:, 1]) / dx - dt * J[:, 2] / eps0
    regular = torch.stack([Ex, Ey, Ez], dim=-1)

    return torch.where(sm_mask[:, None], sm, regular)


def advance(E, B, J, dt, dx, sm_mask):
    """One full field step: B(dt/2), E(dt), B(dt/2)."""
    B = advance_b(E, B, 0.5 * dt, dx)
    E = advance_e(E, B, J, dt, dx, sm_mask)
    B = advance_b(E, B, 0.5 * dt, dx)
    return E, B
