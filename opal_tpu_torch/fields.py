"""Field arrays, the electrostatic field set-up and the Silver-Müller
mask of the step."""

from __future__ import annotations

import torch

from . import constants as const
from .grid import HALO, GridGeometry


def zero_fields(geom: GridGeometry, dtype=torch.float64, device="cuda"):
    """Owned-cell field arrays (E, B, J, rho) of the whole extended grid
    (one device holds all of it)."""
    E = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    B = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    J = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    rho = torch.zeros((geom.n_ext,), dtype=dtype, device=device)
    return E, B, J, rho


def electrostatic_init(E, B, J, rho, geom: GridGeometry):
    """Consistent initial fields from the deposited charge and current
    (reference ``YeeGrid::initialize``, ``src/grid/yee.rs:644-747``;
    ``opal_tpu/fields.py:86-161`` at one device).  Solves, over the
    extended grid,

        dEx/dx = rho / eps0,   dBy/dx = mu0 jz,   dBz/dx = -mu0 jy,

    with boundary values from the infinite-sheet fields of the interior
    totals.  opal_tpu's device-parallel global cumsum is one
    ``torch.cumsum`` over the whole grid, in the field dtype.

    Returns updated (E, B); Ey, Ez and Bx are untouched.  The sweep
    starts after the left boundary zone, and left-zone cells get the
    boundary values added on top (``yee.rs:705-712``); a periodic grid
    sweeps from cell 0."""
    eps0 = const.VACUUM_PERMITTIVITY
    mu0 = const.VACUUM_PERMEABILITY
    dx = geom.dx

    g = torch.arange(geom.n_ext, device=E.device)
    interior = (g >= geom.interior_start) & (g < geom.interior_end)
    rho_tot = torch.where(interior, rho, 0.0).sum()
    jy_tot = torch.where(interior, J[:, 1], 0.0).sum()
    jz_tot = torch.where(interior, J[:, 2], 0.0).sum()

    dom_Ex = -rho_tot * dx / (2.0 * eps0)
    dom_By = -mu0 * jz_tot * dx / 2.0
    dom_Bz = mu0 * jy_tot * dx / 2.0

    sweep = g >= geom.left_pad

    def cumsum(c):
        return torch.cumsum(torch.where(sweep, c, 0.0), dim=0)

    cum_Ex = cumsum(dx * rho / eps0)
    cum_By = cumsum(mu0 * dx * J[:, 2])
    cum_Bz = cumsum(-mu0 * dx * J[:, 1])

    E, B = E.clone(), B.clone()
    E[:, 0] = torch.where(sweep, dom_Ex + cum_Ex, E[:, 0] + dom_Ex)
    B[:, 1] = torch.where(sweep, dom_By + cum_By, B[:, 1] + dom_By)
    B[:, 2] = torch.where(sweep, dom_Bz + cum_Bz, B[:, 2] + dom_Bz)
    return E, B


def sm_mask(geom: GridGeometry, device="cuda"):
    """Silver-Müller mask on the halo-extended slab: slab index 0
    (ghost-parity, see :func:`opal_tpu_torch.ops.maxwell.advance_e`)
    plus the global extended cell 0 when the left boundary injects a
    laser (``opal_tpu/fields.py:163-173``, at device 0)."""
    idx = torch.arange(geom.n_loc + 2 * HALO, device=device)
    mask = idx == 0
    if geom.left_boundary == "laser":
        mask = mask | (idx - HALO == 0)
    return mask
