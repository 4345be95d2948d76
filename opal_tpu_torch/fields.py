"""Field arrays, the electrostatic field set-up and the Silver-Müller
mask of the step."""

from __future__ import annotations

import torch

from . import constants as const
from .grid import HALO, GridGeometry, global_cells


def zero_fields(geom: GridGeometry, dtype=torch.float64, device="cuda"):
    """Owned-cell field arrays (E, B, J, rho) of one rank: its ``n_loc``
    cells (the whole extended grid on one device, and on every rank of
    the replicated-field mode, whose geometry has one device)."""
    E = torch.zeros((geom.n_loc, 3), dtype=dtype, device=device)
    B = torch.zeros((geom.n_loc, 3), dtype=dtype, device=device)
    J = torch.zeros((geom.n_loc, 3), dtype=dtype, device=device)
    rho = torch.zeros((geom.n_loc,), dtype=dtype, device=device)
    return E, B, J, rho


def electrostatic_init(E, B, J, rho, geom: GridGeometry, ring=None):
    """Consistent initial fields from the deposited charge and current
    (reference ``YeeGrid::initialize``, ``src/grid/yee.rs:644-747``;
    ``opal_tpu/fields.py:86-161``).  Solves, over the extended grid,

        dEx/dx = rho / eps0,   dBy/dx = mu0 jz,   dBz/dx = -mu0 jy,

    with boundary values from the infinite-sheet fields of the interior
    totals.  The reference's rank-serial prefix chain becomes a global
    cumulative sum: the local ``torch.cumsum`` plus the exclusive prefix
    of the ranks' totals (an all-gather), and the totals are summed over
    the ``ring`` (``parallel.dist.Ring``) of the domain decomposition.
    ``ring=None``: the inputs are already global (one device, or the
    replicated-field mode after the caller's sum of J and rho) and no
    collective is issued.

    Returns updated (E, B); Ey, Ez and Bx are untouched.  The sweep
    starts after the left boundary zone, and left-zone cells get the
    boundary values added on top (``yee.rs:705-712``); a periodic grid
    sweeps from cell 0."""
    eps0 = const.VACUUM_PERMITTIVITY
    mu0 = const.VACUUM_PERMEABILITY
    dx = geom.dx
    rank = 0 if ring is None else ring.rank

    g = global_cells(geom, rank, E.device)
    interior = (g >= geom.interior_start) & (g < geom.interior_end)
    tot = torch.stack([torch.where(interior, rho, 0.0).sum(),
                       torch.where(interior, J[:, 1], 0.0).sum(),
                       torch.where(interior, J[:, 2], 0.0).sum()])
    if ring is not None:
        tot = ring.psum(tot)
    rho_tot, jy_tot, jz_tot = tot

    dom_Ex = -rho_tot * dx / (2.0 * eps0)
    dom_By = -mu0 * jz_tot * dx / 2.0
    dom_Bz = mu0 * jy_tot * dx / 2.0

    sweep = g >= geom.left_pad
    cum = torch.cumsum(torch.where(sweep[:, None], torch.stack(
        [dx * rho / eps0, mu0 * dx * J[:, 2], -mu0 * dx * J[:, 1]], dim=1),
        0.0), dim=0)
    if ring is not None and ring.group is not None:
        totals = ring.all_gather(cum[-1])
        before = (torch.arange(ring.world, device=E.device) < rank)[:, None]
        cum = cum + torch.where(before, totals, 0.0).sum(dim=0)
    cum_Ex, cum_By, cum_Bz = cum.unbind(1)

    E, B = E.clone(), B.clone()
    E[:, 0] = torch.where(sweep, dom_Ex + cum_Ex, E[:, 0] + dom_Ex)
    B[:, 1] = torch.where(sweep, dom_By + cum_By, B[:, 1] + dom_By)
    B[:, 2] = torch.where(sweep, dom_Bz + cum_Bz, B[:, 2] + dom_Bz)
    return E, B


def sm_mask(geom: GridGeometry, device="cuda", axis_index: int = 0):
    """Silver-Müller mask on the halo-extended slab: slab index 0
    (ghost-parity, see :func:`opal_tpu_torch.ops.maxwell.advance_e`)
    plus the global extended cell 0 when the left boundary injects a
    laser (``opal_tpu/fields.py:163-173``), which lies on rank 0."""
    idx = torch.arange(geom.n_loc + 2 * HALO, device=device)
    mask = idx == 0
    if geom.left_boundary == "laser":
        mask = mask | (axis_index * geom.n_loc + idx - HALO == 0)
    return mask
