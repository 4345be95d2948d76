"""Halo exchange at one device.

``opal_tpu/parallel/halo.py`` shifts edge cells around the device ring
with ``ppermute``; with a single device the permutation maps the device
to itself (the reference's self-send shortcut, ``yee.rs:365-369``), so
on a periodic grid the exchange is a local wrap and the current fold a
local add.  Multi-device exchange is not ported.
"""

from __future__ import annotations

import torch

from ..grid import HALO, GridGeometry


def _check(geom: GridGeometry):
    if geom.n_devices != 1 or geom.left_boundary != "periodic":
        raise NotImplementedError(
            "only the single-device periodic halo exchange is ported"
        )


def exchange_fields(E, B, geom: GridGeometry):
    """Halo-extended slabs (n_loc + 2 HALO, 3): the last HALO owned
    cells are prepended and the first HALO appended (the reference's
    overlay_ghost field copy, ``yee.rs:97-104``, sent to itself)."""
    _check(geom)
    E_slab = torch.cat([E[-HALO:], E, E[:HALO]])
    B_slab = torch.cat([B[-HALO:], B, B[:HALO]])
    return E_slab, B_slab


def fold_currents(J_slab, rho_slab, geom: GridGeometry):
    """Fold halo-deposited currents into the owned edge cells (the
    reference's overlay current add, ``yee.rs:105-113``): the left halo
    spill lands on the right edge and the right spill on the left edge.
    Returns owned-only (n_loc, 3) J and (n_loc,) rho."""
    _check(geom)
    packed = torch.cat([J_slab, rho_slab[:, None]], dim=1)
    owned = packed[HALO:-HALO].clone()
    owned[:HALO] += packed[-HALO:]
    owned[-HALO:] += packed[:HALO]
    return owned[:, :3], owned[:, 3]
