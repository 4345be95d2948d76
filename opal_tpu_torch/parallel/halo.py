"""Halo exchange at one device.

``opal_tpu/parallel/halo.py`` shifts edge cells around the device ring
with ``ppermute``; with a single device the permutation maps the device
to itself (the reference's self-send shortcut, ``yee.rs:365-369``), so
on a periodic grid the exchange is a local wrap and the current fold a
local add.  At a non-periodic global edge the halo is zero and the
spill is dropped (``opal_tpu/parallel/halo.py:39-90``).  Multi-device
exchange is not ported.
"""

from __future__ import annotations

import torch

from ..grid import HALO, GridGeometry


def _periodic(geom: GridGeometry) -> bool:
    if geom.n_devices != 1:
        raise NotImplementedError(
            "only the single-device halo exchange is ported"
        )
    return geom.left_boundary == "periodic"


def exchange_fields(E, B, geom: GridGeometry):
    """Halo-extended slabs (n_loc + 2 HALO, 3): on a periodic grid the
    last HALO owned cells are prepended and the first HALO appended (the
    reference's overlay_ghost field copy, ``yee.rs:97-104``, sent to
    itself); at non-periodic edges the halo cells are zero."""
    if _periodic(geom):
        E_slab = torch.cat([E[-HALO:], E, E[:HALO]])
        B_slab = torch.cat([B[-HALO:], B, B[:HALO]])
    else:
        E_slab = torch.nn.functional.pad(E, (0, 0, HALO, HALO))
        B_slab = torch.nn.functional.pad(B, (0, 0, HALO, HALO))
    return E_slab, B_slab


def fold_currents(J_slab, rho_slab, geom: GridGeometry):
    """Fold halo-deposited currents into the owned edge cells (the
    reference's overlay current add, ``yee.rs:105-113``): the left halo
    spill lands on the right edge and the right spill on the left edge;
    at non-periodic edges the spill is dropped.  Returns owned-only
    (n_loc, 3) J and (n_loc,) rho."""
    packed = torch.cat([J_slab, rho_slab[:, None]], dim=1)
    owned = packed[HALO:-HALO].clone()
    if _periodic(geom):
        owned[:HALO] += packed[-HALO:]
        owned[-HALO:] += packed[:HALO]
    return owned[:, :3], owned[:, 3]
