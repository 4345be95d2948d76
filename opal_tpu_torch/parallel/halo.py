"""Halo exchange over the ring of ranks (``opal_tpu/parallel/halo.py``).

Each rank sends its HALO outermost owned cells to its ring neighbours
(``parallel.dist.Ring.shift``, the ``ppermute`` of opal_tpu).  At a
world of 1 the shift comes back to the rank itself, the reference's
self-send shortcut (``yee.rs:365-369``): on a periodic grid the
exchange is then a local wrap and the current fold a local add.  At a
non-periodic global edge the halo is zero and the spill is dropped.

The ``ring`` defaults to a world of 1.  The ``*_local`` forms serve the
replicated-field mode, where every rank holds the whole grid: the halo
is a local wrap or zeros, with no collective, and the caller sums the
folded currents over the ranks.
"""

from __future__ import annotations

import torch

from ..grid import HALO, GridGeometry
from .dist import SOLO, Ring


def _edges(ring: Ring, geom: GridGeometry):
    """(is_first, is_last): whether this rank's slab holds a
    non-periodic global edge, whose wrapped data is zeroed or dropped."""
    if geom.left_boundary == "periodic":
        return False, False
    return ring.rank == 0, ring.rank == geom.n_devices - 1


def exchange_fields(E, B, geom: GridGeometry, ring: Ring = SOLO):
    """Halo-extended slabs (n_loc + 2 HALO, 3): the left neighbour's
    rightmost HALO cells prepended and the right neighbour's leftmost
    appended (the reference's overlay_ghost field copy,
    ``yee.rs:97-104``); at a non-periodic global edge the halo cells are
    zero."""
    packed = torch.stack([E, B])
    from_left, from_right = ring.shift(packed[:, -HALO:], packed[:, :HALO])
    first, last = _edges(ring, geom)
    if first:
        from_left = torch.zeros_like(from_left)
    if last:
        from_right = torch.zeros_like(from_right)
    slab = torch.cat([from_left, packed, from_right], dim=1)
    return slab[0], slab[1]


def fold_currents(J_slab, rho_slab, geom: GridGeometry,
                  ring: Ring = SOLO):
    """Fold halo-deposited currents into the owners' edge cells (the
    reference's overlay current add, ``yee.rs:105-113``): this rank's
    left halo spill goes to its left neighbour's right edge and its
    right spill to the right neighbour's left edge; at a non-periodic
    global edge the spill is dropped.  Returns owned-only (n_loc, 3) J
    and (n_loc,) rho."""
    packed = torch.cat([J_slab, rho_slab[:, None]], dim=1)
    from_left, from_right = ring.shift(packed[-HALO:], packed[:HALO])
    first, last = _edges(ring, geom)
    owned = packed[HALO:-HALO].clone()
    if not first:
        owned[:HALO] += from_left
    if not last:
        owned[-HALO:] += from_right
    return owned[:, :3], owned[:, 3]


def exchange_fields_local(E, B, geom: GridGeometry):
    """:func:`exchange_fields` for the replicated-field mode
    (``opal_tpu/parallel/halo.py:97-111``): every rank holds the whole
    grid, so the halo is a local wrap (periodic) or zeros, with no
    collective."""
    return exchange_fields(E, B, geom, SOLO)


def fold_currents_local(J_slab, rho_slab, geom: GridGeometry):
    """:func:`fold_currents` for the replicated-field mode
    (``opal_tpu/parallel/halo.py:114-125``): the spill wraps locally
    (periodic) or is dropped.  The caller sums the folded (J, rho) over
    the ranks to combine their particle shards' deposits."""
    return fold_currents(J_slab, rho_slab, geom, SOLO)
