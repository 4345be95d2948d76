"""Field arrays and the Silver-Müller mask of the step."""

from __future__ import annotations

import torch

from .grid import HALO, GridGeometry


def zero_fields(geom: GridGeometry, dtype=torch.float64, device="cuda"):
    """Owned-cell field arrays (E, B, J, rho) of the whole extended grid
    (one device holds all of it)."""
    E = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    B = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    J = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    rho = torch.zeros((geom.n_ext,), dtype=dtype, device=device)
    return E, B, J, rho


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
