"""Field arrays and the Silver-Müller mask of the step."""

from __future__ import annotations

import torch

from .grid import HALO, GridGeometry


def zero_fields(geom: GridGeometry, dtype=torch.float64, device="cpu"):
    """Owned-cell field arrays (E, B, J, rho) of the whole extended grid
    (one device holds all of it)."""
    E = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    B = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    J = torch.zeros((geom.n_ext, 3), dtype=dtype, device=device)
    rho = torch.zeros((geom.n_ext,), dtype=dtype, device=device)
    return E, B, J, rho


def sm_mask(geom: GridGeometry, device="cpu"):
    """Silver-Müller mask on the halo-extended slab of a periodic grid:
    slab index 0 only (ghost-parity, see
    :func:`opal_tpu_torch.ops.maxwell.advance_e`).  A laser boundary
    would add its injection cell; lasers are not ported."""
    return torch.arange(geom.n_loc + 2 * HALO, device=device) == 0
