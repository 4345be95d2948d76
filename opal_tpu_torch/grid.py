"""Grid geometry and boundary conditions.

The global *extended* grid is the simulation interior plus any owned
boundary zones, laid out left to right:

``[ left zone | interior (nx cells) | right zone | dead padding ]``

(see ``opal_tpu/grid.py`` for the zone sizes, which follow the
reference's ``src/grid/yee.rs:239-242``).  Each device owns ``n_loc``
consecutive cells and exchanges ``HALO`` = 4 edge cells with its ring
neighbours.  The port runs one device, so the periodic grid is one slab
whose halo wraps onto itself; only the periodic boundary is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import constants as const

HALO = 4


@dataclass(frozen=True)
class GridGeometry:
    """Static description of the domain decomposition."""

    nx: int  # interior cells
    dx: float
    xmin: float  # x of the left edge of interior cell 0
    n_devices: int
    left_boundary: str = "periodic"  # 'periodic' | 'laser'
    right_boundary: str = "periodic"  # 'periodic' | 'absorbing' | 'conducting'
    left_pad: int = field(init=False)
    right_pad: int = field(init=False)
    n_dead: int = field(init=False)
    n_ext: int = field(init=False)  # total cells incl. zones and padding
    n_loc: int = field(init=False)  # owned cells per device

    def __post_init__(self):
        if self.left_boundary not in ("periodic", "laser"):
            raise ValueError(f"bad left boundary {self.left_boundary}")
        if self.right_boundary not in ("periodic", "absorbing", "conducting"):
            raise ValueError(f"bad right boundary {self.right_boundary}")
        periodic = self.left_boundary == "periodic"
        if periodic != (self.right_boundary == "periodic"):
            raise ValueError("periodic boundaries must be used on both sides")

        left_pad = 4 if self.left_boundary == "laser" else 0
        right_pad = {"periodic": 0, "absorbing": 200, "conducting": 4}[
            self.right_boundary
        ]
        n_dead = 0
        total = left_pad + self.nx + right_pad
        extra = (-total) % self.n_devices
        if extra:
            if self.right_boundary == "absorbing":
                right_pad += extra
            elif self.right_boundary == "conducting":
                n_dead = extra
            else:
                raise ValueError(
                    f"periodic grid: nx = {self.nx} must be divisible by "
                    f"n_devices = {self.n_devices}"
                )
        total = left_pad + self.nx + right_pad + n_dead
        n_loc = total // self.n_devices
        if n_loc < 2 * HALO:
            raise ValueError(
                f"each device must own at least {2 * HALO} cells; "
                f"got {n_loc} ({total} cells over {self.n_devices} devices)"
            )
        object.__setattr__(self, "left_pad", left_pad)
        object.__setattr__(self, "right_pad", right_pad)
        object.__setattr__(self, "n_dead", n_dead)
        object.__setattr__(self, "n_ext", total)
        object.__setattr__(self, "n_loc", n_loc)

    @property
    def interior_start(self) -> int:
        return self.left_pad

    @property
    def interior_end(self) -> int:
        return self.left_pad + self.nx

    def interior_x(self):
        """x of the left edges of all interior cells, host-side."""
        return self.xmin + np.arange(self.nx, dtype=np.float64) * self.dx


def global_cells(geom: GridGeometry, axis_index: int, device=None):
    """Extended-grid index of each owned slab cell on this device."""
    return axis_index * geom.n_loc + torch.arange(geom.n_loc, device=device)


def interior_mask(geom: GridGeometry, axis_index: int, device=None):
    g = global_cells(geom, axis_index, device)
    return (g >= geom.interior_start) & (g < geom.interior_end)


def apply_boundaries(E, B, geom: GridGeometry, axis_index, t, dt):
    """Load boundary conditions on the owned slab
    (``opal_tpu/grid.py:172-234``).  The periodic case loads nothing;
    the laser, absorbing and conducting boundaries are not ported."""
    if geom.left_boundary != "periodic":
        raise NotImplementedError(
            f"{geom.left_boundary}/{geom.right_boundary} boundaries are not "
            "ported; only periodic grids run"
        )
    return E, B


def em_field_energy_local(E, B, geom: GridGeometry, axis_index: int = 0):
    """Field energy (J) in this device's interior cells
    (``yee.rs:787-809``)."""
    mask = interior_mask(geom, axis_index, E.device)[:, None]
    e2 = torch.sum(torch.where(mask, E * E, 0.0))
    b2 = torch.sum(torch.where(mask, B * B, 0.0))
    return (
        0.5
        * (const.VACUUM_PERMITTIVITY * e2 + b2 / const.VACUUM_PERMEABILITY)
        * geom.dx
    )
