"""Grid geometry and boundary conditions.

The global *extended* grid is the simulation interior plus any owned
boundary zones, laid out left to right:

``[ left zone | interior (nx cells) | right zone | dead padding ]``

* left zone: 4 cells when the left boundary is a laser injector
  (reference ``LASER_BDY_SIZE``, ``src/grid/yee.rs:240``), else empty
  (periodic);
* right zone: 200 cells for an absorbing boundary, 4 for a conducting
  mirror (``yee.rs:241-242``), else empty.

* dead padding rounds the total up to a multiple of the device count so
  every rank owns a slab of the same size.  For an absorbing boundary
  the padding is folded into the damping region instead; periodic runs
  need exact divisibility.

Each rank owns ``n_loc`` consecutive cells and exchanges ``HALO`` = 4
edge cells with its ring neighbours (``parallel.halo``).  Boundary
conditions are global-index masked operations: every rank runs the same
code with its rank as ``axis_index``, and the masks are non-zero only
where that rank owns boundary cells.
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


def balanced_counts(
    nx: int, xmin: float, dx: float, n_tasks: int,
    ne, min_subsize: int = 2 * HALO,
) -> np.ndarray:
    """Density-balanced domain split (reference ``src/grid/mod.rs:
    157-206``; ``opal_tpu/grid.py:111-147``): per-task interior cell
    counts chosen so that each task holds about the same number of real
    electrons (equal integral of ne dx), every task owning at least
    ``min_subsize`` cells.  As in opal_tpu, the field slabs stay of
    equal size (``GridGeometry``): the counts are reported in the
    banner, and the capacity is sized for the heaviest equal slab."""
    if n_tasks <= 0:
        raise ValueError("n_tasks must be positive")
    x = xmin + dx * np.arange(nx - min_subsize, dtype=np.float64)
    ppc = dx * np.broadcast_to(np.asarray(ne(x), dtype=np.float64), x.shape)
    cumsum = np.cumsum(ppc)
    target = cumsum[-1] / n_tasks if cumsum.size else 0.0
    counts = []
    start = 0
    for p in range(1, n_tasks):
        tail = cumsum[start + min_subsize:]
        i = int(np.argmax(tail >= target * p)) if tail.size else 0
        if tail.size and not (tail >= target * p).any():
            i = tail.size - 1
        counts.append(i + min_subsize)
        start += i + min_subsize
    counts.append(nx - sum(counts))
    return np.asarray(counts, dtype=np.int64)


def load_imbalance(geom: GridGeometry, ne) -> float:
    """Ratio of the heaviest equal slab's particle weight to the mean
    (``opal_tpu/grid.py:150-159``): 1.0 means the equal split is
    already balanced."""
    x = geom.interior_x()
    w = np.broadcast_to(np.asarray(ne(x), dtype=np.float64), x.shape)
    per_dev = np.zeros(geom.n_devices)
    dev = (np.arange(geom.nx) + geom.left_pad) // geom.n_loc
    np.add.at(per_dev, dev, w)
    mean = per_dev.mean()
    return float(per_dev.max() / mean) if mean > 0 else 1.0


def global_cells(geom: GridGeometry, axis_index: int, device=None):
    """Extended-grid index of each owned slab cell on this device."""
    return axis_index * geom.n_loc + torch.arange(geom.n_loc, device=device)


def interior_mask(geom: GridGeometry, axis_index: int, device=None):
    g = global_cells(geom, axis_index, device)
    return (g >= geom.interior_start) & (g < geom.interior_end)


def apply_boundaries(E, B, geom: GridGeometry, axis_index, t, dt,
                     laser_y=None, laser_z=None):
    """Load boundary conditions on the owned slab (reference:
    ``yee.rs:454-495``; ``opal_tpu/grid.py:172-234``), as masked
    global-index operations, in the reference's order: laser injection,
    then absorbing damping or the conducting mirror.

    ``E``/``B`` are owned-cell tensors of shape (n_loc, 3); ``t`` the
    simulation time, a host float; ``laser_y``/``laser_z`` host
    callables ``(t, x) -> float`` (default: no laser field).  The laser
    term is one scalar a step, evaluated on the host in f64.
    """
    g = global_cells(geom, axis_index, E.device)

    if geom.left_boundary == "laser":
        # inject at extended cell 2 = x_min - 2 dx (yee.rs:456-462)
        x_inj = geom.xmin - 2.0 * geom.dx
        r = const.SPEED_OF_LIGHT * dt / geom.dx
        inj_mask = (g == 2).to(E.dtype)
        E = E.clone()
        for comp, laser in ((1, laser_y), (2, laser_z)):
            if laser is not None:
                E[:, comp] += inj_mask * (2.0 * r * float(laser(t, x_inj)))

    if geom.right_boundary == "absorbing":
        # damping ramp over the absorbing zone except its first cell,
        # then a hard zero on the last two cells (yee.rs:464-479)
        g_abs0 = geom.interior_end  # first absorbing cell
        g_last = geom.n_ext - 1
        sigma_max = 10.0 / geom.right_pad
        frac = (g - g_abs0).to(torch.float64) / max(g_last - g_abs0, 1)
        factor = torch.where(
            (g > g_abs0) & (g <= g_last), 1.0 - sigma_max * frac, 1.0
        )
        zero = torch.where(g >= g_last - 1, 0.0, 1.0).to(torch.float64)
        scale = (factor * zero)[:, None].to(E.dtype)
        E = E * scale
        B = B * scale

    if geom.right_boundary == "conducting":
        # mirror about the surface at the left edge of cell g_c0
        # (yee.rs:480-494): tangential E and normal B are odd (zero at
        # the surface), normal E and tangential B take the
        # zero-gradient image
        g_c0 = geom.interior_end
        local = torch.arange(geom.n_loc, device=E.device)
        i = g - g_c0  # mirror-zone offset; valid where 0 <= i < 4
        in_zone = (i >= 0) & (i < 4)
        src_clamp = torch.clamp(local - 2 * i, 0, geom.n_loc - 1)
        src_zgrad = torch.clamp(local + 1 - 2 * i, 0, geom.n_loc - 1)
        surf = in_zone & (i == 0)
        deep = in_zone & (i > 0)
        Ex = torch.where(surf, 0.0, torch.where(deep, -E[src_clamp, 0],
                                                E[:, 0]))
        Ey = torch.where(deep, E[src_zgrad, 1], E[:, 1])
        Ez = torch.where(deep, E[src_zgrad, 2], E[:, 2])
        Bx = torch.where(deep, B[src_zgrad, 0], B[:, 0])
        By = torch.where(surf, 0.0, torch.where(deep, -B[src_clamp, 1],
                                                B[:, 1]))
        Bz = torch.where(surf, 0.0, torch.where(deep, -B[src_clamp, 2],
                                                B[:, 2]))
        E = torch.stack([Ex, Ey, Ez], dim=-1)
        B = torch.stack([Bx, By, Bz], dim=-1)

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
