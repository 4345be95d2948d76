"""Particle species: fixed-capacity structure-of-arrays state.

As in ``opal_tpu/species.py``, a species is a set of per-field columns
with a fixed capacity and an ``alive`` mask (the reference's
``Population<T>``, ``src/particle/mod.rs:141-376``), here as a
dataclass of torch tensors.  Momentum ``u`` is p/(mc) for massive
species and the momentum in units of m_e c for photons; ``gamma`` the
Lorentz factor, or |k| for photons.  Emission appends photons by
claiming dead slots (``parallel.migrate.insert``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import constants as const
from .grid import GridGeometry


@dataclasses.dataclass
class ParticleState:
    """Per-device SoA particle storage (all columns length = capacity).

    Optional per-species columns are ``None`` when unused: ``tau``/
    ``work`` exist for electrons, ``tau_abs``/``tau_st``/``birth_time``
    for photons.
    """

    cell: torch.Tensor  # (N,) int32, device-local owned-cell index
    x: torch.Tensor  # (N,) fractional offset in [0, 1)
    prev_x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    weight: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    gamma: torch.Tensor
    chi: torch.Tensor
    tau: torch.Tensor | None
    tau_abs: torch.Tensor | None
    tau_st: torch.Tensor | None
    work: torch.Tensor | None
    birth_time: torch.Tensor | None
    alive: torch.Tensor  # (N,) bool
    pol: torch.Tensor | None = None
    basis: torch.Tensor | None = None

    @property
    def u(self) -> torch.Tensor:
        """(N, 3) stack of the momentum columns."""
        return torch.stack([self.ux, self.uy, self.uz], dim=1)

    def columns(self) -> dict:
        """The non-None columns by name, in dataclass order."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }


@dataclasses.dataclass(frozen=True)
class SpeciesSpec:
    """Static description of a species."""

    name: str
    kind: str  # 'electron' | 'ion' | 'photon'
    charge: float = 0.0  # SI, per real particle
    mass: float = 0.0  # SI
    output: tuple[str, ...] = ()

    @staticmethod
    def electron(output=()) -> "SpeciesSpec":
        return SpeciesSpec(
            "electron", "electron", const.ELECTRON_CHARGE, const.ELECTRON_MASS,
            tuple(output),
        )

    @staticmethod
    def ion(name, charge_state, mass_number, output=()) -> "SpeciesSpec":
        """An ion of charge Z e and mass A m_p (``ion.rs:236-241``)."""
        return SpeciesSpec(
            name, "ion", charge_state * const.ELEMENTARY_CHARGE,
            mass_number * const.PROTON_MASS, tuple(output),
        )

    @staticmethod
    def photon(output=()) -> "SpeciesSpec":
        return SpeciesSpec("photon", "photon", 0.0, 0.0, tuple(output))


def dead_default(fname: str, is_photon: bool) -> float:
    """Dead-slot fill value for one column: tau columns are +inf so dead
    slots never trigger emission/absorption; photon gamma is |k| = 0,
    massive gamma 1 so energy formulas stay finite."""
    if fname in ("tau", "tau_abs", "tau_st"):
        return np.inf
    if fname == "birth_time":
        return -np.inf
    if fname == "gamma":
        return 0.0 if is_photon else 1.0
    return 0.0


def _empty_fields(spec: SpeciesSpec, n: int, dtype, work_dtype=None):
    fields = {
        f.name: None for f in dataclasses.fields(ParticleState)
    }
    fields.update(
        cell=np.zeros(n, np.int32),
        alive=np.zeros(n, bool),
        **{
            k: np.full(n, dead_default(k, spec.kind == "photon"), dtype)
            for k in ("x", "prev_x", "y", "z", "weight", "ux", "uy", "uz",
                      "gamma", "chi")
        },
    )
    if spec.kind == "electron":
        fields["tau"] = np.full(n, np.inf, dtype)
        # the work integral accumulates every step for the whole run:
        # under mixed precision it lives in the field dtype (f64)
        fields["work"] = np.zeros(n, work_dtype or dtype)
    if spec.kind == "photon":
        fields.update(
            tau_abs=np.full(n, np.inf, dtype),
            tau_st=np.full(n, np.inf, dtype),
            birth_time=np.full(n, -np.inf, dtype),
            pol=np.zeros((n, 4), dtype),
            basis=np.zeros((n, 6), dtype),
        )
    return fields


def initialize(
    spec: SpeciesSpec,
    geom: GridGeometry,
    npc: int,
    density: Callable,
    ux: Callable,
    uy: Callable,
    uz: Callable,
    dt: float,
    capacity_per_device: int,
    seed: int = 0,
    dtype=np.float64,
    work_dtype=None,
    device="cuda",
) -> ParticleState:
    """Sample the initial distribution (``mod.rs:172-203``) host-side
    with numpy, draw for draw as ``opal_tpu.species.initialize``, and
    place the columns on ``device``.

    Per interior cell: ``nreal = density(x_centre) * dx`` real particles
    shared equally by ``npc`` macroparticles; positions uniform in the
    cell; momenta from ``u*(x, urand, nrand)``; electron optical depths
    ~ Exp(1) (ions draw none and carry no tau or work column); photons
    their absorption and stimulated-emission depths, unpolarized with
    the placeholder basis [k, k].
    The arrays have shape (n_devices * capacity_per_device,) with each
    device's particles in its own contiguous block.
    """
    rng = np.random.default_rng(seed)
    fields = _empty_fields(
        spec, geom.n_devices * capacity_per_device, dtype, work_dtype
    )

    if npc > 0:
        cells = np.arange(geom.nx)
        x_centre = geom.xmin + (cells + 0.5) * geom.dx
        nreal = (
            np.broadcast_to(
                np.asarray(density(x_centre), dtype=np.float64), x_centre.shape
            )
            * geom.dx
        )
        active = nreal > 0.0
        weights = np.where(active, nreal / npc, 0.0)

        cell_rep = np.repeat(cells[active], npc)
        w_rep = np.repeat(weights[active], npc)
        n = cell_rep.size

        xi = rng.random(n)
        real_x = geom.xmin + (cell_rep + xi) * geom.dx
        u = np.stack(
            [
                np.broadcast_to(
                    np.asarray(f(real_x, rng.random(n), rng.standard_normal(n)),
                               dtype=np.float64), (n,)
                )
                for f in (ux, uy, uz)
            ],
            axis=-1,
        )

        g = cell_rep + geom.left_pad
        dev = g // geom.n_loc
        local_cell = g - dev * geom.n_loc

        counts = np.bincount(dev, minlength=geom.n_devices)
        if counts.max() > capacity_per_device:
            raise ValueError(
                f"species {spec.name}: device particle count "
                f"{counts.max()} exceeds capacity {capacity_per_device}"
            )

        order = np.argsort(dev, kind="stable")
        slot_in_dev = np.empty(n, np.int64)
        start = 0
        for d, cnt in enumerate(counts):
            sel = order[start : start + cnt]
            slot_in_dev[sel] = np.arange(cnt)
            start += cnt
        slots = dev * capacity_per_device + slot_in_dev

        u2 = np.sum(u * u, axis=-1)
        if spec.kind == "photon":
            gamma = np.sqrt(u2)  # |k|
            vx_over_c = np.where(gamma > 0,
                                 u[:, 0] / np.maximum(gamma, 1e-300), 0.0)
        else:
            gamma = np.sqrt(1.0 + u2)
            vx_over_c = u[:, 0] / gamma
        prev_x = xi - const.SPEED_OF_LIGHT * vx_over_c * dt / geom.dx

        fields["cell"][slots] = local_cell.astype(np.int32)
        fields["x"][slots] = xi
        fields["prev_x"][slots] = prev_x
        fields["weight"][slots] = w_rep
        fields["ux"][slots] = u[:, 0]
        fields["uy"][slots] = u[:, 1]
        fields["uz"][slots] = u[:, 2]
        fields["gamma"][slots] = gamma
        fields["alive"][slots] = True
        if spec.kind == "electron":
            fields["tau"][slots] = rng.exponential(size=n)
        if spec.kind == "photon":
            # the reference's draw order (photon.rs:126-133)
            rng.exponential(size=n)  # tau[0], unused
            rng.exponential(size=n)  # tau[1], unused
            fields["tau_abs"][slots] = rng.exponential(size=n)
            fields["tau_st"][slots] = rng.exponential(size=n)
            fields["birth_time"][slots] = 0.0
            fields["basis"][slots, 0:3] = u
            fields["basis"][slots, 3:6] = u

    return ParticleState(**{
        k: None if v is None else torch.from_numpy(v).to(device)
        for k, v in fields.items()
    })


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator for the seed ``seed``
    (opal_tpu folds the rank into its key, ``opal_tpu/sim.py:1143,
    1176``, ``opal_tpu/species.py:368``): the seed itself on rank 0, so
    a world of 1 draws what a one-device run draws."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> 1)


def initialize_device(
    spec: SpeciesSpec,
    geom: GridGeometry,
    npc: int,
    density: Callable,
    ux: Callable,
    uy: Callable,
    uz: Callable,
    dt: float,
    capacity_per_device: int,
    seed: int = 0,
    dtype=torch.float64,
    work_dtype=None,
    rank: int = 0,
    device="cuda",
) -> ParticleState:
    """Sample rank ``rank``'s block of the initial distribution on
    ``device`` (``opal_tpu/species.py:305-450``): the ``capacity_per_device``
    rows that :func:`rank_rows` would cut from opal_tpu's sharded result.

    Only the rank's per-cell weights cross from the host (``density``
    is evaluated with numpy at the nx cell centres).  Row ``lane`` holds
    the ``lane % npc``-th particle of local cell ``lane // npc`` while
    ``lane < n_loc * npc``; a row is alive where its cell's weight is
    positive.  The draws come from one ``torch.Generator`` on ``device``
    seeded with :func:`rank_seed` of ``seed``, in the order xi, urand,
    nrand, then tau for electrons or tau_abs and tau_st for photons, a
    ``(capacity,)`` column each (opal_tpu draws from threefry keys
    folded by rank: the same distribution, other numbers).  The
    momentum callables take and return torch tensors on ``device``.
    Dead rows take opal_tpu's values: x, prev_x, weight and u 0, gamma
    1 (photons 0), the depths inf, ``birth_time`` -inf.
    """
    n_loc, cap = geom.n_loc, capacity_per_device
    if npc > 0 and cap < n_loc * npc:
        raise ValueError(
            f"device init needs capacity >= n_loc*npc = {n_loc * npc}, "
            f"got {cap}")
    x_centre = geom.xmin + (np.arange(geom.nx) + 0.5) * geom.dx
    nreal = np.broadcast_to(
        np.asarray(density(x_centre), dtype=np.float64), x_centre.shape
    ) * geom.dx
    w_cell = np.zeros(geom.n_ext, np.float64)
    if npc > 0:
        w_cell[geom.interior_start:geom.interior_end] = np.where(
            nreal > 0.0, nreal / npc, 0.0)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(seed, rank))
    w_loc = torch.from_numpy(w_cell[rank * n_loc:(rank + 1) * n_loc]).to(
        device=dev, dtype=dtype)

    lane = torch.arange(cap, device=dev)
    in_range = lane < n_loc * npc
    local_cell = torch.where(in_range, lane // max(npc, 1), 0)
    w = torch.where(in_range, w_loc[local_cell], 0.0)
    alive = in_range & (w > 0.0)
    local_cell = local_cell.to(torch.int32)

    def uniform():
        return torch.rand(cap, generator=gen, dtype=dtype, device=dev)

    def exponential():
        return torch.empty(cap, dtype=dtype, device=dev).exponential_(
            generator=gen)

    xi = uniform()
    g = rank * n_loc + local_cell  # extended-grid cell
    real_x = (g - geom.left_pad + xi) * geom.dx + geom.xmin
    urand = uniform()
    nrand = torch.randn(cap, generator=gen, dtype=dtype, device=dev)
    u = torch.stack([
        torch.broadcast_to(torch.as_tensor(f(real_x, urand, nrand),
                                           dtype=dtype, device=dev), (cap,))
        for f in (ux, uy, uz)], dim=-1)
    u2 = torch.sum(u * u, dim=-1)
    photon = spec.kind == "photon"
    if photon:
        k0 = torch.sqrt(u2)
        vx_over_c = torch.where(k0 > 0, u[:, 0] / torch.clamp(k0, min=1e-30),
                                0.0)
        gamma_like = k0
    else:
        gamma_like = torch.sqrt(1.0 + u2)
        vx_over_c = u[:, 0] / gamma_like
    prev_x = xi - const.SPEED_OF_LIGHT * vx_over_c * dt / geom.dx

    def live(a, dead=0.0):
        return torch.where(alive, a, dead)

    zero = torch.zeros(cap, dtype=dtype, device=dev)
    fields = dict(
        cell=local_cell, x=live(xi), prev_x=live(prev_x), y=zero,
        z=zero.clone(), weight=live(w), ux=live(u[:, 0]), uy=live(u[:, 1]),
        uz=live(u[:, 2]), gamma=live(gamma_like, 0.0 if photon else 1.0),
        chi=zero.clone(), tau=None, tau_abs=None, tau_st=None, work=None,
        birth_time=None, alive=alive)
    if spec.kind == "electron":
        fields["tau"] = live(exponential(), np.inf)
        fields["work"] = torch.zeros(cap, dtype=work_dtype or dtype,
                                     device=dev)
    if photon:
        fields["tau_abs"] = live(exponential(), np.inf)
        fields["tau_st"] = live(exponential(), np.inf)
        fields["birth_time"] = live(zero, -np.inf)
        fields["pol"] = torch.zeros((cap, 4), dtype=dtype, device=dev)
        fields["basis"] = torch.where(alive[:, None], torch.cat([u, u], 1),
                                      0.0)
    return ParticleState(**fields)


def kinetic_energy_weights(spec: SpeciesSpec, state: ParticleState):
    """Per-particle kinetic energy in joules (macroparticle), with
    gamma - 1 in a cancellation-free form: u^2 / (gamma + 1) for
    electrons (``electron.rs:122-126``), u^2 / (1 + sqrt(1 + u^2)) times
    the mass ratio for ions (``ion.rs:128-134``); |k| for photons
    (``photon.rs:224-226``)."""
    to_joules = 1.0e6 * const.ELECTRON_MASS_MEV * const.ELEMENTARY_CHARGE
    u2 = state.ux * state.ux + state.uy * state.uy + state.uz * state.uz
    if spec.kind == "photon":
        ke = state.weight * state.gamma * to_joules
    elif spec.kind == "ion":
        gamma_m1 = u2 / (1.0 + torch.sqrt(1.0 + u2))
        ke = state.weight * gamma_m1 * (spec.mass / const.ELECTRON_MASS) \
            * to_joules
    else:
        ke = state.weight * u2 / (state.gamma + 1.0) * to_joules
    return torch.where(state.alive, ke, 0.0)


def rank_rows(state: ParticleState, rank: int, capacity: int,
              device=None) -> ParticleState:
    """Rank ``rank``'s rows ``[rank * capacity, (rank + 1) * capacity)``
    of a state in opal_tpu's per-device block layout (what
    :func:`initialize` builds for ``n_devices`` ranks and :func:`
    shard_even` for the replicated-field mode), as copies on ``device``
    (default: the state's)."""
    lo = rank * capacity

    def take(a):
        if a is None:
            return None
        return a[lo:lo + capacity].to(device or a.device, copy=True)

    return ParticleState(**{f.name: take(getattr(state, f.name))
                            for f in dataclasses.fields(state)})


def shard_even(state: ParticleState, n_shards: int,
               capacity_per_shard: int) -> ParticleState:
    """The replicated-field mode's particle decomposition
    (``opal_tpu/species.py:476-516``): a one-device state whose alive
    rows form a prefix, ordered by cell (:func:`initialize` on a
    one-device geometry), re-chunked into ``n_shards`` contiguous chunks
    of equal count, each padded with dead rows to
    ``capacity_per_shard``.  Equal-count chunks of a cell-ordered
    population are the reference's density-balanced split
    (``grid/mod.rs:157-206``)."""
    n_alive = int(state.alive.sum())
    if not bool(state.alive[:n_alive].all()):
        raise ValueError("shard_even needs an alive-prefix layout")
    chunk = -(-n_alive // n_shards) if n_alive else 0
    if chunk > capacity_per_shard:
        raise ValueError(
            f"shard chunk {chunk} exceeds capacity {capacity_per_shard}")
    is_photon = state.tau_abs is not None
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if a is None:
            out[f.name] = None
            continue
        new = torch.full((n_shards * capacity_per_shard,) + a.shape[1:],
                         dead_default(f.name, is_photon), dtype=a.dtype,
                         device=a.device)
        for s in range(n_shards):
            lo = min(s * chunk, n_alive)
            hi = min(lo + chunk, n_alive)
            base = s * capacity_per_shard
            new[base:base + hi - lo] = a[lo:hi]
        out[f.name] = new
    return ParticleState(**out)
