"""The particle-in-cell simulation core: the step of electrons, ions
and photons, with QED photon emission, absorption and stimulated
emission.

One step, in the reference's hot-loop order (``src/main.rs:238-267``)
and ``opal_tpu/sim.py``'s (``:1020-1247``), on each rank of a ring
(``parallel.dist.Ring``; one device is a world of 1):

1. refresh the halo fields from the ring neighbours (at a world of 1 a
   local wrap on the periodic grid; zeros at non-periodic global
   edges);
2. push each species: the fused CUDA kernel (gather + Vay push for
   electrons or Boris push for ions [+ deposit]) plus the compacted
   fallback for rows outside their block window (one more kernel, of
   a fixed capacity, that reads nothing back), on the column
   layout or, with ``packed_fused``, on the packed one, or the unfused
   ops for species the kernel cannot take (photons fly ballistically,
   and with absorption on update their chi from the fields); with
   emission on, the electrons' optical depths fall by the emission rate
   at the half-step chi and gamma;
3. migrate leavers to the neighbours when the exchange runs every step
   (on a non-periodic grid, rows that leave the interior are deleted);
4. photon absorption and stimulated emission (``interactions.absorb``:
   bracketed on the fused electron path, else over a per-step sort),
   then photon emission (``interactions.emit_radiation``);
5. deposit the unfused species and fold the halo currents into the
   neighbours' edge cells;
6. load the boundaries (laser injection, absorbing ramp, conducting
   mirror) and the Yee field advance.

``run`` is an eager Python loop over the same static phase schedule as
``opal_tpu``: a maintenance sort opens every R-step period and a
migration phase closes every M-step block.  Loss counters are device
int64 tensors, summed over the ranks once a ``run`` call.  The QED
passes take their random numbers from the ``rng`` that ``run`` is
given.  With an extra-output feature on, the absorption events go into
a ring (``zero_events``) that ``run`` threads and returns.

In the replicated-field mode (``SimOptions.replicate_fields``, opal_tpu's
load balancer for nonuniform decks) every rank holds the whole grid and
an equal-count chunk of the particles: the halo is local, the folded
currents are summed over the ranks every step, no particle moves
between ranks (crossings wrap or die in place), and the absorption pass
pairs each photon with the electrons of every rank.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import constants as const
from . import trace
from .interactions import absorb, emit_radiation
from .fields import electrostatic_init, sm_mask, zero_fields
from .grid import HALO, GridGeometry, apply_boundaries, em_field_energy_local
from .ops import fused as F
from .ops import maxwell
from .ops.deposit import deposit
from .ops.interp import fields_at
from .ops.pusher import (
    boris_push, electron_chi, photon_chi, photon_push, vay_push,
)
from .qed import emission
from .parallel import halo
from .parallel.dist import Ring
from .parallel.migrate import (
    migrate_compact, migrate_edges, migrate_edges_packed, sort_packed,
    sort_state, wrap_kill, wrap_kill_packed,
)
from .species import ParticleState, SpeciesSpec, kinetic_energy_weights


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """Static switches of the step (the fields of
    ``opal_tpu.sim.SimOptions`` that the ported paths read)."""

    dt: float
    current_deposition: bool = True
    # QED photon emission (the reference's cargo features become the
    # switches below, off = the feature flag set)
    photon_emission: bool = False
    photon_absorption: bool = False
    radiation_reaction: bool = True  # no_radiation_reaction inverted
    beaming: bool = True  # no_beaming inverted
    stimulated_emission: bool = True  # no_stimulated_emission inverted
    immobile_photons: bool = False
    # per-event absorption/stimulated-emission records
    # (interactions.rs:267-289) go into a ring of event_log_capacity
    # rows that run() threads; the CLI drains it at each output
    extra_absorption_output: bool = False
    extra_stimulated_emission_output: bool = False
    event_log_capacity: int = 4096
    # emission filters (main.rs:81-83): MeV, rad about -x, m
    photon_energy_min: float | None = None
    photon_angle_max: float | None = None
    max_formation_length: float | None = None
    # absorption controls (main.rs:84-85): the transverse displacement
    # (m) and photon age (s) past which a photon no longer pairs
    max_displacement: float | None = None
    absorption_stop_time: float | None = None
    # absorption events (absorbed + stimulated) a step; the events past
    # it are cancelled and walk again next step, counted as deferred
    absorption_event_capacity: int = 4096
    # electrons of its cell a photon walks a step, in passes of
    # absorption_block; a photon of a fuller cell is counted as deferred
    absorption_candidates: int = 64
    absorption_block: int = 32
    # photons walked a step (0: every photon with cell-mates); the rest
    # walk later, counted as deferred
    absorption_active_capacity: int = 0
    # emitters sampled per step (0: every electron row); the rest emit
    # on a later step, counted as deferred
    emission_active_capacity: int = 0
    # photons inserted per step (-1: max(16384, active / 8); 0:
    # unbounded); the emitters beyond are deferred without recoil
    emission_insert_capacity: int = -1
    # mixed-precision QED decks: the unfused electron push computes in
    # the field dtype (f64) and rounds only the stored state
    push_f64_compute: bool = False
    seed: int = 0
    # the edge exchange (off: a bench ablation; the fused kernel then
    # serves no species, as in opal_tpu)
    migration: bool = True
    # leavers sent per side per exchange; more are counted as losses
    migration_capacity: int = 4096
    # upper bound on any particle's per-step cell drift, in cells (the
    # CFL default 0.95 is always safe); slow decks may defer migration
    # until drift * M reaches the 2-cell deposit/gather reach
    max_drift_cells_per_step: float = 0.95
    # the fused CUDA kernel for electrons and ions (f32 state, capacity
    # a multiple of fused_block); alive rows outside their block window
    # go through a compacted fallback of fused_misfit_capacity rows per
    # step, and any excess is counted as a loss
    fused_pusher: bool = False
    fused_block: int = 4096
    fused_window: int = 32
    fused_misfit_capacity: int = 1024
    # the lite kernel form (no prev_x, gh, chi outputs) where nothing
    # reads them: ions, and electrons of decks without QED (-1: auto;
    # 0: the full form for every species)
    fused_lite: int = -1
    # the packed layout for fused species (ops.fused.PackedState): run()
    # packs them once on entry and unpacks them once on exit, and the
    # step runs the packed kernel on them; not with QED emission, whose
    # passes read columns.  Under mixed precision the work integral then
    # accumulates in f32 inside the packed matrix, as in opal_tpu
    packed_fused: bool = False
    # resort cadence R: a local re-sort (migrate.sort_state) opens every
    # R-step period; between sorts the kernel re-anchors each block from
    # its own fit-row minimum
    fused_resort_every: int = 1
    # migration cadence M: the edge exchange closes every M-step block
    # (M == 1: inline in every step)
    migration_every: int = 1
    # head/tail rows the edge exchange of a cell-sorted species scans
    migration_window: int = 16384
    # the replicated-field mode: every rank holds the whole grid (a
    # geometry of one device) and an equal-count chunk of the particles;
    # the folded currents are summed over the ranks each step, no
    # particle moves between ranks, and photons pair with the electrons
    # of every rank
    replicate_fields: bool = False


class Carry(NamedTuple):
    """The state the step loop threads: fields, species, time, loss
    counters, the per-species kernel window bases and the event ring
    (``None`` without the event log)."""

    E: torch.Tensor
    B: torch.Tensor
    J: torch.Tensor
    rho: torch.Tensor
    species: dict
    t: float
    counters: dict
    anchors: dict
    events: tuple | None = None


class Simulation:
    """Geometry, options and species of one run, on one rank."""

    def __init__(
        self,
        geom: GridGeometry,
        options: SimOptions,
        species: dict[str, SpeciesSpec],
        device="cuda",
        dtype=torch.float64,
        field_dtype=None,
        laser_y=None,
        laser_z=None,
        ring: Ring | None = None,
    ):
        """``dtype`` is the particle-state precision; ``field_dtype``
        (default: same) the grid-field precision.  Mixed precision (f32
        particles, f64 fields) keeps the fused f32 kernel while the Yee
        integration, current accumulation and energy sums run in f64.
        ``laser_y``/``laser_z`` are the laser boundary's fields, host
        callables ``(t, x) -> float`` (``grid.apply_boundaries``).
        ``ring`` is this rank's ``parallel.dist.Ring`` (default: a
        world of 1 on ``device``): the grid is cut into one slab a rank,
        or with ``options.replicate_fields`` held whole by every rank."""
        ring = ring if ring is not None else Ring(device=torch.device(device))
        if options.replicate_fields:
            if geom.n_devices != 1:
                raise ValueError("replicate_fields needs a geometry of one "
                                 "device (every rank holds the whole grid)")
        elif geom.n_devices != ring.world:
            raise ValueError(f"the grid is cut for {geom.n_devices} devices "
                             f"and the ring has {ring.world} ranks")
        for name, spec in species.items():
            if spec.kind not in ("electron", "ion", "photon"):
                raise ValueError(f"species {name!r} of unknown kind {spec.kind!r}")
        qed_on = options.photon_emission or options.photon_absorption
        if qed_on and not {"electron", "photon"} <= set(species):
            raise ValueError("QED needs electron and photon species")
        self.geom = geom
        self.options = options
        self.specs = dict(species)
        self.laser_y, self.laser_z = laser_y, laser_z
        self.device = torch.device(device)
        self.ring = ring
        # the rank's index on the decomposed grid (opal_tpu's axis_index);
        # 0 in the replicated mode, whose cells are global
        self.axis_index = 0 if options.replicate_fields else ring.rank
        self.dtype = dtype
        self.field_dtype = field_dtype if field_dtype is not None else dtype

    # ------------------------------------------------------------------
    # the push
    # ------------------------------------------------------------------

    @property
    def _qed_on(self) -> bool:
        return self.options.photon_emission or self.options.photon_absorption

    @property
    def _event_log(self) -> bool:
        return (self.options.extra_absorption_output
                or self.options.extra_stimulated_emission_output)

    @property
    def _n_rows(self) -> int:
        return self.geom.n_loc + 2 * HALO + 2 * F.PAD

    def _fused_applicable(self, name, st) -> bool:
        """Whether the fused kernel can serve this species."""
        if isinstance(st, F.PackedState):
            return True  # only packed because it was applicable
        opt = self.options
        return (
            opt.fused_pusher
            and opt.migration
            and self.specs[name].kind in ("electron", "ion")
            and st.x.dtype == torch.float32
            and st.x.shape[0] % opt.fused_block == 0
            # window read/write (base-2 .. base+W+2) must fit the table
            and opt.fused_window + 4 <= self._n_rows
        )

    def _packed_applicable(self, name, st) -> bool:
        """Whether ``run`` packs this species (``opal_tpu/sim.py:
        487-500``): fused-applicable, QED off, not packed yet."""
        return (
            self.options.packed_fused
            and not self._qed_on
            and not isinstance(st, F.PackedState)
            and self._fused_applicable(name, st)
        )

    def _fused_spec(self, name) -> F.FusedSpec:
        opt, geom = self.options, self.geom
        spec = self.specs[name]
        electron = spec.kind == "electron"
        return F.FusedSpec(
            block=opt.fused_block, window=opt.fused_window,
            n_rows=self._n_rows, dx=geom.dx, dt=opt.dt,
            charge=spec.charge, mass=spec.mass,
            pusher="vay" if electron else "boris", row_off=HALO + F.PAD,
            # only electrons carry the work integral
            work_out=electron,
            # mixed precision: the work column is field-dtype and the
            # kernel outputs bare increments accumulated here in f64
            work_inc=electron and self.field_dtype != self.dtype,
            # chi and gamma at the half step feed the QED passes, so QED
            # electrons take the full form (opal_tpu/sim.py:502-539)
            lite=(not (electron and self._qed_on)) and opt.fused_lite != 0,
            dep_skip=not opt.current_deposition,
        )

    def _velocity(self, st: ParticleState):
        return const.SPEED_OF_LIGHT * st.u / st.gamma[:, None]

    def _push_species(self, name, st: ParticleState, E_slab, B_slab):
        """The unfused push of a whole species
        (``opal_tpu/sim.py:376-442``): the field gather, then the Vay
        push for electrons (with emission on, with the optical-depth
        decrement; on mixed-precision QED decks in the field dtype) or
        the Boris push for ions.  Photons fly ballistically; with
        absorption on they update chi from the fields at their old
        position, which the absorption pass reads, and without it keep a
        stale chi, refreshed at output time."""
        geom, opt = self.geom, self.options
        spec = self.specs[name]
        if spec.kind == "photon":
            if opt.immobile_photons:
                return st
            Ep = Bp = None
            if opt.photon_absorption:
                Ep, Bp = fields_at(E_slab, B_slab, st.cell + HALO, st.x)
                Ep, Bp = Ep.to(st.x.dtype), Bp.to(st.x.dtype)
            cell, x, prev_x, y, z, chi = photon_push(
                st.cell, st.x, st.y, st.z, st.u, Ep, Bp, geom.dx, opt.dt,
            )
            upd = dict(cell=cell, x=x, prev_x=prev_x, y=y, z=z)
            if chi is not None:
                upd["chi"] = chi
            return dataclasses.replace(st, **upd)
        electron = spec.kind == "electron"
        # mixed-precision QED decks: f64 arithmetic, f32 storage
        f64_compute = (opt.push_f64_compute and electron
                       and st.x.dtype != self.field_dtype)
        Ep, Bp = fields_at(E_slab, B_slab, st.cell + HALO, st.x)
        if not f64_compute:
            Ep, Bp = Ep.to(st.x.dtype), Bp.to(st.x.dtype)
        if electron:
            tau = st.tau if opt.photon_emission else None
            res = vay_push(
                st.cell, st.x, st.y, st.z, st.u, st.gamma, tau, st.work, Ep,
                Bp, geom.dx, opt.dt,
                classical_rates=not opt.radiation_reaction,
                compute_dtype=self.field_dtype if f64_compute else None,
            )
            cell, x, prev_x, y, z, u, gamma = res[:7]
            upd = dict(chi=res.chi, work=res.work)
            if tau is not None:
                upd["tau"] = res.tau
        else:
            cell, x, prev_x, y, z, u, gamma_m1 = boris_push(
                st.cell, st.x, st.y, st.z, st.u,
                torch.full_like(st.x, spec.charge),
                torch.full_like(st.x, spec.mass), Ep, Bp, geom.dx, opt.dt,
            )
            gamma = 1.0 + gamma_m1
            upd = {}
        return dataclasses.replace(
            st, cell=cell, x=x, prev_x=prev_x, y=y, z=z, ux=u[:, 0],
            uy=u[:, 1], uz=u[:, 2], gamma=gamma, **upd)

    def _fused_push_deposit(self, name, st: ParticleState, E_slab, B_slab,
                            anchors):
        """The fused kernel plus the compacted fallback for alive rows
        outside their block window (``opal_tpu/sim.py:541-721``).

        Depositing before migration equals the reference's
        post-migration deposit: a one-cell leaver deposits into halo
        rows, which the fold adds to the neighbour.

        With emission on, the optical depth falls outside the kernel by
        the rate at the chi and half-step gamma of every row
        (``opal_tpu/sim.py:574-593``), after the fallback has written
        its rows' (the kernel leaves chi 0 and gh 1 on rows it did not
        update, so rate 0 where nothing pushed them).

        Returns (state, out_slab, losses, anchors_next): ``out_slab`` is
        the kernel's tap slab with the fallback's deposit added, folded
        out by the deposit phase (``None`` without current
        deposition)."""
        opt = self.options
        spec = self.specs[name]
        fspec = self._fused_spec(name)
        with trace.span(trace.PUSH, self.device):
            eb = F.make_eb_rows(E_slab, B_slab)
            cols, miss, out_slab, anchors_next = F.fused_push_deposit(
                fspec, anchors, st.cell, st.x, st.y, st.z,
                st.ux, st.uy, st.uz, st.gamma, st.weight,
                st.work if fspec.work_out and not fspec.work_inc else None,
                eb,
            )
        losses = self._misfit_fallback(
            fspec, miss, F.column_rows(cols, fspec.block), st.weight, eb,
            E_slab, B_slab, out_slab)

        upd = {k: cols[k] for k in
               ("cell", "x", "y", "z", "ux", "uy", "uz", "gamma")}
        # the lite kernel leaves prev_x and chi unchanged: nothing reads
        # prev_x between steps and chi is refreshed at output time
        if not fspec.lite:
            upd.update(prev_x=cols["prev_x"], chi=cols["chi"])
        if fspec.work_out and not fspec.work_inc:
            upd["work"] = cols["work"]
        emit_on = (spec.kind == "electron" and opt.photon_emission
                   and st.tau is not None)
        if emit_on or fspec.work_inc:
            # what reads the fallback's rows too, over every row once
            with trace.span(trace.PUSH, self.device):
                if emit_on:
                    rate = (emission.rate if opt.radiation_reaction
                            else emission.classical_rate)
                    with trace.span(trace.TAU_DECREMENT):
                        upd["tau"] = (st.tau - rate(cols["chi"], cols["gh"])
                                      * opt.dt).to(st.tau.dtype)
                if fspec.work_inc:
                    upd["work"] = st.work + cols["winc"].to(st.work.dtype)
        return dataclasses.replace(st, **upd), out_slab, losses, anchors_next

    def _misfit_fallback(self, fspec, miss, rows, weight, eb, E_slab, B_slab,
                         out_slab):
        """The misfit fallback of both layouts (``opal_tpu/sim.py:
        617-708``): the kernel's misfit flags ``miss`` compacted into a
        table of ``fused_misfit_capacity`` rows, which
        :func:`ops.fused.misfit_fallback` pushes and deposits in place in
        the kernel's outputs ``rows`` and ``out_slab``.  It runs every
        step at that capacity, reading nothing back: on a card one
        launch, an empty table included.  Returns the losses: the
        table's overflow and, with the deposit, the rows past its
        reach."""
        with trace.span(trace.MISFIT, self.device):
            mtab, losses = F.misfit_compact(
                miss, self.options.fused_misfit_capacity,
                trace.device_counts((trace.MISFIT_TILES,), self.device))
            F.misfit_fallback(
                fspec, mtab, rows, weight, eb, E_slab, B_slab, out_slab,
                losses, trace.device_counts(
                    (trace.MISFIT_ROWS, trace.MISFIT_STEPS), self.device))
        return losses

    def _packed_push_deposit(self, name, ps: F.PackedState, E_slab, B_slab,
                             anchors):
        """:meth:`_fused_push_deposit` on the packed layout
        (``opal_tpu/sim.py:723-827``): the packed kernel, then the
        compacted fallback for its misfit rows in the hot and aux
        matrices.  Electrons in the fallback accumulate the f32 work
        column of the hot matrix; ions pass theirs through.  QED is off
        here (:meth:`_packed_applicable`), so there is no tau update.

        Returns (PackedState, out_slab, losses, anchors_next)."""
        fspec = self._fused_spec(name)
        with trace.span(trace.PUSH, self.device):
            eb = F.make_eb_rows(E_slab, B_slab)
            h, aux, out_slab, anchors_next = F.fused_push_deposit_packed(
                fspec, anchors, ps.h, ps.weight, eb)
        losses = self._misfit_fallback(
            fspec, aux[:, F.A_COLS.index("miss")].view(aux.shape[0], -1),
            F.packed_rows(h, aux), ps.weight, eb, E_slab, B_slab, out_slab)
        return (F.PackedState(h=h, aux=aux, weight=ps.weight, tau=ps.tau),
                out_slab, losses, anchors_next)

    # ------------------------------------------------------------------
    # schedule
    # ------------------------------------------------------------------

    def _cadences(self, species):
        """(M, R): migration-exchange and maintenance-sort cadences in
        steps (``opal_tpu/sim.py:889-925``)."""
        opt = self.options
        drift = float(opt.max_drift_cells_per_step)
        if drift < 0.5:
            # slow-drift deck: excursion ceil(drift * M) <= HALO - 2
            m_cap = int((HALO - 2) / max(drift, 1e-9))
        else:
            m_cap = HALO - 1
        M = max(1, min(opt.migration_every, m_cap))
        if opt.current_deposition and any(
            self.specs[n].charge != 0.0
            and not self._fused_applicable(n, species[n])
            for n in self.specs
        ):
            # the unfused deposit has no PAD rows of margin
            M = min(M, max(1, int((HALO - 3) / max(drift, 1e-9)))
                    if drift < 0.5 else HALO - 3)
        R = max(1, opt.fused_resort_every)
        return M, R

    def _migrate(self, name, st):
        """The exchange of one species (``opal_tpu/sim.py:927-971``):
        the edge exchange of a cell-sorted (fused) species; for the
        others the compact exchange, or at one device wrap or kill in
        place (an exchange with itself); in the replicated mode every
        species wraps or dies in place."""
        opt, geom = self.options, self.geom
        packed = isinstance(st, F.PackedState)
        if opt.replicate_fields:
            return (wrap_kill_packed if packed else wrap_kill)(st, geom)
        if packed:
            return migrate_edges_packed(st, geom, opt.migration_capacity,
                                        opt.migration_window, self.ring)
        if self._fused_applicable(name, st):
            return migrate_edges(st, geom, opt.migration_capacity,
                                 opt.migration_window, self.ring)
        if self.ring.world == 1:
            return wrap_kill(st, geom)
        return migrate_compact(st, geom, opt.migration_capacity, self.ring)

    def _sort(self, name, st):
        """The maintenance sort of a fused species, either layout, and
        the window bases of its sorted blocks: (state, anchors)."""
        if isinstance(st, F.PackedState):
            st, cell = sort_packed(st, self.geom.n_loc)
        else:
            st = sort_state(st, self.geom.n_loc)
            cell = st.cell
        return st, F.block_anchors(self._fused_spec(name), cell)

    def _sort_phase(self, c: Carry) -> Carry:
        """Maintenance sort of every fused species + fresh block
        anchors; runs once per sort period."""
        species, anchors = dict(c.species), dict(c.anchors)
        with trace.span(trace.SORT, self.device):
            for name in self.specs:
                if self._fused_applicable(name, species[name]):
                    species[name], anchors[name] = self._sort(name,
                                                              species[name])
        return c._replace(species=species, anchors=anchors)

    def _migrate_phase(self, c: Carry) -> Carry:
        """The exchange of every species; closes each M-step block."""
        species, counters = dict(c.species), dict(c.counters)
        with trace.span(trace.EXCHANGE, self.device):
            for name in self.specs:
                species[name], ovf = self._migrate(name, species[name])
                counters[name] = counters[name] + ovf
        return c._replace(species=species, counters=counters)

    def _device_step(self, c: Carry, inline_sort, inline_migrate,
                     rng=None) -> Carry:
        """One step, phase by phase; ``rng`` gives the QED passes their
        draws (a ``torch.Generator``, or a dict of opal_tpu's arrays for
        this step, see ``interactions``)."""
        geom, opt, dev = self.geom, self.options, self.device
        E = c.E
        species, counters, anchors = (
            dict(c.species), dict(c.counters), dict(c.anchors)
        )
        with trace.span(trace.HALO, dev):
            E_slab, B_slab = self._exchange(E, c.B)

        out_slabs = {}
        for name in self.specs:
            st = species[name]
            if self._fused_applicable(name, st):
                if inline_sort:
                    with trace.span(trace.SORT, dev):
                        st, anch = self._sort(name, st)
                else:
                    anch = anchors[name]
                push = (self._packed_push_deposit
                        if isinstance(st, F.PackedState)
                        else self._fused_push_deposit)
                st, out_slab, losses, anchors[name] = push(
                    name, st, E_slab, B_slab, anch)
                if out_slab is not None:
                    out_slabs[name] = out_slab
                counters[name] = counters[name] + losses
            else:
                with trace.span(trace.PUSH, dev):
                    st = self._push_species(name, st, E_slab, B_slab)
            if opt.migration and inline_migrate:
                with trace.span(trace.EXCHANGE, dev):
                    st, ovf = self._migrate(name, st)
                    counters[name] = counters[name] + ovf
            species[name] = st

        events = c.events
        if opt.photon_absorption:
            # the fused electron path pairs over per-cell brackets of its
            # nearly sorted state (opal_tpu/sim.py:1104-1136); the unfused
            # path sorts inside the pass
            bracketed = self._fused_applicable("electron",
                                               species["electron"])
            # the replicated mode pairs across the ranks
            # (opal_tpu/sim.py:1141-1147; its absorb turns the pairing
            # off at one device)
            with trace.span(trace.ABSORB, dev):
                species, lost, deferred, *ev = absorb(
                    self, species, c.t, rng, bracketed=bracketed,
                    axis_index=self.axis_index, ring=self.ring,
                    replicated=opt.replicate_fields and self.ring.world > 1)
                counters["photon"] = counters["photon"] + lost
                counters["qed_deferred"] = counters["qed_deferred"] + deferred
                if ev:
                    events = self._log_events(events, *ev[0])
        if opt.photon_emission:
            with trace.span(trace.EMIT, dev):
                species, lost, deferred = emit_radiation(
                    self, species, c.t, rng)
                counters["photon"] = counters["photon"] + lost
                counters["qed_deferred"] = counters["qed_deferred"] + deferred

        with trace.span(trace.DEPOSIT, dev):
            n_slab = geom.n_loc + 2 * HALO
            J_slab = torch.zeros((n_slab, 3), dtype=E.dtype, device=E.device)
            rho_slab = torch.zeros((n_slab,), dtype=E.dtype, device=E.device)
            if opt.current_deposition:
                for out_slab in out_slabs.values():
                    J_add, rho_add = F.fold_out_slab(out_slab)
                    J_slab = J_slab + J_add.to(E.dtype)
                    rho_slab = rho_slab + rho_add.to(E.dtype)
                J_slab, rho_slab = self._deposit(
                    J_slab, rho_slab,
                    {n: st for n, st in species.items()
                     if n not in out_slabs})
            J, rho = self._fold(J_slab, rho_slab)

        with trace.span(trace.FIELDS, dev):
            E_own, B_own = apply_boundaries(
                E_slab[HALO:-HALO], B_slab[HALO:-HALO], geom,
                self.axis_index, c.t, opt.dt, self.laser_y, self.laser_z,
            )
            E_slab = torch.cat([E_slab[:HALO], E_own, E_slab[-HALO:]])
            B_slab = torch.cat([B_slab[:HALO], B_own, B_slab[-HALO:]])
            J_slab = torch.nn.functional.pad(J, (0, 0, HALO, HALO))
            E_slab, B_slab = maxwell.advance(
                E_slab, B_slab, J_slab, opt.dt, geom.dx,
                sm_mask(geom, E.device, self.axis_index),
            )
        return Carry(E_slab[HALO:-HALO], B_slab[HALO:-HALO], J, rho,
                     species, c.t + opt.dt, counters, anchors, events)

    def _exchange(self, E, B):
        """The halo-extended field slabs: from the ring neighbours, or
        in the replicated mode a local wrap."""
        if self.options.replicate_fields:
            return halo.exchange_fields_local(E, B, self.geom)
        return halo.exchange_fields(E, B, self.geom, self.ring)

    def _fold(self, J_slab, rho_slab):
        """Fold the halo currents into the owners' cells; in the
        replicated mode fold locally and sum the ranks' particle shards'
        deposits (``opal_tpu/sim.py:1222-1228``)."""
        if not self.options.replicate_fields:
            return halo.fold_currents(J_slab, rho_slab, self.geom, self.ring)
        J, rho = halo.fold_currents_local(J_slab, rho_slab, self.geom)
        both = self.ring.psum(torch.cat([J, rho[:, None]], dim=1))
        return both[:, :3], both[:, 3]

    def _deposit(self, J_slab, rho_slab, species):
        """The scatter deposit of each charged species of ``species``, in
        the order of ``specs``, into the halo-extended slabs: the
        macrocharge in the particle dtype, the slabs in the field dtype.
        Returns (J_slab, rho_slab)."""
        for name, spec in self.specs.items():
            if spec.charge == 0.0 or name not in species:
                continue
            st = species[name]
            macrocharge = torch.where(st.alive, st.weight * spec.charge, 0.0)
            J_slab, rho_slab = deposit(
                J_slab, rho_slab, st.cell + HALO, st.x, st.prev_x,
                macrocharge, self._velocity(st), self.geom.dx,
                self.options.dt,
            )
        return J_slab, rho_slab

    @staticmethod
    def _log_events(events, rec, want):
        """Append the records ``rec`` that ``want`` selects to the ring
        ``events = (ring, count)`` (``opal_tpu/sim.py:1148-1160``):
        ``count`` is every event seen, the ring keeps the first
        ``len(ring)``, and the writer counts the rest as dropped."""
        ring, count = events
        cap = ring.shape[0]
        rank = torch.cumsum(want.long(), dim=0) - 1 + torch.clamp(count, max=cap)
        dest = torch.where(want & (rank < cap), rank, cap)
        ring = torch.cat([ring, ring[:1]])
        ring[dest] = rec.to(ring.dtype)
        return ring[:cap], count + want.sum()

    def run(self, E, B, J, rho, species, t0, counters, nsteps: int,
            rng=None, events=None):
        """Advance ``nsteps`` steps over the static phase schedule;
        returns (E, B, J, rho, species, t, counters) with J/rho from the
        final step (for output parity), and with the event log on the
        event ring as an eighth item (``events`` carries it over from an
        earlier call; default an empty ring, :meth:`zero_events`).

        With QED on, ``rng`` is required: a ``torch.Generator`` on the
        simulation's device, or a callable that returns step ``i``'s
        draws (``i`` counted from 0 in this call) as a dict of arrays,
        which replays another generator's stream
        (``interactions.emit_radiation``, ``interactions.absorb``)."""
        opt = self.options
        if self._qed_on and rng is None:
            raise ValueError("QED needs an rng")
        if self._event_log and events is None:
            events = self.zero_events()
        replay = callable(rng) and not isinstance(rng, torch.Generator)
        steps = iter(range(nsteps))

        def draws():
            i = next(steps)
            return rng(i) if replay else rng

        M, R = self._cadences(species)
        # the losses of this call on this rank; summed over the ranks and
        # added to ``counters`` at the end (one collective a call)
        counters_in = counters
        counters = {k: torch.zeros_like(v) for k, v in counters.items()}
        any_fused = any(
            self._fused_applicable(n, species[n]) for n in self.specs
        )
        # the packed layout: packed once here, unpacked once at the end
        templates = {n: species[n] for n in self.specs
                     if self._packed_applicable(n, species[n])}
        species = {**species, **{n: F.pack_fused(st, opt.fused_block)
                                 for n, st in templates.items()}}
        inline_migrate = not opt.migration or M == 1
        inline_sort = any_fused and R == 1
        sort_phase = any_fused and R > 1
        Mb = 1 if inline_migrate else M
        # placeholders: the sort phase computes the bases before the
        # first fused step of every run
        anchors = {
            n: torch.full((species[n].weight.numel() // opt.fused_block,), 2,
                          dtype=torch.int32, device=self.device)
            for n in self.specs if self._fused_applicable(n, species[n])
        }
        c = Carry(E, B, J, rho, dict(species), float(t0), dict(counters),
                  anchors, events if self._event_log else None)

        def blocks(c, k):
            # k steps as M-step blocks, each closed by the exchange
            for lo in range(0, k, Mb):
                for _ in range(min(Mb, k - lo)):
                    with trace.span(trace.STEP):
                        c = self._device_step(c, inline_sort, inline_migrate,
                                              draws())
                if not inline_migrate:
                    c = self._migrate_phase(c)
            return c

        if not sort_phase:
            c = blocks(c, nsteps)
        else:
            R_eff = max(Mb, (R // Mb) * Mb)
            for lo in range(0, nsteps, R_eff):
                c = blocks(self._sort_phase(c), min(R_eff, nsteps - lo))
        species = {**c.species, **{n: F.unpack_fused(c.species[n], tmpl)
                                   for n, tmpl in templates.items()}}
        names = list(counters_in)
        lost = self.ring.psum(torch.stack([c.counters[k] for k in names]))
        counters = {k: counters_in[k] + lost[i] for i, k in enumerate(names)}
        out = (c.E, c.B, c.J, c.rho, species, c.t, counters)
        return out + (c.events,) if self._event_log else out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def init_fields(self):
        return zero_fields(self.geom, self.field_dtype, self.device)

    def initialize_fields(self, E, B, J, rho, species):
        """Electrostatic and magnetostatic fields from the initial
        particles (reference ``main.rs:174-183`` and ``yee.rs:644-747``;
        ``opal_tpu/sim.py:1416-1460`` at one device): deposit every
        charged species, fold the halos, then solve the Gauss/Ampère
        prefix sweep (:func:`fields.electrostatic_init`; in the replicated
        mode over the summed, global J and rho with no collective).
        Returns (E, B, J, rho)."""
        n_slab = self.geom.n_loc + 2 * HALO
        J_slab, rho_slab = self._deposit(
            torch.zeros((n_slab, 3), dtype=E.dtype, device=E.device),
            torch.zeros((n_slab,), dtype=E.dtype, device=E.device),
            species)
        J, rho = self._fold(J_slab, rho_slab)
        ring = None if self.options.replicate_fields else self.ring
        E, B = electrostatic_init(E, B, J, rho, self.geom, ring)
        return E, B, J, rho

    def zero_counters(self):
        """Per-species loss counters, and with QED the backlog
        ``qed_deferred`` (work delayed to a later step, not lost): device
        int64 scalars."""
        names = list(self.specs)
        if self._qed_on:
            names.append("qed_deferred")
        return {
            name: torch.zeros((), dtype=torch.int64, device=self.device)
            for name in names
        }

    def zero_events(self):
        """An empty event ring: ``(ring, count)``, the (capacity, 14)
        records in the particle dtype and the int64 count of events seen
        (``opal_tpu/sim.py:1489-1501``: each rank keeps its own)."""
        cap = self.options.event_log_capacity if self._event_log else 0
        return (torch.zeros((cap, 14), dtype=self.dtype, device=self.device),
                torch.zeros((), dtype=torch.int64, device=self.device))

    def em_field_energy(self, E, B) -> float:
        """Field energy (J) of the interior, summed over the ranks; in
        the replicated mode that of the whole grid, which every rank
        holds (``opal_tpu/sim.py:1542-1560``).  Every rank must call
        it."""
        e = em_field_energy_local(E, B, self.geom, self.axis_index)
        return float(e if self.options.replicate_fields
                     else self.ring.psum(e))

    def total_kinetic_energy(self, name: str, state: ParticleState) -> float:
        """Kinetic energy of a species in joules (``mod.rs:227-240``),
        reduced in the field dtype and summed over the ranks.  Every
        rank must call it."""
        ke = kinetic_energy_weights(self.specs[name], state)
        return float(self.ring.psum(torch.sum(ke.to(self.field_dtype))))

    @property
    def electron_chi_is_lazy(self) -> bool:
        """True when the step leaves electron chi stale: the lite fused
        kernel (non-QED decks) skips the per-step chi diagnostic
        (``opal_tpu/sim.py:1572-1583``)."""
        opt = self.options
        return opt.fused_pusher and opt.fused_lite != 0 and not self._qed_on

    def refresh_electron_chi(self, E, B, st: ParticleState) -> ParticleState:
        """Recompute electron chi from the current momenta and fields
        (the full-step invariant, equal to the reference's half-step
        value to O(dt))."""
        E_slab, B_slab = self._exchange(E, B)
        Ep, Bp = fields_at(E_slab, B_slab, st.cell + HALO, st.x)
        chi = electron_chi(
            st.ux, st.uy, st.uz, st.gamma,
            Ep.to(st.x.dtype), Bp.to(st.x.dtype),
        )
        return dataclasses.replace(st, chi=chi)

    def refresh_photon_chi(self, E, B, st: ParticleState) -> ParticleState:
        """Recompute photon chi from the current positions and fields
        (``photon.rs:165-176``): without an absorption pass the step
        skips the per-step photon field gather, since nothing reads
        chi."""
        E_slab, B_slab = self._exchange(E, B)
        Ep, Bp = fields_at(E_slab, B_slab, st.cell + HALO, st.x)
        chi = photon_chi(st.u, Ep.to(st.x.dtype), Bp.to(st.x.dtype))
        return dataclasses.replace(st, chi=chi)
