"""Command-line entry point: ``python -m opal_tpu_torch input.yaml``.

``opal_tpu/cli.py`` on PyTorch: read the YAML deck,
build the grid (periodic, or a laser injector on the left and an
absorbing boundary on the right when the deck has a ``laser`` section)
and the electron, ion and (with QED photon emission or absorption)
photon populations, then alternate output dumps with blocks of
simulation steps, printing the same banner, progress lines, loss
warnings, QED backlog notes, output files and, with the
``extra_*_output`` features, the absorption events on standard
error.  The fused-kernel block, window,
resort and migration cadences and the capacities are auto-sized by the
same rules, so one deck runs the same schedule in both packages; as
there, mixed-precision QED decks run the unfused push with f64
arithmetic, and ``--f32`` (or ``tpu: fused_pusher: 1``) the kernel;
``tpu: packed_fused: 1`` carries the fused species in the packed layout
through the packed kernel (never with QED).  ``control:
initialise_fields`` sets up the electrostatic fields of the initial
particles, and ``control: checkpoint`` writes ``checkpoint.npz`` at
every output, in opal_tpu's format, which ``--resume`` continues from.

``--devices N`` (or ``tpu: devices``) runs N ranks on this host, one
process and one card each (``cuda:{rank}``, NCCL), or ``gloo`` ranks on
``--device cpu``; ``--coordinator HOST:PORT --num-processes P
--process-id R`` starts one rank a process across hosts instead.  The
grid is cut into one slab a rank, or, by opal_tpu's rule for
nonuniform decks (load imbalance of at least 1.5 over at most 80,000
cells; ``tpu: replicate_fields: 0/1`` overrides it), held whole by
every rank with the particles in equal-count chunks (an absorption
deck too, while the gathered candidate table fits its memory guard).
Rank 0 gathers and writes the outputs; the other ranks print nothing.

It runs on the CUDA device unless ``--device cpu`` asks for the CPU;
without a card, or with fewer cards than ranks, it exits 1 and never
falls back.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import checkpoint
from . import constants as const
from . import trace
from .config import Config, ConfigError
from .convert import to_numpy
from .diagnostics import output as out
from .diagnostics.progress import ettc, pretty_duration, simulation_time
from .grid import HALO, GridGeometry, balanced_counts, load_imbalance
from .interactions import CAND_TABLE_MAX_BYTES
from .ops.fused import PAD
from .parallel import dist
from .species import (SpeciesSpec, initialize, rank_rows, rank_seed,
                      shard_even)


class NoDevice(RuntimeError):
    """The run asks for a CUDA device and there is none."""


def _required_capacity(geom: GridGeometry, npc: int, density) -> int:
    """Worst-case per-device particle count for an initial sampling."""
    if npc <= 0:
        return 8
    cells = np.arange(geom.nx)
    x_centre = geom.xmin + (cells + 0.5) * geom.dx
    ne = np.broadcast_to(
        np.asarray(density(x_centre), dtype=np.float64), x_centre.shape
    )
    active = ne * geom.dx > 0.0
    g = cells[active] + geom.left_pad
    dev = g // geom.n_loc
    counts = np.bincount(dev, minlength=geom.n_devices)
    return int(counts.max()) * npc


def _round_up(n: int, m: int = 8) -> int:
    return max(m, ((n + m - 1) // m) * m)


def fused_auto_sizing(span_gap: int, w_max: int, resort: int,
                      v_spread: float, r_pinned: bool = False):
    """Fused window/cadence auto-sizing (``opal_tpu/cli.py:47-73``): the
    window covers the sorted block span + ``resort`` steps of
    velocity-spread dispersion + slack; the sort cadence halves while
    the window would not fit the field table or dispersion dominates.
    Returns ``(window, resort)``."""
    dcells = lambda r: int(np.ceil(0.95 * v_spread * r))
    if not r_pinned:
        while resort > 8 and (
            _round_up(span_gap + 6 + dcells(resort), 8) > w_max
            or dcells(resort) > 2 * (span_gap + 6)
        ):
            resort //= 2
    auto_w = _round_up(span_gap + 6 + dcells(resort), 8)
    return max(8, min(512, auto_w, w_max)), resort


def deck_devices(path: Path) -> int:
    """The deck's ``tpu: devices`` (default 1): the rank count of a run
    that does not give ``--devices``."""
    cfg = Config.from_file(path)
    try:
        return int(cfg.read_f64("tpu", "devices")) or 1
    except ConfigError:
        return 1


def build(path: Path, dtype=torch.float32, field_dtype=torch.float64,
          device="cuda", ring=None):
    """Parse an input file and construct the Simulation plus initial
    state of one rank: ``ring`` (``parallel.dist.Ring``, default a world
    of 1 on ``device``, the CUDA device unless the caller asks for
    ``"cpu"``; raises :class:`NoDevice` when there is no card), whose
    world is the run's device count.  Every rank builds the global
    initial state on the host, sizes the run from it (so that every rank
    sizes it alike) and keeps its own block of rows.  Returns (sim, state-dict, run-parameters)."""
    from .sim import SimOptions, Simulation

    if ring is None:
        ring = dist.Ring(device=torch.device(device))
    device = ring.device
    n_devices = ring.world
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoDevice("no CUDA device (pass --device cpu to run on the CPU)")

    input_cfg = Config.from_file(path)
    input_cfg.with_context("constants")

    def tpu_opt(field, default):
        try:
            return input_cfg.read_f64("tpu", field)
        except ConfigError:
            return default

    nx = input_cfg.read_usize("control", "nx")
    xmin = input_cfg.read_f64("control", "xmin")
    dx = input_cfg.read_f64("control", "dx")
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    tstart = input_cfg.read_f64("control", "start")
    tend = input_cfg.read_f64("control", "end")
    current_deposition = input_cfg.read_bool("control", "current_deposition")
    n_outputs = input_cfg.read_usize("control", "n_outputs")

    def flag(section, field):
        try:
            return input_cfg.read_bool(section, field)
        except ConfigError:
            return False

    try:
        balance = input_cfg.read_bool("control", "balance")
    except ConfigError:
        balance = True  # balance by default (main.rs:76)
    # the electrostatic field set-up (yee.rs:644-747, gated off in the
    # reference at main.rs:174) and checkpoints are opt-in, as in opal_tpu
    # (cli.py:97-111)
    initialise_fields = flag("control", "initialise_fields")
    checkpoint_enabled = flag("control", "checkpoint")
    photon_emission = input_cfg.read_bool("qed", "photon_emission")
    photon_absorption = input_cfg.read_bool("qed", "photon_absorption")
    qed_on = photon_emission or photon_absorption

    # the reference's cargo features (Cargo.toml:24-31) as an optional
    # `features` section of booleans
    def feature(name):
        return flag("features", name)

    # joules -> MeV (main.rs:81)
    pe_min = input_cfg.read_opt_f64("qed", "photon_energy_min")
    qed_opts = dict(
        photon_emission=photon_emission,
        photon_absorption=photon_absorption,
        radiation_reaction=not feature("no_radiation_reaction"),
        beaming=not feature("no_beaming"),
        stimulated_emission=not feature("no_stimulated_emission"),
        immobile_photons=feature("immobile_photons"),
        extra_absorption_output=feature("extra_absorption_output"),
        extra_stimulated_emission_output=feature(
            "extra_stimulated_emission_output"),
        photon_energy_min=(None if pe_min is None
                           else 1.0e-6 * pe_min / const.ELEMENTARY_CHARGE),
        photon_angle_max=input_cfg.read_opt_f64("qed", "photon_angle_max"),
        max_formation_length=input_cfg.read_opt_f64(
            "qed", "max_formation_length"),
        # NOTE: as in opal_tpu (cli.py:138-142), the reference passes
        # disable_qed_after into absorb()'s max_displacement (metres)
        # and disable_absorption_after into its stop time
        # (main.rs:84-85, 246-248); the mapping is kept
        max_displacement=input_cfg.read_opt_f64("qed", "disable_qed_after"),
        absorption_stop_time=input_cfg.read_opt_f64(
            "qed", "disable_absorption_after"),
    )

    # laser section present -> laser/absorbing boundaries (main.rs:95-101)
    if input_cfg.contains("laser"):
        laser_y = input_cfg.func2("laser", "Ey", ("t", "x"))
        laser_z = input_cfg.func2("laser", "Ez", ("t", "x"))
        left_bdy, right_bdy = "laser", "absorbing"
    else:
        laser_y = laser_z = None
        left_bdy, right_bdy = "periodic", "periodic"
    geom = GridGeometry(nx=nx, dx=dx, xmin=xmin, n_devices=n_devices,
                        left_boundary=left_bdy, right_boundary=right_bdy)

    # the replicated-field mode, opal_tpu's load balancer for strongly
    # nonuniform decks (opal_tpu/cli.py:168-219, the same rule): every
    # rank holds the whole grid and the particles split into equal-count
    # chunks; tpu: replicate_fields: 0/1 overrides the choice
    rep_opt = int(tpu_opt("replicate_fields", -1))
    if rep_opt < 0:
        imb = 1.0
        if balance and n_devices > 1:
            try:
                if input_cfg.read_usize("electrons", "npc") > 0:
                    imb = load_imbalance(
                        geom, input_cfg.func("electrons", "ne", "x"))
            except ConfigError:
                pass
        replicate = imb >= 1.5 and n_devices > 1 and geom.n_ext <= 80_000
        replicate_blocked_by_absorption = False
        if replicate and photon_absorption:
            # the gathered candidate table must fit its memory guard;
            # beyond it the deck runs decomposed
            K = int(tpu_opt("absorption_candidates", 256))
            kl = -(-max(1, -(-K // n_devices)) // 32) * 32
            if (nx + 2 * HALO) * kl * 8 * n_devices * 4 > CAND_TABLE_MAX_BYTES:
                replicate = False
                replicate_blocked_by_absorption = True
    else:
        replicate = bool(rep_opt) and n_devices > 1
        replicate_blocked_by_absorption = False
    if replicate:
        geom = GridGeometry(nx=nx, dx=dx, xmin=xmin, n_devices=1,
                            left_boundary=left_bdy, right_boundary=right_bdy)

    capacity_factor = tpu_opt("capacity_factor", 1.5)
    migration_capacity = int(tpu_opt("migration_capacity", 16384))
    seed = int(tpu_opt("seed", 0))
    emission_active = int(tpu_opt("emission_active_capacity", -1))
    emission_insert = int(tpu_opt("emission_insert_capacity", -1))
    absorption_candidates = int(tpu_opt("absorption_candidates", 256))
    # photons walked a step: -1 auto (photon capacity / 4), 0 all
    absorption_active = int(tpu_opt("absorption_active_capacity", -1))
    absorption_events = int(tpu_opt("absorption_event_capacity", 4096))
    # the fused kernel serves f32 particle state; f64 runs use the
    # unfused ops, and so do mixed-precision QED decks, with an f64
    # push: the f32 push's field-phase-correlated energy bias kept their
    # radiated-energy ledger above 1e-5 (opal_tpu/cli.py:243-259)
    mixed = dtype == torch.float32 and field_dtype == torch.float64
    fused_default = int(dtype == torch.float32 and not (qed_on and mixed))
    fused_pusher = bool(tpu_opt("fused_pusher", fused_default))
    push_f64_compute = not fused_pusher and qed_on and mixed
    block_explicit = int(tpu_opt("fused_block", -1))
    # QED decks keep the block of 2048 that opal_tpu's QED kernel form
    # fits its VMEM with
    fused_block = (block_explicit if block_explicit > 0
                   else 2048 if qed_on else 8192)
    _r_opt = int(tpu_opt("fused_resort_every", 0))
    r_pinned = _r_opt > 0
    fused_resort_every = _r_opt if r_pinned else 64
    migration_every = int(tpu_opt("migration_every", 0))  # 0 = auto

    # the shared window must fit every fused species' block span: size
    # it from the smallest npc over electrons and ions; the migration
    # window from the largest (opal_tpu/cli.py:275-289)
    npcs = []
    for sec in ("electrons", "ions"):
        try:
            v = input_cfg.read_usize(sec, "npc")
        except ConfigError:
            continue
        if v > 0:
            npcs.append(v)
    epc_for_w = max(1, min(npcs)) if npcs else 1
    npc_max = max(npcs) if npcs else 1
    if fused_pusher and block_explicit <= 0:
        # capacities are block multiples: shrink the block (down to
        # 1024) rather than let the rounding inflate a small run's
        # buffers, and cap it so a sorted block spans <= ~32 cells
        try:
            ne_est = input_cfg.func("electrons", "ne", "x")
            est = int(
                _required_capacity(geom, epc_for_w, ne_est) * capacity_factor
            )
            if replicate:
                # the particles split evenly over the ranks
                est = -(-est // n_devices)
        except ConfigError:
            est = 0
        while (
            est and fused_block > 1024
            and _round_up(est, fused_block) > est * 1.25
        ):
            fused_block //= 2
        while fused_block > 1024 and -(-fused_block // epc_for_w) > 32:
            fused_block //= 2
    span_gap = -(-fused_block // epc_for_w)
    # the window read must fit the field table
    w_max = (geom.n_loc + 2 * HALO + 2 * PAD - 8) // 8 * 8

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    # the work integral accumulates for the whole run: field dtype
    np_work_dtype = np.float64 if field_dtype == torch.float64 else np_dtype

    def init_species(sp, sec, npc, dens, seed_, cap=None):
        """One species at its per-device capacity (given, or sized from
        the population), sampled with ``seed_`` on the host: the global
        state of every rank's block (opal_tpu/cli.py:370-414; in the
        replicated mode a one-device draw re-chunked by ``shard_even``).
        Returns (state, capacity)."""
        u = [input_cfg.func3(sec, f, ("x", "urand", "nrand"))
             for f in ("ux", "uy", "uz")]
        work = np_work_dtype if cap is None else None
        if replicate:
            host = initialize(
                sp, geom, npc, dens, *u, dt,
                _round_up(int(_required_capacity(geom, npc, dens))),
                seed=seed_, dtype=np_dtype, work_dtype=work, device="cpu")
            if cap is None:
                n_alive = int(host.alive.sum())
                cap = _round_up(
                    int(-(-n_alive // n_devices) * capacity_factor))
                if fused_pusher and cap >= fused_block:
                    cap = _round_up(cap, fused_block)
            return shard_even(host, n_devices, cap), cap
        if cap is None:
            cap = _round_up(
                int(_required_capacity(geom, npc, dens) * capacity_factor))
            if fused_pusher and cap >= fused_block:
                # capacity % block == 0; big decks round to 4 blocks
                mult = fused_block * (4 if cap >= 64 * fused_block else 1)
                cap = _round_up(cap, mult)
        return initialize(
            sp, geom, npc, dens, *u, dt, cap, seed=seed_, dtype=np_dtype,
            work_dtype=work, device="cpu",
        ), cap

    def empty(sp, cap, seed_, work=np_work_dtype):
        """A species with no particles: ``cap`` dead rows a rank."""
        if replicate:
            host = initialize(sp, geom, 0, lambda x: x * 0, None, None, None,
                              dt, 8, seed=seed_, dtype=np_dtype,
                              work_dtype=work, device="cpu")
            return shard_even(host, n_devices, cap)
        return initialize(sp, geom, 0, lambda x: x * 0, None, None, None, dt,
                          cap, seed=seed_, dtype=np_dtype, work_dtype=work,
                          device="cpu")

    epc = input_cfg.read_usize("electrons", "npc")
    especs = SpeciesSpec.electron(input_cfg.read_strings("electrons", "output"))
    specs = {"electron": especs}
    states, capacities = {}, {}
    balance_info = None
    if epc > 0:
        ne = input_cfg.func("electrons", "ne", "x")
        if balance:
            # the reference's density-balanced split (grid/mod.rs:157-206):
            # the slabs stay equal, the banner reports the imbalance
            balance_info = dict(
                counts=balanced_counts(nx, xmin, dx, n_devices, ne).tolist(),
                imbalance=load_imbalance(geom, ne))
        states["electron"], capacities["electron"] = init_species(
            especs, "electrons", epc, ne, seed,
        )
    else:
        capacities["electron"] = 8
        states["electron"] = empty(especs, 8, seed)
    ipc = input_cfg.read_usize("ions", "npc")
    if ipc > 0:
        ispecs = SpeciesSpec.ion(
            input_cfg.read_string("ions", "name"),
            input_cfg.read_f64("ions", "Z"), input_cfg.read_f64("ions", "A"),
            input_cfg.read_strings("ions", "output"),
        )
        specs["ion"] = ispecs
        states["ion"], capacities["ion"] = init_species(
            ispecs, "ions", ipc, input_cfg.func("ions", "ni", "x"), seed + 1,
        )
    if qed_on:
        # the photon buffer holds the emitted photons: 4x the electrons'
        pspecs = SpeciesSpec.photon(input_cfg.read_strings("photons", "output"))
        specs["photon"] = pspecs
        pcap = int(tpu_opt("photon_capacity", 0)) or max(
            4096, 4 * capacities["electron"])
        pcap = _round_up(pcap)
        ppc = input_cfg.read_usize("photons", "npc")
        if ppc > 0:
            states["photon"], _ = init_species(
                pspecs, "photons", ppc, input_cfg.func("photons", "nph", "x"),
                seed + 2, cap=pcap,
            )
        else:
            states["photon"] = empty(pspecs, pcap, seed + 2, work=None)
        capacities["photon"] = pcap
    # emitters sampled a step: capacity / 32 of the electrons, at least
    # 4096 (opal_tpu/cli.py:475-483)
    if emission_active < 0:
        emission_active = (
            _round_up(max(4096, capacities["electron"] // 32))
            if photon_emission else 0
        )
    # photons walked a step: capacity / 4 of the photons, at least 4096
    # (opal_tpu/cli.py:484-487)
    if absorption_active < 0:
        absorption_active = (
            _round_up(max(4096, capacities.get("photon", 0) // 4))
            if photon_absorption else 0
        )

    # ---- fused window / cadence sizing (needs the initial momenta) ---
    # periodic deposition decks are the instability class: floor the
    # velocity-spread estimate at 0.1 (opal_tpu/cli.py:490-531); a laser
    # deck heats its particles to v ~ c whatever their initial momenta,
    # so it is sized for the CFL worst case
    v_spread = 0.1 if left_bdy == "periodic" and current_deposition else 0.05
    v_peak = 0.05
    for name, st in states.items():
        if specs[name].kind == "photon":
            continue
        alive = st.alive.cpu().numpy()
        if alive.any():
            vx = (st.ux.cpu().numpy() / st.gamma.cpu().numpy())[alive]
            v_spread = max(v_spread, float(vx.max() - vx.min()))
            v_peak = max(v_peak, float(np.abs(vx).max()))
    if left_bdy == "laser":
        v_spread = 1.9
    auto_w, fused_resort_every = fused_auto_sizing(
        span_gap, w_max, fused_resort_every, v_spread,
        r_pinned=r_pinned or not fused_pusher,
    )
    fused_window = int(tpu_opt("fused_window", auto_w))
    fused_window = max(8, min(fused_window, w_max))
    # deferred migration: the exchange may wait until 8x the initial
    # peak |vx| would carry a leaver past the 2-cell deposit reach;
    # laser decks heat to ~c and keep the per-step exchange
    max_drift = 0.95
    if migration_every == 0:
        if left_bdy != "laser" and fused_pusher:
            max_drift = min(0.95, 8.0 * v_peak * 0.95)
            migration_every = max(
                1, min(fused_resort_every, int(1.8 / max_drift))
            )
        else:
            migration_every = 1
    # the edge-exchange window covers the leaver front over a resort
    # period at the largest npc
    auto_mw = _round_up(npc_max * (fused_resort_every + 3), 8)
    migration_window = int(tpu_opt("migration_window", max(4096, auto_mw)))
    # misfit fallback: capacity // 16 on laser decks and on periodic
    # deposition decks
    _mis_div = 16 if (
        left_bdy == "laser" or (left_bdy == "periodic" and current_deposition)
    ) else 64
    auto_misfit = _round_up(max(1024, sum(capacities.values()) // _mis_div))
    fused_misfit_capacity = int(tpu_opt("fused_misfit_capacity", auto_misfit))

    options = SimOptions(
        dt=dt,
        current_deposition=current_deposition,
        **qed_opts,
        emission_active_capacity=emission_active,
        emission_insert_capacity=emission_insert,
        absorption_candidates=absorption_candidates,
        absorption_active_capacity=absorption_active,
        absorption_event_capacity=absorption_events,
        push_f64_compute=push_f64_compute,
        seed=seed,
        migration_capacity=migration_capacity,
        fused_pusher=fused_pusher,
        # the packed layout (ops.fused.PackedState), off unless the deck
        # asks for it, as in opal_tpu (cli.py:625)
        packed_fused=bool(tpu_opt("packed_fused", 0)),
        fused_block=fused_block,
        fused_window=fused_window,
        fused_resort_every=fused_resort_every,
        fused_misfit_capacity=fused_misfit_capacity,
        migration_every=migration_every,
        migration_window=migration_window,
        max_drift_cells_per_step=max_drift,
        replicate_fields=replicate,
    )
    sim = Simulation(geom, options, specs, device=device, dtype=dtype,
                     field_dtype=field_dtype, laser_y=laser_y,
                     laser_z=laser_z, ring=ring)
    states = {name: rank_rows(st, ring.rank, capacities[name], device)
              for name, st in states.items()}
    total_steps = int((tend - tstart) / dt)
    run_params = dict(
        tstart=tstart, tend=tend, n_outputs=n_outputs,
        total_steps=total_steps, capacities=capacities,
        steps_per_block=int(tpu_opt("steps_per_block", 0)),
        initialise_fields=initialise_fields, checkpoint=checkpoint_enabled,
        balance_info=balance_info, replicated=replicate,
        replicate_blocked_by_absorption=replicate_blocked_by_absorption,
    )
    return sim, states, run_params


def _profiled(fn, out_dir: Path, device: torch.device):
    """Run ``fn()`` under ``torch.profiler`` and return its result.
    Writes the operator table, sorted by device time (CPU time on the
    CPU), to ``out_dir/profile.txt`` and prints the wall time, the time
    the device was busy (the union of its kernel and copy intervals) and
    the idle share to stderr.  The table ends with each of the program's
    spans (:mod:`trace`) that ran: its host ms, its device ms (a phase's
    extent on the device, :func:`trace.snapshot`; for the other spans
    the device time of the kernels launched inside) and its calls, then
    the counters a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        res = fn()
        sync()
    wall = time.perf_counter() - t0
    snap = trace.snapshot()
    # device work only: a named range also shows as a device-side span
    # from its first kernel to its last, idle gaps included
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in trace.SPANS)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy = busy_us * 1e-6
    out_dir.mkdir(parents=True, exist_ok=True)
    avg = prof.key_averages()
    sort = "device_time_total" if cuda else "cpu_time_total"
    lines = []
    for e in avg:
        if e.key in trace.SPANS and e.device_type == DeviceType.CPU:
            dev_ms = snap["spans"].get(e.key, {}).get(
                "device_ms", e.device_time_total * 1e-3)
            lines.append(f"{e.key}: host {e.cpu_time_total * 1e-3:.3f} ms, "
                         f"device {dev_ms:.3f} ms in {e.count} calls")
    steps = snap["spans"].get(trace.STEP, {}).get("calls", 0)
    counts = [f"{k}: {v / max(steps, 1):.3f}"
              for k, v in snap["counters"].items()]
    (out_dir / "profile.txt").write_text(avg.table(
        sort_by="self_" + sort, row_limit=40, max_name_column_width=100,
    ) + "\nspans:\n" + "\n".join(lines) + f"\ncounters a step ({steps} "
        "steps):\n" + "\n".join(counts) + "\n")
    busy_txt = (f", device busy {busy:.3f} s ({len(spans)} device events, "
                f"idle {1.0 - busy / wall:.1%})" if cuda else "")
    print(f"profile: {wall:.3f} s wall{busy_txt}; table in "
          f"{out_dir / 'profile.txt'}", file=sys.stderr)
    return res


def _parser():
    parser = argparse.ArgumentParser(
        prog="opal_tpu_torch",
        description="1d3v PIC simulation on PyTorch/CUDA (opal_tpu port)",
    )
    parser.add_argument("input", help="path to YAML input configuration")
    parser.add_argument("--devices", type=int, default=None,
                        help="ranks on this host, one card each (default: "
                             "the deck's tpu: devices, or 1)")
    parser.add_argument("--f32", action="store_true",
                        help="run everything in float32 (bench mode)")
    parser.add_argument("--f64", action="store_true",
                        help="run everything in float64 (parity mode; "
                             "the unfused ops). Default is MIXED "
                             "precision: f32 particles on the fused "
                             "kernel + f64 fields/energy integration")
    parser.add_argument("--resume", action="store_true",
                        help="resume from checkpoint.npz in the output dir")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the CUDA device (default) or, with "
                             "the kernels' plain PyTorch versions, on the "
                             "CPU")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="profile the last output block with "
                             "torch.profiler and write its operator table "
                             "to DIR/profile.txt")
    parser.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                        help="multi-process run: the address of rank 0's "
                             "process group (torch.distributed's tcp:// "
                             "rendezvous; the reference's mpirun analogue, "
                             "main.rs:49). Start one process a rank with "
                             "the same coordinator and --process-id 0..P-1")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-process run: the number of ranks")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-process run: this process's rank")
    return parser


def main(argv=None) -> int:
    """Parse the command line and run: one rank in this process, or
    ``--devices N`` ranks as N processes of this host, or one rank of a
    ``--coordinator`` group.  Returns the exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.f32 and args.f64:
        print("opal_tpu_torch: --f32 and --f64 are mutually exclusive",
              file=sys.stderr)
        return 1
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            print("opal_tpu_torch: --coordinator requires --num-processes "
                  "and --process-id", file=sys.stderr)
            return 1
        if args.device == "cuda" and not torch.cuda.is_available():
            print("opal_tpu_torch: no CUDA device (pass --device cpu to run "
                  "on the CPU)", file=sys.stderr)
            return 1
        return _rank(args.process_id, args.num_processes, args,
                     f"tcp://{args.coordinator}")
    try:
        n = args.devices or deck_devices(Path(args.input))
    except (ConfigError, ValueError, OSError) as exc:
        print(f"opal_tpu_torch: {exc}", file=sys.stderr)
        return 1
    if n <= 1:
        return _run(args, dist.Ring(device=torch.device(args.device)))
    if args.device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n:
            print(f"opal_tpu_torch: {n} ranks need {n} CUDA devices and this "
                  f"machine has {cards} (one rank a card; --device cpu runs "
                  "gloo ranks on the CPU)", file=sys.stderr)
            return 1
    codes = dist.launch(_rank_main, n, (argv,))
    return 0 if all(c == 0 for c in codes) else 1


def _rank_main(rank: int, world: int, init_method: str, argv):
    """One of ``--devices N``'s processes: rank ``rank`` of ``world``."""
    args = _parser().parse_args(argv)
    sys.exit(_rank(rank, world, args, init_method))


def _rank(rank: int, world: int, args, init_method: str) -> int:
    """Join the group as ``rank`` and run; the ranks past 0 print
    nothing to standard output (rank 0 speaks for the run)."""
    ring = dist.init(rank, world, init_method, args.device)
    stdout = sys.stdout
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        rc = _run(args, ring)
        ring.barrier()
        return rc
    finally:
        if rank != 0:
            sys.stdout.close()
            sys.stdout = stdout
        dist.close(ring)


def _gather(ring, fields, species, replicated: bool):
    """Host copies of the whole grid and of every rank's rows, in
    opal_tpu's per-device block layout, on rank 0 (one gather to it a
    column; in the replicated mode the grid is rank 0's); ``None`` on
    the other ranks.  Every rank must call it."""
    def whole(a, own=False):
        a = (a[None] if ring.rank == 0 else None) if own else ring.gather(a)
        return None if a is None else to_numpy(a.flatten(0, 1))

    fields_h = tuple(whole(a, replicated) for a in fields)
    species_h = {name: {k: whole(v) for k, v in st.columns().items()}
                 for name, st in species.items()}
    if ring.rank != 0:
        return None
    return fields_h, species_h


def _run(args, ring) -> int:
    """The run of one rank (all of it at a world of 1)."""
    rank0 = ring.rank == 0
    path = Path(args.input)
    output_dir = path.parent
    try:
        sim, species, rp = build(
            path, dtype=torch.float64 if args.f64 else torch.float32,
            field_dtype=torch.float32 if args.f32 else torch.float64,
            device=args.device, ring=ring,
        )
    except NoDevice as exc:
        if rank0:
            print(f"opal_tpu_torch: {exc}", file=sys.stderr)
        return 1
    except (ConfigError, ValueError) as exc:
        if rank0:
            print(f"opal_tpu_torch: {exc}", file=sys.stderr)
            print("Usage: python -m opal_tpu_torch input-file",
                  file=sys.stderr)
        return 1
    geom, opt = sim.geom, sim.options
    replicated = rp["replicated"]

    n_outputs = rp["n_outputs"]
    total_steps = rp["total_steps"]
    steps_bt_output = max(total_steps // max(n_outputs, 1), 1)
    # the same chunking of output spans into run() calls as opal_tpu,
    # so the sort/migrate schedule (which restarts per call) matches
    spb = rp.get("steps_per_block", 0)
    if spb == 0:
        spb = 50 if sim._qed_on else 200 if (
            sim.dtype == torch.float64 or not opt.fused_pusher) else 1000
    if spb > 0 and steps_bt_output > spb + spb // 2:
        nchunks = -(-steps_bt_output // spb)
        run_chunk = -(-steps_bt_output // nchunks)
    else:
        run_chunk = steps_bt_output

    # QED draws: one generator a rank on its device, seeded from the deck
    # and the rank
    rng = torch.Generator(device=sim.device).manual_seed(
        rank_seed(opt.seed, ring.rank))

    def run_span(E, B, J, rho, species, t, counters, nsteps):
        """``nsteps`` steps in calls of at most ``run_chunk``, threading
        the event ring of the span through them (opal_tpu/cli.py:
        784-807)."""
        events = sim.zero_events() if sim._event_log else None
        done = 0
        while done < nsteps:
            n = min(run_chunk, nsteps - done)
            res = sim.run(E, B, J, rho, species, t, counters, n, rng=rng,
                          events=events)
            E, B, J, rho, species, t, counters = res[:7]
            if sim._event_log:
                events = res[7]
            done += n
        return E, B, J, rho, species, t, counters, events

    kind = (
        torch.cuda.get_device_name(sim.device)
        if sim.device.type == "cuda" else "cpu"
    )
    tasks = f"{ring.world} task{'s' if ring.world > 1 else ''}"
    if replicated:
        print(f"Running {tasks} on {kind} (replicated fields, equal-count "
              "particle shards)...")
    else:
        print(f"Running {tasks} on {kind} ({geom.n_loc} cells/device)...")
    if not opt.radiation_reaction:
        print("[radiation reaction disabled, using classical emission rates]")
    if not opt.beaming:
        print("[neglecting angular component of photon spectrum]")
    if not opt.stimulated_emission and opt.photon_absorption:
        print("[stimulated emission disabled, running with absorption only]")
    if opt.immobile_photons:
        print("[photon push disabled]")
    if opt.fused_pusher:
        fused_on = [n for n in species if sim._fused_applicable(n, species[n])]
        print(f"[fused pusher: {', '.join(fused_on) if fused_on else 'no applicable species (unfused ops)'}]")
    bi = rp["balance_info"]
    if bi is not None and bi["imbalance"] > 1.5 and not replicated:
        print(
            f"[density-balanced split would use cells/task = {bi['counts']}; "
            f"uniform slabs carry a {bi['imbalance']:.2f}x worst-case "
            f"particle load — capacity is sized for the heaviest slab]"
        )
        if rp["replicate_blocked_by_absorption"]:
            print(
                "[replicated-field balancing is unavailable for this "
                "absorption deck: the all-gathered pairing table "
                "exceeds its memory budget at this grid size — lower "
                "tpu: absorption_candidates to re-enable; expect up to "
                f"{bi['imbalance']:.2f}x per-device compute skew]"
            )

    E, B, J, rho = sim.init_fields()
    if rp["initialise_fields"]:
        E, B, J, rho = sim.initialize_fields(E, B, J, rho, species)
    counters = sim.zero_counters()
    t = rp["tstart"]
    first_output = 0
    if args.resume:
        try:
            first_output, t, E, B, J, rho, species, rng, counters = (
                checkpoint.load(output_dir, sim))
        except FileNotFoundError:
            if rank0:
                print(f"opal_tpu_torch: no {checkpoint.FILENAME} in "
                      f"{output_dir}", file=sys.stderr)
            return 1
        except ValueError as exc:
            if rank0:
                print(f"opal_tpu_torch: {exc}", file=sys.stderr)
            return 1
        print(f"Resuming from output {first_output} "
              f"(t = {simulation_time(t)})")
    runtime = time.monotonic()

    def dump(index):
        if sim.electron_chi_is_lazy:
            species["electron"] = sim.refresh_electron_chi(
                E, B, species["electron"]
            )
        if ("photon" in species and not opt.photon_absorption
                and not opt.immobile_photons):
            # without an absorption pass the step leaves photon chi
            # stale: refresh it for the chi outputs
            species["photon"] = sim.refresh_photon_chi(
                E, B, species["photon"]
            )
        gathered = _gather(ring, (E, B, J, rho), species, replicated)
        if rank0:
            (E_h, B_h, J_h, rho_h), species_h = gathered
        if rp["checkpoint"]:
            # after the chi refresh, so that the saved chi is current;
            # the event ring is not saved (nor is it in opal_tpu)
            rng_h = (rng if ring.group is None
                     else checkpoint.gather_rng(rng, ring))
            if rank0:
                checkpoint.save(output_dir, index, float(t), E_h, B_h, J_h,
                                rho_h, species_h, rng_h, counters,
                                geom.n_loc, ring.world, replicated,
                                opt.seed)
        if rank0:
            out.write_grid_data(output_dir, index, E_h, B_h, J_h, rho_h,
                                geom)
            for skey, spec in sim.specs.items():
                out.write_particle_outputs(
                    output_dir, index, spec, species_h[skey], geom,
                    rp["capacities"][skey], replicated,
                )
        fe = sim.em_field_energy(E, B)
        ee = sim.total_kinetic_energy("electron", species["electron"])
        ie, pe = (sim.total_kinetic_energy(n, species[n])
                  if n in species else 0.0 for n in ("ion", "photon"))
        if rank0:
            out.write_energies(output_dir, index, fe, ee, ie, pe)

    last_deferred = 0
    for i in range(first_output, n_outputs):
        dump(i)
        if i > first_output:
            done = (i - first_output) * steps_bt_output
            total = (n_outputs - first_output) * steps_bt_output
            print(
                f"Output {i: >4} at t = {simulation_time(t)}, "
                f"RT = {pretty_duration(time.monotonic() - runtime)}, "
                f"ETTC = {pretty_duration(ettc(runtime, done, total))}..."
            )
        else:
            print(f"Output {i: >4} at t = {simulation_time(t)}...")
        sys.stdout.flush()

        span = (E, B, J, rho, species, t, counters, steps_bt_output)
        if args.profile and i == n_outputs - 1 and rank0:
            # the last block: the first builds the kernels, and the late
            # blocks carry the most particle traffic
            E, B, J, rho, species, t, counters, events = _profiled(
                lambda: run_span(*span), Path(args.profile), sim.device)
        else:
            E, B, J, rho, species, t, counters, events = run_span(*span)
        if events is not None:
            events_h = tuple(ring.gather(a) for a in events)
            if rank0:
                out.write_event_log(sys.stderr, to_numpy(events_h), opt)
        counts = {k: int(v) for k, v in counters.items()}
        deferred = counts.pop("qed_deferred", 0)
        lost = {k: v for k, v in counts.items() if v > 0}
        if lost and rank0:
            print(f"warning: buffer-overflow particle losses: {lost}",
                  file=sys.stderr)
        if deferred > last_deferred and rank0:
            print(
                f"note: QED active-set backlog: {deferred} particle-steps "
                "deferred to later steps so far (delays, not losses; raise "
                "tpu: absorption/emission_active_capacity to shrink)",
                file=sys.stderr,
            )
            last_deferred = deferred

    dump(n_outputs)
    print(
        f"Output {n_outputs: >4} at t = {simulation_time(float(t))}, "
        f"RT = {pretty_duration(time.monotonic() - runtime)}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
