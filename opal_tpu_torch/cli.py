"""Command-line entry point: ``python -m opal_tpu_torch input.yaml``.

The single-device path of ``opal_tpu/cli.py``: read the YAML deck,
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
Decks that need several devices are refused with exit code 1.

It runs on the CUDA device unless ``--device cpu`` asks for the CPU;
without a card it exits 1 and never falls back.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import checkpoint
from . import constants as const
from .config import Config, ConfigError
from .convert import to_numpy
from .diagnostics import output as out
from .diagnostics.progress import ettc, pretty_duration, simulation_time
from .grid import HALO, GridGeometry
from .ops.fused import PAD
from .species import SpeciesSpec, initialize


class NotPorted(ValueError):
    """A deck asks for a part of opal_tpu the port does not have yet."""


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


def _refuse_unported(n_devices: int):
    if n_devices != 1:
        raise NotPorted(
            f"{n_devices}-device runs are not yet ported (one device only)"
        )


def build(path: Path, n_devices: int | None = None, dtype=torch.float32,
          field_dtype=torch.float64, device="cuda"):
    """Parse an input file and construct the Simulation plus initial
    state on ``device`` (the CUDA device unless the caller asks for
    ``"cpu"``; raises :class:`NoDevice` when there is no card).
    Returns (sim, state-dict, run-parameters)."""
    from .sim import SimOptions, Simulation

    input_cfg = Config.from_file(path)
    input_cfg.with_context("constants")

    def tpu_opt(field, default):
        try:
            return input_cfg.read_f64("tpu", field)
        except ConfigError:
            return default

    if n_devices is None:
        n_devices = int(tpu_opt("devices", 0)) or 1
    _refuse_unported(n_devices)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise NoDevice("no CUDA device (pass --device cpu to run on the CPU)")

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
        the population), sampled with ``seed_``; returns (state,
        capacity)."""
        u = [input_cfg.func3(sec, f, ("x", "urand", "nrand"))
             for f in ("ux", "uy", "uz")]
        if cap is not None:
            return initialize(
                sp, geom, npc, dens, *u, dt, cap, seed=seed_,
                dtype=np_dtype, device=device,
            ), cap
        cap = _round_up(
            int(_required_capacity(geom, npc, dens) * capacity_factor))
        if fused_pusher and cap >= fused_block:
            # capacity % block == 0; big decks round to 4 blocks
            mult = fused_block * (4 if cap >= 64 * fused_block else 1)
            cap = _round_up(cap, mult)
        return initialize(
            sp, geom, npc, dens, *u, dt, cap, seed=seed_, dtype=np_dtype,
            work_dtype=np_work_dtype, device=device,
        ), cap

    epc = input_cfg.read_usize("electrons", "npc")
    especs = SpeciesSpec.electron(input_cfg.read_strings("electrons", "output"))
    specs = {"electron": especs}
    states, capacities = {}, {}
    if epc > 0:
        states["electron"], capacities["electron"] = init_species(
            especs, "electrons", epc, input_cfg.func("electrons", "ne", "x"),
            seed,
        )
    else:
        capacities["electron"] = 8
        states["electron"] = initialize(
            especs, geom, 0, lambda x: x * 0, None, None, None, dt, 8,
            seed=seed, dtype=np_dtype, work_dtype=np_work_dtype,
            device=device,
        )
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
            states["photon"] = initialize(
                pspecs, geom, 0, lambda x: x * 0, None, None, None, dt, pcap,
                seed=seed + 2, dtype=np_dtype, device=device,
            )
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
    )
    sim = Simulation(geom, options, specs, device=device, dtype=dtype,
                     field_dtype=field_dtype, laser_y=laser_y,
                     laser_z=laser_z)
    total_steps = int((tend - tstart) / dt)
    run_params = dict(
        tstart=tstart, tend=tend, n_outputs=n_outputs,
        total_steps=total_steps, capacities=capacities,
        steps_per_block=int(tpu_opt("steps_per_block", 0)),
        initialise_fields=initialise_fields, checkpoint=checkpoint_enabled,
    )
    return sim, states, run_params


#: the named ranges of the step that a profile reports on their own
PROFILE_RANGES = ("tau_decrement", "absorb", "emit_radiation",
                  "emission_sample")


def _profiled(fn, out_dir: Path, device: torch.device):
    """Run ``fn()`` under ``torch.profiler`` and return its result.
    Writes the operator table, sorted by device time (CPU time on the
    CPU), to ``out_dir/profile.txt`` and prints the wall time, the time
    the device was busy (the union of its kernel and copy intervals) and
    the idle share to stderr; the table ends with the total time of each
    of :data:`PROFILE_RANGES` that ran."""
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
    # device work only: a named range also shows as a device-side span
    # from its first kernel to its last, idle gaps included
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.name not in PROFILE_RANGES)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    busy = busy_us * 1e-6
    out_dir.mkdir(parents=True, exist_ok=True)
    avg = prof.key_averages()
    sort = "device_time_total" if cuda else "cpu_time_total"
    # the step's named ranges (their host side): host time, and the
    # device time of the kernels launched inside
    lines = [f"{e.key}: host {e.cpu_time_total * 1e-3:.3f} ms, device "
             f"{e.device_time_total * 1e-3:.3f} ms in {e.count} calls"
             for e in avg
             if e.key in PROFILE_RANGES and e.device_type == DeviceType.CPU]
    (out_dir / "profile.txt").write_text(avg.table(
        sort_by="self_" + sort, row_limit=40, max_name_column_width=100,
    ) + "\nranges:\n" + "\n".join(lines) + "\n")
    busy_txt = (f", device busy {busy:.3f} s ({len(spans)} device events, "
                f"idle {1.0 - busy / wall:.1%})" if cuda else "")
    print(f"profile: {wall:.3f} s wall{busy_txt}; table in "
          f"{out_dir / 'profile.txt'}", file=sys.stderr)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="opal_tpu_torch",
        description="1d3v PIC simulation on PyTorch/CUDA (opal_tpu port)",
    )
    parser.add_argument("input", help="path to YAML input configuration")
    parser.add_argument("--devices", type=int, default=None,
                        help="number of devices (only 1 is ported)")
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
    args = parser.parse_args(argv)

    if args.f32 and args.f64:
        print("opal_tpu_torch: --f32 and --f64 are mutually exclusive",
              file=sys.stderr)
        return 1

    path = Path(args.input)
    output_dir = path.parent
    try:
        sim, species, rp = build(
            path, n_devices=args.devices,
            dtype=torch.float64 if args.f64 else torch.float32,
            field_dtype=torch.float32 if args.f32 else torch.float64,
            device=args.device,
        )
    except (NotPorted, NoDevice) as exc:
        print(f"opal_tpu_torch: {exc}", file=sys.stderr)
        return 1
    except (ConfigError, ValueError) as exc:
        print(f"opal_tpu_torch: {exc}", file=sys.stderr)
        print("Usage: python -m opal_tpu_torch input-file", file=sys.stderr)
        return 1
    geom, opt = sim.geom, sim.options

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

    # QED draws: one generator on the device, seeded from the deck
    rng = torch.Generator(device=sim.device).manual_seed(opt.seed)

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
    print(f"Running 1 task on {kind} ({geom.n_loc} cells/device)...")
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
            print(f"opal_tpu_torch: no {checkpoint.FILENAME} in {output_dir}",
                  file=sys.stderr)
            return 1
        except ValueError as exc:
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
        E_h, B_h, J_h, rho_h = to_numpy((E, B, J, rho))
        species_h = {k: to_numpy(v) for k, v in species.items()}
        if rp["checkpoint"]:
            # after the chi refresh, so that the saved chi is current;
            # the event ring is not saved (nor is it in opal_tpu)
            checkpoint.save(output_dir, index, float(t), E_h, B_h, J_h,
                            rho_h, species_h, rng, counters, geom.n_loc)
        out.write_grid_data(output_dir, index, E_h, B_h, J_h, rho_h, geom)
        for skey, spec in sim.specs.items():
            out.write_particle_outputs(
                output_dir, index, spec, species_h[skey], geom,
                rp["capacities"][skey],
            )
        fe = sim.em_field_energy(E, B)
        ee = sim.total_kinetic_energy("electron", species["electron"])
        ie, pe = (sim.total_kinetic_energy(n, species[n])
                  if n in species else 0.0 for n in ("ion", "photon"))
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
        if args.profile and i == n_outputs - 1:
            # the last block: the first builds the kernels, and the late
            # blocks carry the most particle traffic
            E, B, J, rho, species, t, counters, events = _profiled(
                lambda: run_span(*span), Path(args.profile), sim.device)
        else:
            E, B, J, rho, species, t, counters, events = run_span(*span)
        if events is not None:
            out.write_event_log(sys.stderr, to_numpy(events), opt)
        counts = {k: int(v) for k, v in counters.items()}
        deferred = counts.pop("qed_deferred", 0)
        lost = {k: v for k, v in counts.items() if v > 0}
        if lost:
            print(f"warning: buffer-overflow particle losses: {lost}",
                  file=sys.stderr)
        if deferred > last_deferred:
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
