"""Benchmark of the port: macroparticle pushes per second of the full
PIC step per CUDA device.

    python -m opal_tpu_torch.bench [--packed | --no-lite | --qed] [flags]
    python -m opal_tpu_torch.bench --devices N   # N ranks, one card each

The twin of the JAX package's ``bench.py``: the same decks (a periodic
two-stream plasma, 8*2**20 electrons over nx 1024, all-f32, Vay push,
deposition and migration on; or with ``--qed`` a gamma-1000 beam in a
static transverse B field of the ``--chi`` it asks for, with photon
emission and absorption, over nx max(1024, N/128) cells of 10 nm), the
same auto-sizing of the fused kernel's block, window, sort and exchange
cadences and capacities and of the QED working sets, the same timed
block (two warm-up blocks, then one timed block of the same step count,
the device synchronised at both ends of it), and ONE json line on
standard output:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "vs_node_proxy": ..., "device": ...}

(``device`` names the card, or ``cpu``).  ``--devices N`` runs the deck
decomposed over N ranks of this host, one process and one card each
(``gloo`` ranks with ``--device cpu``), as ``bench.py --devices N``
does over N chips; the value is then the pushes per second of the
whole run over N, and rank 0 prints the line.

Any counted loss (migration, misfit or deposit-reach overflow, a
photon that found no slot) voids the run: the line then carries
``"value": 0.0`` and an ``error``; QED work deferred to later steps is
a delay, noted on standard error.  As in ``bench.py``, ``--qed`` runs
the fused kernel (its full Vay form with the deposit) only below 4e6
particles, and ``--no-lite`` runs the non-QED deck through the full
form.  The bench runs on the CUDA device unless ``--device cpu`` asks
for the CPU (the kernels' plain versions); without a card, or with
fewer cards than ranks, it exits 1 and never falls back.  Flags of
``bench.py`` that the port does not have (the TPU-only knobs) are
refused with exit code 1.

Differences from ``bench.py``: the initial state is drawn on the host
by ``species.initialize`` (``bench.py`` draws it on the device with
another generator); the chunks of ``--steps-per-program`` are balanced
with the ceiling of steps / steps-per-program, so no chunk exceeds it;
and the QED deck's exchange window is twice ``bench.py``'s, whose
window loses the beam's re-entering electrons within a 50-step
program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .constants import ELECTRON_MASS, SPEED_OF_LIGHT

#: the estimated throughput of one 64-core CPU node of the reference
#: code, and the measured C++ proxy's (``bench.py:27-38``)
BASELINE_NODE_PUSHES_PER_SEC = 3.2e8
PROXY_NODE_PUSHES_PER_SEC = 1.1e9
METRIC = "macroparticle-pushes/sec/chip"

#: the deck's drift: the two counter-streaming populations move 0.0095
#: cells a step under CFL (``bench.py:333-336``)
BENCH_DRIFT_CELLS = 0.0095

#: the two streams' drift momentum in units of m_e c (``bench.py:508``)
BENCH_DRIFT_U = 2.5e-24 / (ELECTRON_MASS * SPEED_OF_LIGHT)

#: flags of bench.py the port refuses, with the reason
REFUSED = {
    "aot": "a TPU ahead-of-time compile; nothing to compile on a GPU",
    "mxu_gather": "a TPU gather variant; the kernel gathers 4 taps",
    "dynamic_gather": "a TPU gather variant; the kernel gathers 4 taps",
    "sort_rowgather": "a TPU sort variant; the port has one sort",
    "fused_subblocks": "a TPU grid-program knob; a GPU runs one block a CTA",
    "sorted_pipeline": "a TPU pipeline of the unfused species",
}


def _auto_window(block, npc, resort, v_spread):
    """Fused window covering a block's sorted cell span plus ``resort``
    steps of velocity-spread dispersion plus the kernel's fit margin
    (``bench.py:72-86``)."""
    gap = -(-block // max(1, npc))
    disp = int(np.ceil(0.95 * v_spread * resort))
    return max(8, -(-(gap + 5 + disp) // 4) * 4)


def _error_line(msg: str) -> str:
    """The JSON line of a void run (``bench.py:88-101``)."""
    return json.dumps({
        "metric": METRIC, "value": 0.0, "unit": "pushes/s",
        "vs_baseline": 0.0, "error": msg[:500],
    })


def _parser():
    p = argparse.ArgumentParser(
        prog="python -m opal_tpu_torch.bench",
        description="macroparticle pushes per second of the port's PIC "
                    "step (the twin of bench.py)")
    p.add_argument("--particles", type=float, default=8.0 * 2**20)
    p.add_argument("--nx", type=int, default=0,
                   help="grid cells (0 = auto: 1024, or max(1024, "
                        "particles / 128) for --qed)")
    p.add_argument("--steps", type=int, default=0,
                   help="steps of each block (0 = auto: 1024, or 400 at "
                        ">= 5e7 particles, or 50 for --qed)")
    p.add_argument("--steps-per-program", type=int, default=-1,
                   help="max steps of one Simulation.run call (-1 = auto, "
                        "as bench.py: max(64, 1.92e10 / particles), or 50 "
                        "for --qed; 0 = one call a block)")
    p.add_argument("--f64", action="store_true",
                   help="f64 state and fields (the unfused ops)")
    p.add_argument("--deposition", action="store_true", default=True)
    p.add_argument("--no-deposition", dest="deposition",
                   action="store_false")
    p.add_argument("--no-migration", dest="migration", action="store_false",
                   default=True, help="skip the edge exchange (the kernel "
                   "then serves no species)")
    p.add_argument("--fused", dest="fused", action="store_true",
                   default=None, help="the fused kernel (default, except "
                   "for --qed at >= 4e6 particles, as in bench.py)")
    p.add_argument("--no-fused", dest="fused", action="store_false")
    p.add_argument("--packed", dest="packed", action="store_true",
                   default=False, help="the packed layout and its kernel "
                   "instead of the column layout")
    p.add_argument("--no-packed", dest="packed", action="store_false")
    p.add_argument("--no-lite", dest="lite", action="store_false",
                   default=True, help="the kernel's full output set (prev_x, "
                   "gh, chi) on the non-QED deck instead of its lite form")
    p.add_argument("--fused-window", type=int, default=0,
                   help="window cells per block (0 = auto)")
    p.add_argument("--fused-block", type=int, default=0,
                   help="particles per kernel block (0 = auto: 8192, or "
                        "2048 for --qed)")
    p.add_argument("--fused-resort", type=int, default=0,
                   help="maintenance-sort cadence in steps (0 = auto: 320, "
                        "384 at >= 3.2e7 particles, 256 with "
                        "--migrate-every, 64 for --qed)")
    p.add_argument("--misfit-capacity", type=int, default=0,
                   help="misfit-fallback rows per step (0 = auto)")
    p.add_argument("--migrate-every", type=int, default=0,
                   help="exchange cadence in steps (0 = auto: half the "
                        "sort cadence, or 3 for --qed)")
    p.add_argument("--capacity-factor", type=float, default=0.0,
                   help="buffer slack over the population (0 = auto: 1.25, "
                        "1.1 at >= 5e7 particles)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the timed block with torch.profiler; the "
                        "operator table goes to DIR/profile.txt")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the CUDA device (default) or the CPU")
    p.add_argument("--qed", action="store_true",
                   help="QED emission and absorption on a beam deck (adds a "
                        "photon population)")
    p.add_argument("--no-absorption", dest="absorption",
                   action="store_false", default=True,
                   help="with --qed: emission only (colliding_beams.yaml's "
                        "physics)")
    p.add_argument("--chi", type=float, default=0.02,
                   help="with --qed: the quantum parameter of the gamma-1000 "
                        "beam in the static B field")
    p.add_argument("--absorption-block", type=int, default=32,
                   help="with --qed: candidates examined a walk pass")
    p.add_argument("--absorption-active", type=int, default=-1,
                   help="photons walked a step (-1 = auto: photon capacity "
                        "/ 4; 0 = every photon)")
    p.add_argument("--emission-active", type=int, default=-1,
                   help="emitters sampled a step (-1 = auto: electron "
                        "capacity / 32; 0 = every electron)")
    p.add_argument("--devices", type=int, default=1,
                   help="ranks on this host, one card each (the deck is "
                        "decomposed over them)")
    # refused: parsed only to name them in the refusal
    p.add_argument("--aot", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mxu-gather", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--dynamic-gather", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--sort-rowgather", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--fused-subblocks", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--sorted-pipeline", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def _refusal(args) -> str | None:
    for name, why in REFUSED.items():
        v = getattr(args, name)
        if v not in (None, False):
            flag = "--" + name.replace("_", "-")
            return f"{flag} is not ported: {why}"
    return None


def build(args, ring=None):
    """The deck of ``bench.py:326-560`` with its auto-sizing applied to
    ``args`` in place, decomposed over ``ring`` (``parallel.dist.Ring``,
    default a world of 1 on ``args.device``).  Returns (sim, fields,
    species, n_particles): this rank's fields and rows, and the
    particles of the whole deck."""
    from . import constants as const
    from .grid import GridGeometry
    from .parallel.dist import Ring
    from .sim import SimOptions, Simulation
    from .species import SpeciesSpec

    if ring is None:
        ring = Ring(device=torch.device(args.device))
    ndev = ring.world

    qed = args.qed
    if args.fused is None:
        # the fused kernel only below 4e6 particles on the QED deck
        # (bench.py:334)
        args.fused = not (qed and args.particles >= 4e6)
    if not args.nx:
        # the QED deck's beam geometry: npc 128
        args.nx = max(1024, int(args.particles) // 128) if qed else 1024
    if not args.steps:
        args.steps = 50 if qed else (1024 if args.particles < 5e7 else 400)
    if not args.capacity_factor:
        args.capacity_factor = 1.25 if args.particles < 5e7 else 1.1
    if not args.fused_resort:
        args.fused_resort = 64 if qed else 256 if args.migrate_every else (
            320 if args.particles < 3.2e7 else 384)
    if not args.migrate_every:
        # one exchange a half sort period: 160 * 0.0095 = 1.5 cells of
        # drift stay inside the 2-cell deposit and gather reach; the QED
        # beam marches at ~c
        args.migrate_every = 3 if qed else max(1, args.fused_resort // 2)
    if not args.fused_block:
        args.fused_block = 2048 if qed else 8192
    if not args.misfit_capacity:
        args.misfit_capacity = min(2048, max(256, int(args.particles) // 32768))
    nx = args.nx - args.nx % ndev
    npc = max(1, int(args.particles) // nx)
    n_particles = nx * npc

    dx = 1.0e-8 if qed else 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=ndev)
    cap = int(n_particles // ndev * args.capacity_factor)
    if args.fused:
        cap = -(-cap // args.fused_block) * args.fused_block
    # the QED working sets (bench.py:418-429; the photon capacity equals
    # the electron capacity)
    if args.emission_active < 0:
        args.emission_active = max(4096, cap // 32) if qed else 0
    if args.absorption_active < 0:
        args.absorption_active = max(4096, cap // 4) if qed else 0
    drift_cells = 0.95 if qed else BENCH_DRIFT_CELLS
    ceil8 = lambda v: -(-int(v) // 8) * 8
    opts = SimOptions(
        dt=dt, current_deposition=args.deposition, migration=args.migration,
        photon_emission=qed, photon_absorption=qed and args.absorption,
        # the leaver flux: npc x the drift (cells a step) a side x the
        # exchange cadence, with slack
        migration_capacity=ceil8(
            npc * args.migrate_every * 1.5 + 128 if qed else
            npc * args.migrate_every * BENCH_DRIFT_CELLS * 1.5 + 384),
        fused_misfit_capacity=args.misfit_capacity,
        absorption_candidates=64,
        absorption_block=args.absorption_block,
        absorption_active_capacity=args.absorption_active,
        emission_active_capacity=args.emission_active,
        fused_pusher=args.fused,
        packed_fused=args.packed,
        fused_lite=-1 if args.lite else 0,
        # the QED beam is one-directional at ~c: no velocity spread
        fused_window=args.fused_window or _auto_window(
            args.fused_block, npc, args.fused_resort,
            0.0 if qed else 2.0 * BENCH_DRIFT_U),
        fused_block=args.fused_block,
        fused_resort_every=args.fused_resort,
        migration_every=args.migrate_every,
        max_drift_cells_per_step=drift_cells,
        # the exchange window covers the leaver front over a sort period;
        # the QED beam's leavers all re-enter on one side, into the free
        # half of the tail window, so there it is doubled (bench.py's
        # window fills that half after 11 exchanges and voids its own
        # 50-step programs: ROADMAP C12)
        migration_window=max(4096, (2 if qed else 1) * ceil8(
            npc * (drift_cells * args.fused_resort + 3))),
    )
    dtype = torch.float64 if args.f64 else torch.float32
    espec = SpeciesSpec.electron()
    specs = {"electron": espec}
    if qed:
        specs["photon"] = SpeciesSpec.photon()
    sim = Simulation(geom, opts, specs, device=ring.device, dtype=dtype,
                     ring=ring)
    species = draw(sim, npc, cap, qed)
    E, B, J, rho = sim.init_fields()
    if qed:
        # the static transverse field that gives the gamma-1000 beam the
        # quantum parameter chi = gamma B / B_crit (bench.py:535-548)
        B[:, 2] = args.chi * const.CRITICAL_FIELD / (
            1000.0 * const.SPEED_OF_LIGHT)
    return sim, (E, B, J, rho), species, n_particles


def draw(sim, npc: int, cap: int, qed: bool) -> dict:
    """The deck's initial state (``bench.py:505-532``): the rank's block
    of the electrons (seed 0, ``npc`` a cell, the two streams' drift or
    the QED beam's gamma 1000) and, on the QED deck, of the photon
    buffer (seed 1, empty), each ``cap`` rows drawn on the rank's device
    by ``species.initialize_device``."""
    from .species import initialize_device

    ring, geom = sim.ring, sim.geom
    zeros = lambda x, u, n: torch.zeros_like(x)
    if qed:
        ux = lambda x, u, n: -1000.0 * (1.0 + 0.01 * n)
    else:
        ux = lambda x, u, n: BENCH_DRIFT_U * (1.0 + 0.001 * n) * torch.sign(
            u - 0.5)
    common = dict(dt=sim.options.dt, capacity_per_device=cap,
                  dtype=sim.dtype, rank=ring.rank, device=ring.device)
    species = {"electron": initialize_device(
        sim.specs["electron"], geom, npc, lambda x: np.full_like(x, 20.0),
        ux, zeros, zeros, seed=0, **common)}
    if qed:
        species["photon"] = initialize_device(
            sim.specs["photon"], geom, 0, lambda x: x * 0, zeros, zeros,
            zeros, seed=1, **common)
    return species


def chunk_steps(steps: int, steps_per_program: int, n_particles: int,
                qed: bool = False) -> int:
    """Steps of one ``Simulation.run`` call: at most
    ``steps_per_program`` (-1: ``bench.py``'s auto, ``max(64, 1.92e10 /
    n)``, or 50 for the QED deck; 0: the whole block), the chunks
    balanced with the ceiling of steps / steps-per-program so that none
    exceeds it."""
    spp = steps_per_program
    if spp < 0:
        spp = 50 if qed else max(64, int(1.92e10 / max(1, n_particles)))
    spp = min(spp or steps, steps)
    nchunks = -(-steps // max(1, spp))
    return -(-steps // nchunks)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    refused = _refusal(args)
    if refused:
        print(f"opal_tpu_torch.bench: {refused}", file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("opal_tpu_torch.bench: no CUDA device (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 1
    if args.devices <= 1:
        return _bench(args)
    if args.device == "cuda" and torch.cuda.device_count() < args.devices:
        print(f"opal_tpu_torch.bench: {args.devices} ranks need "
              f"{args.devices} CUDA devices and this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from .parallel import dist

    codes = dist.launch(_rank_main, args.devices, (argv,))
    return 0 if all(c == 0 for c in codes) else 1


def _rank_main(rank: int, world: int, init_method: str, argv):
    """One of ``--devices N``'s processes: rank ``rank`` of ``world``;
    only rank 0 prints."""
    import os

    from .parallel import dist

    args = _parser().parse_args(argv)
    ring = dist.init(rank, world, init_method, args.device)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
        sys.stderr = open(os.devnull, "w")
    try:
        rc = _bench(args, ring)
        ring.barrier()
    finally:
        dist.close(ring)
    sys.exit(rc)


def _bench(args, ring=None) -> int:
    """Build, warm up and time the deck on this rank; rank 0 prints the
    JSON line.  Every rank of ``ring`` runs it."""
    t0 = time.perf_counter()
    sim, (E, B, J, rho), species, n_particles = build(args, ring)
    ring, device = sim.ring, sim.device
    ndev = ring.world
    # every rank's work ends before a clock is read
    sync = ring.barrier if ring.group is not None else (
        (lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
        else (lambda: None))
    setup_s = time.perf_counter() - t0
    counters = sim.zero_counters()
    spp = chunk_steps(args.steps, args.steps_per_program, n_particles,
                      args.qed)
    # the QED draws: one generator a rank on its device
    from .species import rank_seed

    rng = (torch.Generator(device=device).manual_seed(rank_seed(0, ring.rank))
           if args.qed else None)

    def run_block(E, B, J, rho, species, t, counters):
        done = 0
        while done < args.steps:
            n = min(spp, args.steps - done)
            E, B, J, rho, species, t, counters = sim.run(
                E, B, J, rho, species, t, counters, n, rng=rng)
            done += n
        return E, B, J, rho, species, t, counters

    # two warm-up blocks (the first builds the kernels), then the timed
    # block of the same step count
    t0 = time.perf_counter()
    out = run_block(E, B, J, rho, species, 0.0, counters)
    sync()
    warm_s = time.perf_counter() - t0
    out = run_block(*out)
    sync()
    t0 = time.perf_counter()
    if args.profile and ring.rank == 0:
        from .cli import _profiled

        out = _profiled(lambda: run_block(*out), Path(args.profile), device)
    else:
        out = run_block(*out)
    sync()
    elapsed = time.perf_counter() - t0

    # the whole run's pushes a second, and a chip's share of them
    pushes_per_sec = n_particles * args.steps / elapsed
    per_chip = pushes_per_sec / ndev
    counts = {k: int(v) for k, v in out[6].items()}
    deferred = counts.pop("qed_deferred", 0)
    if any(counts.values()):
        # the step did not do the reference's work (every particle
        # pushed every step): the number is void
        print(f"# ERROR buffer-overflow particle losses: {counts}",
              file=sys.stderr)
        print(_error_line(
            f"invalid: buffer-overflow particle losses {counts} over "
            f"{3 * args.steps} steps at {per_chip:.4g} pushes/s/chip "
            "(number void: lost particles were not pushed/deposited)"))
        return 0
    if deferred:
        print(f"# note: QED active-set backlog: {deferred} particle-steps "
              "deferred (delays, not losses)", file=sys.stderr)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if args.verbose:
        photons = (f" photons={int(out[4]['photon'].alive.sum())}"
                   if args.qed else "")
        print(f"# device={kind} x{ndev} N={n_particles:.3g} "
              f"steps={args.steps} "
              f"chunk={spp} setup={setup_s:.3f}s warmup={warm_s:.1f}s "
              f"run={elapsed:.2f}s steps/s={args.steps / elapsed:.2f}"
              f"{photons}", file=sys.stderr)
    print(json.dumps({
        "metric": METRIC,
        "value": per_chip,
        "unit": "pushes/s",
        "vs_baseline": pushes_per_sec / BASELINE_NODE_PUSHES_PER_SEC,
        "vs_node_proxy": pushes_per_sec / PROXY_NODE_PUSHES_PER_SEC,
        "device": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
