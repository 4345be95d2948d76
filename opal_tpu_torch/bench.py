"""Benchmark of the port: macroparticle pushes per second of the full
PIC step on one CUDA device.

    python -m opal_tpu_torch.bench [--packed] [flags]

The twin of the JAX package's ``bench.py``: the same deck (a periodic
two-stream plasma, 8*2**20 electrons over nx 1024, all-f32, Vay push,
deposition and migration on), the same auto-sizing of the fused
kernel's block, window, sort and exchange cadences and capacities, the
same timed block (two warm-up blocks, then one timed block of the same
step count, the device synchronised at both ends of it), and ONE json
line on standard output:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "vs_node_proxy": ..., "device": ...}

(``device`` names the card, or ``cpu``).

Any counted loss (migration, misfit or deposit-reach overflow) voids
the run: the line then carries ``"value": 0.0`` and an ``error``.  The
bench runs on the CUDA device unless ``--device cpu`` asks for the CPU
(the kernels' plain versions); without a card it exits 1 and never
falls back.  Flags of ``bench.py`` that the port does not have (QED,
several devices, the TPU-only knobs) are refused with exit code 1.

Differences from ``bench.py``: the initial state is drawn on the host
by ``species.initialize`` (``bench.py`` draws it on the device with
another generator), and the chunks of ``--steps-per-program`` are
balanced with the ceiling of steps / steps-per-program, so no chunk
exceeds it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: the estimated throughput of one 64-core CPU node of the reference
#: code, and the measured C++ proxy's (``bench.py:27-38``)
BASELINE_NODE_PUSHES_PER_SEC = 3.2e8
PROXY_NODE_PUSHES_PER_SEC = 1.1e9
METRIC = "macroparticle-pushes/sec/chip"

#: the deck's drift: the two counter-streaming populations move 0.0095
#: cells a step under CFL (``bench.py:333-336``)
BENCH_DRIFT_CELLS = 0.0095

#: flags of bench.py the port refuses, with the reason
REFUSED = {
    "qed": "QED decks need photon absorption, not yet ported",
    "no_absorption": "a --qed flag; QED decks are not yet ported",
    "chi": "a --qed flag; QED decks are not yet ported",
    "absorption_block": "a --qed flag; QED decks are not yet ported",
    "absorption_active": "a --qed flag; QED decks are not yet ported",
    "emission_active": "a --qed flag; QED decks are not yet ported",
    "devices": "only one device is ported",
    "aot": "a TPU ahead-of-time compile; nothing to compile on a GPU",
    "mxu_gather": "a TPU gather variant; the kernel gathers 4 taps",
    "dynamic_gather": "a TPU gather variant; the kernel gathers 4 taps",
    "sort_rowgather": "a TPU sort variant; the port has one sort",
    "fused_subblocks": "a TPU grid-program knob; a GPU runs one block a CTA",
    "sorted_pipeline": "a TPU pipeline of the unfused species",
    "no_lite": "the full outputs serve QED decks only",
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
                   help="grid cells (0 = auto: 1024)")
    p.add_argument("--steps", type=int, default=0,
                   help="steps of each block (0 = auto: 1024, or 400 at "
                        ">= 5e7 particles)")
    p.add_argument("--steps-per-program", type=int, default=-1,
                   help="max steps of one Simulation.run call (-1 = auto, "
                        "as bench.py: max(64, 1.92e10 / particles); 0 = "
                        "one call a block)")
    p.add_argument("--f64", action="store_true",
                   help="f64 state and fields (the unfused ops)")
    p.add_argument("--deposition", action="store_true", default=True)
    p.add_argument("--no-deposition", dest="deposition",
                   action="store_false")
    p.add_argument("--no-migration", dest="migration", action="store_false",
                   default=True, help="skip the edge exchange (the kernel "
                   "then serves no species)")
    p.add_argument("--fused", dest="fused", action="store_true",
                   default=True, help="the fused kernel (default)")
    p.add_argument("--no-fused", dest="fused", action="store_false")
    p.add_argument("--packed", dest="packed", action="store_true",
                   default=False, help="the packed layout and its kernel "
                   "instead of the column layout")
    p.add_argument("--no-packed", dest="packed", action="store_false")
    p.add_argument("--fused-window", type=int, default=0,
                   help="window cells per block (0 = auto)")
    p.add_argument("--fused-block", type=int, default=0,
                   help="particles per kernel block (0 = auto: 8192)")
    p.add_argument("--fused-resort", type=int, default=0,
                   help="maintenance-sort cadence in steps (0 = auto: 320, "
                        "384 at >= 3.2e7 particles, 256 with "
                        "--migrate-every)")
    p.add_argument("--misfit-capacity", type=int, default=0,
                   help="misfit-fallback rows per step (0 = auto)")
    p.add_argument("--migrate-every", type=int, default=0,
                   help="exchange cadence in steps (0 = auto: half the "
                        "sort cadence)")
    p.add_argument("--capacity-factor", type=float, default=0.0,
                   help="buffer slack over the population (0 = auto: 1.25, "
                        "1.1 at >= 5e7 particles)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="profile the timed block with torch.profiler; the "
                        "operator table goes to DIR/profile.txt")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the CUDA device (default) or the CPU")
    # refused: parsed only to name them in the refusal
    p.add_argument("--qed", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--no-absorption", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--chi", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--absorption-block", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--absorption-active", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--emission-active", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--devices", type=int, default=None,
                   help=argparse.SUPPRESS)
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
    p.add_argument("--no-lite", action="store_true", help=argparse.SUPPRESS)
    return p


def _refusal(args) -> str | None:
    for name, why in REFUSED.items():
        v = getattr(args, name)
        if name == "devices" and v in (None, 1):
            continue
        if v not in (None, False):
            flag = "--" + name.replace("_", "-")
            return f"{flag} is not ported: {why}"
    return None


def build(args):
    """The deck of ``bench.py:296-525`` with its auto-sizing applied to
    ``args`` in place.  Returns (sim, fields, species, n_particles)."""
    from . import constants as const
    from .grid import GridGeometry
    from .sim import SimOptions, Simulation
    from .species import SpeciesSpec, initialize

    if not args.nx:
        args.nx = 1024
    if not args.steps:
        args.steps = 1024 if args.particles < 5e7 else 400
    if not args.capacity_factor:
        args.capacity_factor = 1.25 if args.particles < 5e7 else 1.1
    if not args.fused_resort:
        args.fused_resort = 256 if args.migrate_every else (
            320 if args.particles < 3.2e7 else 384)
    if not args.migrate_every:
        # one exchange a half sort period: 160 * 0.0095 = 1.5 cells of
        # drift stay inside the 2-cell deposit and gather reach
        args.migrate_every = max(1, args.fused_resort // 2)
    if not args.fused_block:
        args.fused_block = 8192
    if not args.misfit_capacity:
        args.misfit_capacity = min(2048, max(256, int(args.particles) // 32768))
    nx = args.nx
    npc = max(1, int(args.particles) // nx)
    n_particles = nx * npc

    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
    cap = int(n_particles * args.capacity_factor)
    if args.fused:
        cap = -(-cap // args.fused_block) * args.fused_block
    # the deck's drift momentum in units of m_e c
    drift = 2.5e-24 / (const.ELECTRON_MASS * const.SPEED_OF_LIGHT)
    ceil8 = lambda v: -(-int(v) // 8) * 8
    opts = SimOptions(
        dt=dt, current_deposition=args.deposition, migration=args.migration,
        # the leaver flux: npc x the drift (cells a step) a side x the
        # exchange cadence, with slack
        migration_capacity=ceil8(
            npc * args.migrate_every * BENCH_DRIFT_CELLS * 1.5 + 384),
        fused_misfit_capacity=args.misfit_capacity,
        fused_pusher=args.fused,
        packed_fused=args.packed,
        fused_window=args.fused_window or _auto_window(
            args.fused_block, npc, args.fused_resort, 2.0 * drift),
        fused_block=args.fused_block,
        fused_resort_every=args.fused_resort,
        migration_every=args.migrate_every,
        max_drift_cells_per_step=BENCH_DRIFT_CELLS,
        # the exchange window covers the leaver front over a sort period
        migration_window=max(
            4096, ceil8(npc * (BENCH_DRIFT_CELLS * args.fused_resort + 3))),
    )
    dtype = torch.float64 if args.f64 else torch.float32
    espec = SpeciesSpec.electron()
    sim = Simulation(geom, opts, {"electron": espec}, device=args.device,
                     dtype=dtype)
    state = initialize(
        espec, geom, npc,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, n: drift * (1.0 + 0.001 * n) * np.sign(u - 0.5),
        uy=lambda x, u, n: np.zeros_like(x),
        uz=lambda x, u, n: np.zeros_like(x),
        dt=dt, capacity_per_device=cap, seed=0,
        dtype=np.float64 if args.f64 else np.float32, device=args.device,
    )
    return sim, sim.init_fields(), {"electron": state}, n_particles


def chunk_steps(steps: int, steps_per_program: int, n_particles: int) -> int:
    """Steps of one ``Simulation.run`` call: at most
    ``steps_per_program`` (-1: ``bench.py``'s auto, ``max(64, 1.92e10 /
    n)``; 0: the whole block), the chunks balanced with the ceiling of
    steps / steps-per-program so that none exceeds it."""
    spp = steps_per_program
    if spp < 0:
        spp = max(64, int(1.92e10 / max(1, n_particles)))
    spp = min(spp or steps, steps)
    nchunks = -(-steps // max(1, spp))
    return -(-steps // nchunks)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    refused = _refusal(args)
    if refused:
        print(f"opal_tpu_torch.bench: {refused}", file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("opal_tpu_torch.bench: no CUDA device (pass --device cpu to "
              "run on the CPU)", file=sys.stderr)
        return 1
    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)

    t0 = time.perf_counter()
    sim, (E, B, J, rho), species, n_particles = build(args)
    setup_s = time.perf_counter() - t0
    counters = sim.zero_counters()
    spp = chunk_steps(args.steps, args.steps_per_program, n_particles)

    def run_block(E, B, J, rho, species, t, counters):
        done = 0
        while done < args.steps:
            n = min(spp, args.steps - done)
            E, B, J, rho, species, t, counters = sim.run(
                E, B, J, rho, species, t, counters, n)
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
    if args.profile:
        from .cli import _profiled

        out = _profiled(lambda: run_block(*out), Path(args.profile), device)
    else:
        out = run_block(*out)
    sync()
    elapsed = time.perf_counter() - t0

    pushes_per_sec = n_particles * args.steps / elapsed
    counts = {k: int(v) for k, v in out[6].items()}
    if any(counts.values()):
        # the step did not do the reference's work (every particle
        # pushed every step): the number is void
        print(f"# ERROR buffer-overflow particle losses: {counts}",
              file=sys.stderr)
        print(_error_line(
            f"invalid: buffer-overflow particle losses {counts} over "
            f"{3 * args.steps} steps at {pushes_per_sec:.4g} pushes/s/chip "
            "(number void: lost particles were not pushed/deposited)"))
        return 0
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if args.verbose:
        print(f"# device={kind} x1 N={n_particles:.3g} steps={args.steps} "
              f"chunk={spp} setup={setup_s:.1f}s warmup={warm_s:.1f}s "
              f"run={elapsed:.2f}s steps/s={args.steps / elapsed:.2f}",
              file=sys.stderr)
    print(json.dumps({
        "metric": METRIC,
        "value": pushes_per_sec,
        "unit": "pushes/s",
        "vs_baseline": pushes_per_sec / BASELINE_NODE_PUSHES_PER_SEC,
        "vs_node_proxy": pushes_per_sec / PROXY_NODE_PUSHES_PER_SEC,
        "device": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
