"""The periodic electron decks (upstream opal's
``examples/two_stream.yaml`` kind): counter-streaming electrons on a
periodic grid, Vay push, charge-conserving deposit, no QED.

The start state is the benchmark's own draw from ``--seed``, made on the
card in a few large calls a chunk of cells: ``npc`` electrons
a cell, in cell order (row ``i`` of a chunk in its cell ``i // npc``), offsets
uniform in the cell, ux the deck's drift times ``1 + spread * N(0, 1)``
with a sign drawn by a uniform, uy = uz = 0, every weight
``ne * dx / npc``, and zero fields.  The program gets it as its
``ParticleState`` with the capacity's dead rows after the live ones;
the reference gets the same live electrons.

A segment runs the deck ``segment_steps`` steps from that state in one
``Simulation.run`` call, with the fused path's sizes of the cell's
``knobs``.  On a cell of several chips the
grid is cut into one slab a rank, a process and a card each
(``parallel.dist.launch``, NCCL), and rank 0 prints the result; the
draw of a cell is the same however the grid is cut.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from pic_bench import harness
from pic_bench.reference import compare, pic1d


def chunk_seed(seed: int, chunk: int) -> int:
    return (seed * 65537 + chunk) % 2**63


def draw_cells(cfg: dict, seed: int, lo: int, hi: int, device) -> dict:
    """The live electrons of the global cells [lo, hi), whole chunks of
    the configuration's ``draw_chunk_cells``: global ``cell`` (int32),
    ``x``, ``ux`` (float32), each chunk from its own generator on
    ``device``, so that the draw of a cell does not depend on how the
    grid is cut into ranks."""
    npc, chunk = cfg["npc"], cfg["draw_chunk_cells"]
    parts = []
    for j in range(lo // chunk, hi // chunk):
        n = chunk * npc
        g = torch.Generator(device=device)
        g.manual_seed(chunk_seed(seed, j))
        x = torch.rand(n, generator=g, device=device)
        urand = torch.rand(n, generator=g, device=device)
        nrand = torch.randn(n, generator=g, device=device)
        ux = cfg["drift_u"] * (1.0 + cfg["spread"] * nrand) * torch.where(
            urand < 0.5, -1.0, 1.0)
        cell = j * chunk + torch.div(
            torch.arange(n, device=device, dtype=torch.int32), npc,
            rounding_mode="floor")
        parts.append((cell, x, ux))
    return {k: torch.cat([p[i] for p in parts])
            for i, k in enumerate(("cell", "x", "ux"))}


def weight(cfg: dict) -> float:
    return cfg["ne"] * cfg["dx"] / cfg["npc"]


def program_state(blk: dict, cap: int, cfg: dict, dt: float):
    """The program's electron state of ``cap`` rows: the block's live
    rows, then dead ones."""
    from opal_tpu_torch.species import ParticleState

    n = blk["x"].numel()
    dev = blk["x"].device

    def col(a, dead):
        return torch.cat([a, torch.full((cap - n,), dead, dtype=a.dtype,
                                        device=dev)])

    ux = blk["ux"]
    gamma = torch.sqrt(1.0 + ux * ux)
    zero = torch.zeros(n, device=dev)
    return ParticleState(
        cell=col(blk["cell"], 0), x=col(blk["x"], 0.0),
        prev_x=col(blk["x"] - pic1d.C * (ux / gamma) * dt / cfg["dx"], 0.0),
        y=col(zero, 0.0), z=col(zero, 0.0),
        weight=col(torch.full_like(zero, weight(cfg)), 0.0),
        ux=col(ux, 0.0), uy=col(zero, 0.0), uz=col(zero, 0.0),
        gamma=col(gamma, 1.0), chi=col(zero, 0.0),
        tau=col(torch.full_like(zero, float("inf")), float("inf")),
        tau_abs=None, tau_st=None, work=col(zero, 0.0), birth_time=None,
        alive=col(torch.ones(n, dtype=torch.bool, device=dev), False))


def clone(st):
    return dataclasses.replace(
        st, **{k: v.clone() for k, v in st.columns().items()})


class Deck:
    """The program's deck on one rank of ``ring``, its segment's start
    state, and the losses its segments counted."""

    def __init__(self, run: harness.Run, ring):
        from opal_tpu_torch.grid import GridGeometry
        from opal_tpu_torch.sim import SimOptions, Simulation
        from opal_tpu_torch.species import SpeciesSpec

        cfg, cell, k = run.config, run.cell, run.cell["knobs"]
        self.cfg, self.ring, self.knobs = cfg, ring, k
        self.dt = cfg["cfl"] * cfg["dx"] / pic1d.C
        self.steps = int(cell["segment_steps"])
        self.packed = cell["layout"] == "packed"
        geom = GridGeometry(nx=cfg["nx"], dx=cfg["dx"], xmin=0.0,
                            n_devices=ring.world)
        n_loc = geom.n_loc
        self.cap = -(-int(n_loc * cfg["npc"] * k["capacity_factor"])
                     // k["fused_block"]) * k["fused_block"]
        opts = SimOptions(
            dt=self.dt, current_deposition=True, migration=True,
            fused_pusher=True, packed_fused=self.packed, fused_lite=-1,
            fused_block=k["fused_block"], fused_window=k["fused_window"],
            fused_resort_every=k["fused_resort_every"],
            fused_misfit_capacity=k["fused_misfit_capacity"],
            migration_every=k["migration_every"],
            migration_capacity=k["migration_capacity"],
            migration_window=k["migration_window"],
            max_drift_cells_per_step=k["max_drift_cells_per_step"])
        self.sim = Simulation(geom, opts, {"electron": SpeciesSpec.electron()},
                              device=ring.device, dtype=torch.float32,
                              ring=ring)
        lo = ring.rank * n_loc
        blk = draw_cells(cfg, run.seed, lo, lo + n_loc, ring.device)
        blk["cell"] = blk["cell"] - lo
        self.start = program_state(blk, self.cap, cfg, self.dt)
        self.live = blk["x"].numel()
        self.losses = torch.zeros((), dtype=torch.int64, device=ring.device)

    def segment(self):
        """One replay of the segment from its start state: its
        (E, B, electrons)."""
        sim = self.sim
        E, B, J, rho = sim.init_fields()
        E, B, _, _, species, _, counters = sim.run(
            E, B, J, rho, {"electron": clone(self.start)}, 0.0,
            sim.zero_counters(), self.steps)
        self.losses = self.losses + sum(counters.values())
        return E, B, species["electron"]

    def trace_context(self) -> dict:
        from opal_tpu_torch.grid import HALO
        from opal_tpu_torch.ops.fused import PAD

        form = "vay_packed" if self.packed else "vay"
        return {"push_deposit": {form: dict(
            rows=self.cap, live=self.live, block=self.knobs["fused_block"],
            table_rows=self.sim.geom.n_loc + 2 * HALO + 2 * PAD,
            work_in=not self.packed)}}

    def summary(self, out) -> dict:
        """The order-free summary of the segment's output, summed over
        the ranks (the fields of each rank in its own slab)."""
        E, B, st = out
        geom, ring = self.sim.geom, self.ring
        n_loc, nx = geom.n_loc, self.cfg["nx"]
        Eg = torch.zeros((nx, 3), dtype=E.dtype, device=E.device)
        Bg = torch.zeros_like(Eg)
        lo = ring.rank * n_loc
        Eg[lo:lo + n_loc], Bg[lo:lo + n_loc] = E, B
        s = compare.summarize(st.cell.long() + lo, st.ux, st.alive, Eg, Bg, nx)
        return {k: ring.psum(v) for k, v in s.items()}


def reference_summary(cfg: dict, seed: int, steps: int, device,
                      dtype=torch.float32, ring=None) -> dict:
    """The plain reference over the whole deck from the same start state,
    drawn again here: its summary.  On a ring of several ranks each rank
    takes the electrons of its slab's cells at the start and keeps them,
    the grid whole on every rank and the currents summed over the ranks
    each step (no decomposition of the grid, no exchange), and every rank
    gets the summed summary."""
    nx = cfg["nx"]
    world, rank = (1, 0) if ring is None else (ring.world, ring.rank)
    allreduce = None
    if world > 1:
        def allreduce(t):
            t = t.clone()
            torch.distributed.all_reduce(t, group=ring.group)
            return t
    blk = draw_cells(cfg, seed, rank * nx // world, (rank + 1) * nx // world,
                     device)
    cell, x, ux = blk["cell"].long(), blk["x"], blk["ux"]
    del blk
    u = torch.stack([ux, torch.zeros_like(ux), torch.zeros_like(ux)], dim=1)
    w = torch.full_like(x, weight(cfg))
    zeros = torch.zeros((nx, 3), device=device)
    dt = cfg["cfl"] * cfg["dx"] / pic1d.C
    cell, x, u, E, B = pic1d.run_electrons(cell, x, u, w, zeros, zeros,
                                           cfg["dx"], dt, steps, dtype,
                                           allreduce)
    if rank != 0:
        E, B = torch.zeros_like(E), torch.zeros_like(B)
    s = compare.summarize(cell, u[:, 0].float(), torch.ones_like(
        cell, dtype=torch.bool), E.float(), B.float(), nx)
    return s if allreduce is None else {k: allreduce(v) for k, v in s.items()}


def measure(run: harness.Run, ring) -> int:
    """Set up, warm up, measure and check one run on this rank; rank 0
    prints the result."""
    world = ring.world
    cuda = ring.device.type == "cuda"
    if ring.group is not None:
        sync = ring.barrier

        def agree(stop):
            flag = torch.tensor(float(stop and ring.rank == 0),
                                device=ring.device)
            return bool(ring.psum(flag) > 0)
    else:
        sync = (lambda: torch.cuda.synchronize(ring.device)) if cuda else (
            lambda: None)
        agree = None

    deck = Deck(run, ring)
    live = int(ring.psum(torch.tensor(deck.live, device=ring.device)))
    # the warm-up: one replay, so that every kernel the window runs is
    # built and loaded (CUDA loads a module at its first launch)
    deck.segment()
    sync()
    setup_s = run.setup_s()
    deck.losses.zero_()

    if run.trace:
        out, trace = harness.traced(deck.segment, sync, deck.steps,
                                    deck.trace_context())
        elapsed, segments = trace.wall_s, 1
        busy = float(ring.psum(torch.tensor(trace.busy_s(),
                                            device=ring.device))) / world
    else:
        elapsed, segments, out = harness.window(deck.segment, run.seconds,
                                                sync, agree)
    pushes = live * deck.steps * segments
    failed = int(deck.losses)
    peak = torch.tensor(float(torch.cuda.max_memory_allocated(ring.device)
                              if cuda else 0), device=ring.device)
    if ring.group is not None:
        torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX,
                                     group=ring.group)
    prog = deck.summary(out)
    del out, deck
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_summary(run.config, run.seed, run.cell["segment_steps"],
                            ring.device, ring=ring)
    ref_s = time.perf_counter() - t0
    if ring.rank != 0:
        return 0

    device = harness.device_info(ring.device, world, int(peak))
    extra = {}
    if run.trace:
        metrics = harness.read_metrics(run, trace)
        device.update(busy_s=busy, window_s=elapsed)
        extra["breakdown"] = trace.breakdown()
        del trace
    else:
        values = {"pushes_per_s": pushes / elapsed / world,
                  "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": u}
                   for k, u in run.metrics.items()}
    print(f"pic_bench: {segments} segment(s) of {run.cell['segment_steps']} "
          f"steps in {elapsed!r} s; setup {setup_s!r} s; reference "
          f"{ref_s!r} s; memory peak {int(peak)} B; losses {failed}",
          file=sys.stderr)
    checks = compare.compare(prog, ref, run.config["drift_u"])
    result = dict(correct=failed == 0, attempted=pushes, failed=failed,
                  metrics=metrics, device=device, **extra)
    return harness.report(result, checks, run.cell["limits"])


def _rank_main(rank: int, world: int, init_method: str, run: harness.Run):
    """One rank of a decomposed cell: its own process and card."""
    import os

    from opal_tpu_torch.parallel import dist

    ring = dist.init(rank, world, init_method, "cuda")
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        rc = measure(run, ring)
        ring.barrier()
    finally:
        dist.close(ring)
    sys.exit(rc)


def main(run: harness.Run) -> int:
    world = int(run.cell["chips"])
    if world == 1:
        from opal_tpu_torch.parallel.dist import Ring

        return measure(run, Ring(device=torch.device("cuda", 0)))
    from opal_tpu_torch.parallel import dist

    codes = dist.launch(_rank_main, world, (run,))
    return next((c for c in codes if c != 0), 0)
