"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile DIR   # phases 1, 2 and a profiled phase 8

Builds the port's CUDA kernel from ``opal_tpu_torch/csrc`` and drives
the port on the card, phase by phase, each printing one line or more:

1. device: the card, the CUDA version and ``nvidia-smi``'s name and
   power limit (there is no CPU fallback: without a card this exits 1);
2. build: ``nvcc`` of the kernel sources, and the compiler's resource
   report;
3. kernel vs plain: the fused kernel against its plain PyTorch version
   on the same CUDA tensors, at the bench shape (8.39M electrons, nx
   1024, block 8192, window 12) and at the two_stream CLI shape (1e5
   electrons, nx 1000, block 2048, window 40), with both times; then a
   small two-stream deck stepped through ``Simulation`` on the card and
   on the CPU, whose fields and energies must agree;
4. CLI drive (the main path): ``opal_tpu_torch.cli.main`` on
   ``examples/two_stream.yaml`` at its full width, cut to 2000 steps
   over 4 outputs, with the kernel's launch count;
5. bench scale: the 8.39M-electron periodic deck of ``bench.py``'s
   defaults through ``Simulation`` for two sort periods (640 steps);
6. hole_boring kernels vs plain: the Boris form (carbon ions) and the
   Vay form with the work increment (electrons) against their plain
   versions at the hole_boring shapes (753,664 rows a species, block
   2048, window 56, n_rows 20,228), on the deck's sorted initial states
   and random laser-strength fields, with both times;
7. a small hole_boring deck (nx 800, npc 10, 200 steps, both species)
   stepped on the card and on the CPU, whose fields and energies must
   agree;
8. hole_boring CLI drive (this slice's main path):
   ``opal_tpu_torch.cli.main`` on ``examples/hole_boring.yaml`` at its
   full width (nx 20,000, npc 100 a species), with the slab moved to
   -9..-4 um and the run cut to t = -19..-7 um/c (12,630 steps over 3
   outputs), so that the pulse's peak reaches the slab: the launches of
   each kernel form, the losses, the outputs and the ions' heating.

Phases 1-8 take about five minutes.  Any failed check raises, so the
script exits non-zero without the final line.  Before the last line it
prints one JSON object describing each kernel form of the paths, and
``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL = dict(
    route="cuda",
    source="opal_tpu_torch/csrc/fused_push_deposit.cu",
    replaces="opal_tpu/ops/fused.py:727",
)
#: the H100 SXM's HBM rate and f32 (non-tensor-core) peak, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations a pushed row costs, counted from the kernel source:
#: the 4-tap gather ~114, the push (Vay ~113, Boris ~81), the x/y/z
#: advance ~10, the deposit's weights, fluxes and 15 adds ~143
OPS_PER_ROW = {"vay": 380, "boris": 348}
# bench.py's non-QED defaults (bench.py:145-498)
BENCH = dict(particles=8 * 2**20, nx=1024, block=8192, window=12,
             resort=320, migrate=160, misfit=256, drift_cells=0.0095,
             capacity_factor=1.25)


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20):
    """Median milliseconds of ``fn()`` on the current stream, each call
    timed with its own pair of CUDA events after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def two_stream_state(geom, npc, cap, dt, device, seed=0):
    """The bench/two_stream electron population: density 20 m^-1 per
    cell width, counter-streaming at +-2.5e-24 kg m/s with 0.1% spread."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.species import SpeciesSpec, initialize

    drift = 2.5e-24 / (const.ELECTRON_MASS * const.SPEED_OF_LIGHT)
    return initialize(
        SpeciesSpec.electron(), geom, npc,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, n: drift * (1.0 + 0.001 * n) * np.sign(u - 0.5),
        uy=lambda x, u, n: np.zeros_like(x),
        uz=lambda x, u, n: np.zeros_like(x),
        dt=dt, capacity_per_device=cap, seed=seed, dtype=np.float32,
        device=device,
    )


def bound(spec, n_rows_state, n_pushed):
    """(bound_ms, bound_by): the least time the card could take for one
    launch: each input column read once and each output written once
    (4 B a value: 9 inputs, the work column when it is read, the 8
    updated columns, the work output and ``miss``; the anchors both
    ways, the field table read, the deposit slab written) over the HBM
    rate, against the f32 operations of the rows that were pushed over
    the f32 peak."""
    cols = 9 + (spec.work_out and not spec.work_inc) + 8 + spec.work_out + 1
    nblk = n_rows_state // spec.block
    nbytes = 4 * (cols * n_rows_state + 2 * nblk + spec.n_rows * (8 + 16))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_pushed * OPS_PER_ROW[spec.pusher] / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_vs_plain(label, st, spec, fields_seed=1, e_scale=10.0,
                    b_scale=1e-8, phase=3):
    """Compare the kernel with its plain version on one sorted state and
    random E/B (E ~ ``e_scale`` V/m, B ~ ``b_scale`` T); returns
    (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    dev = st.x.device
    n_loc = spec.n_rows - 2 * F.PAD - 8
    st = sort_state(st, n_loc)
    g = torch.Generator(device="cpu").manual_seed(fields_seed)
    E = (e_scale * torch.randn(n_loc + 8, 3, generator=g)).to(dev)
    B = (b_scale * torch.randn(n_loc + 8, 3, generator=g)).to(dev)
    eb = F.make_eb_rows(E, B)
    anchors = F.block_anchors(spec, st.cell)
    work = st.work if spec.work_out and not spec.work_inc else None
    args = (spec, anchors, st.cell, st.x, st.y, st.z, st.ux, st.uy, st.uz,
            st.gamma, st.weight, work, eb)
    ck, mk, ok, ak = F.fused_push_deposit(*args)
    cr, mr, orf, ar = F.fused_push_deposit_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(mk, mr), "miss flags differ"
    assert torch.equal(ak, ar), "next anchors differ"
    bitwise = all(torch.equal(ck[c], cr[c]) for c in cr)
    push_err = max((ck[c].double() - cr[c].double()).abs().max().item()
                   for c in cr)
    assert bitwise, f"push columns differ from the plain version ({push_err})"
    slab_err = (ok - orf).abs().max().item()
    scale = orf.abs().max().item()
    assert scale > 0 and slab_err <= 1e-5 * scale, (slab_err, scale)
    ms = cuda_ms(lambda: F.fused_push_deposit(*args))
    plain_ms = cuda_ms(lambda: F.fused_push_deposit_reference(*args))
    n_alive = int(st.alive.sum())
    n_miss = int(mk.sum().item())
    bound_ms, bound_by = bound(spec, st.cell.shape[0], n_alive - n_miss)
    log(phase, f"{label} ({spec.pusher}{', work_inc' if spec.work_inc else ''}"
               f"): rows {st.cell.shape[0]} (alive {n_alive}), block "
               f"{spec.block}, window {spec.window}, n_rows {spec.n_rows}: "
               f"push columns, miss and anchors bitwise equal; slab max "
               f"|err| {slab_err:.3e} (max |slab| {scale:.3e}); misses "
               f"{n_miss}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
               f"(median of 20), bound {bound_ms:.4f} ms ({bound_by})")
    return max(push_err, slab_err), ms, plain_ms, bound_ms, bound_by


def small_deck(tmp: Path, nx=128, npc=64, steps=40, outputs=2) -> Path:
    from opal_tpu_torch import constants as const

    dt = 0.95 * 500.0 / const.SPEED_OF_LIGHT
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", f"nx: {nx}").replace("npc: 100", f"npc: {npc}")
    src = src.replace("end: 0.1", f"end: {(steps + 0.5) * dt!r}")
    src = src.replace("n_outputs: 20", f"n_outputs: {outputs}")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "deck.yaml").write_text(src)
    return tmp / "deck.yaml"


def card_vs_cpu(tmp: Path):
    """A small deck stepped on the card (kernel) and on the CPU (plain
    version): f32 particles, f64 fields; the CUDA and CPU float ops round
    alike but the deposit adds in another order, so fields and energies
    agree to within 1e-5 of their scale."""
    from opal_tpu_torch.cli import build

    deck = small_deck(tmp / "small")
    out = {}
    for dev in ("cuda", "cpu"):
        sim, sp, _ = build(deck, device=dev)
        assert sim._fused_applicable("electron", sp["electron"])
        res = sim.run(*sim.init_fields(), sp, 0.0, sim.zero_counters(), 40)
        assert int(res[6]["electron"]) == 0
        out[dev] = (res, sim.em_field_energy(res[0], res[1]),
                    sim.total_kinetic_energy("electron", res[4]["electron"]))
    (rc, fc, kc), (rp, fp, kp) = out["cuda"], out["cpu"]
    worst = 0.0
    for i, name in enumerate(("E", "B", "J", "rho")):
        a, b = rc[i].cpu(), rp[i]
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
        assert err < 1e-5, (name, err)
        worst = max(worst, err)
    assert abs(fc - fp) <= 1e-5 * abs(fp) and abs(kc - kp) <= 1e-5 * abs(kp)
    log(3, f"small two-stream deck (nx 128, npc 64, 40 steps), card vs CPU: "
           f"fields within {worst:.2e} of their scale, field energy "
           f"{fc:.6e} vs {fp:.6e} J, kinetic {kc:.6e} vs {kp:.6e} J")


def cli_drive(tmp: Path, steps=2000, outputs=4):
    """The main path through the user's entry point; returns (launches,
    steps/s)."""
    from opal_tpu_torch import cli, constants as const
    from opal_tpu_torch.ops import fused as F

    dt = 0.95 * 500.0 / const.SPEED_OF_LIGHT
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    src = src.replace("end: 0.1", f"end: {(steps + 0.5) * dt!r}")
    src = src.replace("n_outputs: 20", f"n_outputs: {outputs}")
    run = tmp / "two_stream"
    run.mkdir(parents=True)
    (run / "deck.yaml").write_text(src)
    so, se = io.StringIO(), io.StringIO()
    F.fused_push_deposit.launches.update(vay=0, boris=0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main([str(run / "deck.yaml")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(F.fused_push_deposit.launches)
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron]" in out, out
    assert "buffer-overflow particle losses" not in err, err
    assert launches["vay"] > 0 and launches["boris"] == 0, launches
    launches = launches["vay"]
    totals = []
    for i in range(outputs + 1):
        g = np.loadtxt(run / f"{i}_grid.dat")
        assert g.shape == (1000, 11) and np.isfinite(g).all()
        e = dict(l.split() for l in (run / f"{i}_energy.dat").read_text()
                 .splitlines())
        e = {k: float(v) for k, v in e.items()}
        assert all(math.isfinite(v) for v in e.values()) and e["electrons"] > 0
        totals.append(e["em_field"] + e["electrons"])
        assert (run / f"{i}_electron_x-px.fits").stat().st_size % 2880 == 0
    drift = abs(totals[-1] - totals[0]) / totals[0]
    assert drift < 1e-3, drift
    banner = out.splitlines()[0]
    log(4, f"python -m opal_tpu_torch two_stream.yaml (nx 1000, npc 100, "
           f"{steps} steps, {outputs} outputs): '{banner}', kernel launches "
           f"{launches}, no losses, total energy drift {drift:.3e}, "
           f"{steps / wall:.1f} steps/s over {wall:.2f} s incl. output dumps")
    return launches, steps / wall


def bench_scale(smi: str):
    """bench.py's default deck through Simulation: all-f32, deposition
    and migration on, 2 sort periods."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.sim import SimOptions, Simulation
    from opal_tpu_torch.species import SpeciesSpec

    b = BENCH
    nx = b["nx"]
    npc = b["particles"] // nx
    cap = int(npc * nx * b["capacity_factor"])
    cap = -(-cap // b["block"]) * b["block"]
    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
    opts = SimOptions(
        dt=dt, fused_pusher=True, fused_block=b["block"],
        fused_window=b["window"], fused_resort_every=b["resort"],
        migration_every=b["migrate"], fused_misfit_capacity=b["misfit"],
        max_drift_cells_per_step=b["drift_cells"],
        migration_capacity=-(-int(npc * b["migrate"] * 0.0095 * 1.5 + 384)
                             // 8) * 8,
        migration_window=max(4096, -(-int(npc * (0.0095 * b["resort"] + 3))
                                     // 8) * 8),
    )
    sim = Simulation(geom, opts, {"electron": SpeciesSpec.electron()},
                     device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    st = two_stream_state(geom, npc, cap, dt, "cuda")
    setup = time.perf_counter() - t0
    n_alive = int(st.alive.sum())
    assert sim._cadences({"electron": st}) == (b["migrate"], b["resort"])
    E, B, J, rho = sim.init_fields()
    counters = sim.zero_counters()
    species = {"electron": st}
    t = 0.0
    F.fused_push_deposit.launches.update(vay=0, boris=0)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E, B, J, rho, species, t, counters = sim.run(
            E, B, J, rho, species, t, counters, b["resort"]
        )
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps = 2 * b["resort"]
    assert F.fused_push_deposit.launches == {"vay": steps, "boris": 0}
    assert int(counters["electron"]) == 0, int(counters["electron"])
    ke = sim.total_kinetic_energy("electron", species["electron"])
    fe = sim.em_field_energy(E, B)
    assert math.isfinite(ke) and math.isfinite(fe) and ke > 0
    rate = n_alive * b["resort"] / walls[1]
    log(5, f"bench deck ({n_alive} electrons, cap {cap}, nx {nx}, f32, "
           f"block {b['block']}, window {b['window']}, R {b['resort']}, "
           f"M {b['migrate']}): {steps} steps, launches {steps}, no losses; "
           f"setup {setup:.1f} s; period 1 {walls[0]:.3f} s, period 2 "
           f"{walls[1]:.3f} s -> {rate:.4e} pushes/s (period 2) on {smi}")


#: a hole_boring deck cut to nx 800 and npc 10 (the deck of
#: tests/test_torch_hole_boring.py, with the port's own auto-sizing):
#: 200 steps, the pulse's peak reaching the slab near step 150.  Later
#: the driven slab turns chaotic: a one-ulp change of some electrons'
#: positions grows past 1e-5 of the current's scale by step 300, so a
#: longer run could not hold the card to 1e-5
HB_SMALL = """\
control:
 dx: micro / 100
 nx: 800
 xmin: -2*micro
 start: -2.0e-6/c
 end: -0.1e-6/c
 current_deposition: true
 n_outputs: 1
qed:
 photon_emission: false
 photon_absorption: false
electrons:
 npc: 10
 ne: density * critical(omega) * step(x,xmin,xmax)
 ux: sqrt(kT/(m*c^2)) * nrand
 uy: sqrt(kT/(m*c^2)) * nrand
 uz: sqrt(kT/(m*c^2)) * nrand
 output: [x:px]
ions:
 name: carbon
 npc: 10
 Z: Z
 A: A
 ni: density * critical(omega) * step(x,xmin,xmax) / Z
 ux: sqrt(kT/(A*mp*c^2)) * nrand
 uy: sqrt(kT/(A*mp*c^2)) * nrand
 uz: sqrt(kT/(A*mp*c^2)) * nrand
 output: [x:px]
laser:
 Ey: (a0*me*c*omega/e) * gauss_pulse_re(t,x,omega,sigma)
 Ez: (a0*me*c*omega/e) * gauss_pulse_im(t,x,omega,sigma)
constants:
 density: 4.0
 a0: 10.0
 omega: 2*pi*c/0.8e-6
 sigma: pi * 2.0 / sqrt(ln(2.0))
 kT: 500 * eV
 Z: 6.0
 A: 12.0
 xmin: -0.5 * micro
 xmax: 1.5 * micro
"""
#: examples/hole_boring.yaml as shipped, but for the time span, the
#: output count and the slab, moved together so that the pulse's peak
#: reaches the slab within the run (the injected envelope at t = -19
#: um/c is 1.7e-5 of its peak)
HB_CLI_EDITS = (
    ("start: -20.0e-6/c", "start: -19.0e-6/c"),
    ("end: 10.0e-6/c", "end: -7.0e-6/c"),
    (" xmin: 0.0 * micro", " xmin: -9.0 * micro"),
    (" xmax: 5.0 * micro", " xmax: -4.0 * micro"),
)


def hole_boring_kernels():
    """Phase 6: both kernel forms against their plain versions on the
    full hole_boring deck's initial states (sorted), under random
    fields of laser strength (E ~ 1e13 V/m, B ~ 3e4 T).  Returns
    {pusher: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    from opal_tpu_torch.cli import build

    sim, states, _ = build(ROOT / "examples" / "hole_boring.yaml",
                           device="cuda")
    out = {}
    for name, st in states.items():
        spec = sim._fused_spec(name)
        assert sim._fused_applicable(name, st)
        assert (spec.block, spec.window, spec.n_rows, st.x.shape[0]) == (
            2048, 56, 20_228, 753_664), spec
        out[spec.pusher] = kernel_vs_plain(
            f"hole_boring {name} shape", st, spec, fields_seed=2,
            e_scale=1e13, b_scale=3e4, phase=6,
        )
    del sim, states
    torch.cuda.empty_cache()
    return out


def hb_card_vs_cpu(tmp: Path):
    """Phase 7: the small hole_boring deck stepped on the card (both
    kernel forms) and on the CPU (their plain versions), f32 particles
    and f64 fields: the push columns round alike, the deposits add in
    another order, so fields and energies agree within 1e-5 of their
    scale."""
    from opal_tpu_torch.cli import build

    (tmp / "hb_small").mkdir()
    deck = tmp / "hb_small" / "deck.yaml"
    deck.write_text(HB_SMALL)
    out = {}
    for dev in ("cuda", "cpu"):
        sim, sp, rp = build(deck, device=dev)
        assert all(sim._fused_applicable(n, sp[n]) for n in sp)
        steps = rp["total_steps"]
        res = sim.run(*sim.init_fields(), sp, rp["tstart"],
                      sim.zero_counters(), steps)
        assert all(int(v) == 0 for v in res[6].values()), res[6]
        out[dev] = (res, sim.em_field_energy(res[0], res[1]), {
            n: sim.total_kinetic_energy(n, res[4][n]) for n in sp})
    (rc, fc, kc), (rp_, fp, kp) = out["cuda"], out["cpu"]
    worst = 0.0
    for i, name in enumerate(("E", "B", "J", "rho")):
        a, b = rc[i].cpu(), rp_[i]
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
        assert err < 1e-5, (name, err)
        worst = max(worst, err)
    assert fp > 0 and abs(fc - fp) <= 1e-5 * abs(fp), (fc, fp)
    for n in kp:
        assert abs(kc[n] - kp[n]) <= 1e-5 * abs(kp[n]), (n, kc[n], kp[n])
    log(7, f"small hole_boring deck (nx 800, npc 10 a species, {steps} "
           f"steps), card vs CPU: fields within {worst:.2e} of their "
           f"scale, field energy {fc:.6e} vs {fp:.6e} J, electrons "
           f"{kc['electron']:.6e} vs {kp['electron']:.6e} J, ions "
           f"{kc['ion']:.6e} vs {kp['ion']:.6e} J")


class _Echo(io.StringIO):
    """Keeps what is written to it and echoes it to the process's
    standard output."""

    def write(self, s):
        sys.__stdout__.write(s)
        sys.__stdout__.flush()
        return super().write(s)


def hb_cli_drive(tmp: Path, smi: str, outputs=3, profile=None):
    """Phase 8, this slice's main path: the full-width hole_boring deck
    through the user's entry point, over ``outputs`` output blocks (with
    ``profile``, the CLI's ``--profile`` of the last block into that
    directory).  Returns the launches of each kernel form."""
    from opal_tpu_torch import cli, constants as const
    from opal_tpu_torch.config import Config
    from opal_tpu_torch.ops import fused as F

    src = (ROOT / "examples" / "hole_boring.yaml").read_text()
    for a, b in HB_CLI_EDITS + (("n_outputs: 30", f"n_outputs: {outputs}"),):
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    run = tmp / "hole_boring"
    run.mkdir()
    (run / "deck.yaml").write_text(src)
    cfg = Config.from_string(src)
    cfg.with_context("constants")
    dt = 0.95 * cfg.read_f64("control", "dx") / const.SPEED_OF_LIGHT
    total = int((cfg.read_f64("control", "end")
                 - cfg.read_f64("control", "start")) / dt)
    steps = outputs * (total // outputs)
    argv = [str(run / "deck.yaml")]
    if profile is not None:
        argv += ["--profile", str(profile)]

    # a profiled drive echoes the CLI's progress lines as they come
    so, se = (_Echo(), _Echo()) if profile else (io.StringIO(), io.StringIO())
    F.fused_push_deposit.launches.update(vay=0, boris=0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(F.fused_push_deposit.launches)
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron, ion]" in out, out
    if profile is not None:
        log(8, [l for l in err.splitlines() if l.startswith("profile:")][0])
    assert "buffer-overflow particle losses" not in err, err
    assert launches == {"vay": steps, "boris": steps}, (launches, steps)
    ions = []
    for i in range(outputs + 1):
        g = np.loadtxt(run / f"{i}_grid.dat")
        assert g.shape == (20_000, 11) and np.isfinite(g).all()
        e = {k: float(v) for k, v in (l.split() for l in
             (run / f"{i}_energy.dat").read_text().splitlines())}
        assert all(math.isfinite(v) for v in e.values()), e
        assert e["electrons"] > 0 and e["ions"] > 0, e
        ions.append(e["ions"])
        for stem in ("electron_x-px", "electron_x-p_perp", "electron_py-pz",
                     "carbon_x-px", "carbon_x-p_perp", "carbon_py-pz"):
            assert (run / f"{i}_{stem}.fits").stat().st_size % 2880 == 0
    assert ions[-1] > ions[0], ions
    banner = out.splitlines()[0]
    log(8, f"python -m opal_tpu_torch hole_boring.yaml (nx 20000, npc 100 "
           f"a species, slab -9..-4 um, {steps} steps, {outputs} outputs): "
           f"'{banner}' '{out.splitlines()[1]}', launches vay "
           f"{launches['vay']} boris {launches['boris']}, no losses, "
           f"outputs finite, ion kinetic energy x{ions[-1] / ions[0]:.4g} "
           f"({ions[0]:.6e} -> {ions[-1]:.6e} J); {steps / wall:.1f} "
           f"steps/s over {wall:.1f} s incl. set-up and output dumps, on "
           f"{smi}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", metavar="DIR", type=Path, default=None,
        help="instead of phases 3-8, run phase 8 over 120 output blocks "
             "with the CLI's --profile of the last block into DIR")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from opal_tpu_torch import _build
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.grid import HALO, GridGeometry
    from opal_tpu_torch.ops import fused as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(1, f"device {name}, torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}, nvidia-smi: {smi}")

    lib, seconds = _build.build()
    report = [l.strip() for l in lib.with_suffix(".log").read_text()
              .splitlines() if "registers" in l or "spill" in l]
    _build.library()
    log(2, f"built {lib.name} in {seconds:.1f} s: {' | '.join(report)}")
    if args.profile is not None:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            hb_cli_drive(tmp, smi, outputs=120, profile=args.profile)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0

    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    shapes = [
        ("bench shape", BENCH["nx"], BENCH["particles"] // BENCH["nx"],
         10_485_760, BENCH["block"], BENCH["window"]),
        ("two_stream CLI shape", 1000, 100, 155_648, 2048, 40),
    ]
    results = {}
    for label, nx, npc, cap, block, window in shapes:
        geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
        st = two_stream_state(geom, npc, cap, dt, "cuda")
        spec = F.FusedSpec(
            block=block, window=window, n_rows=nx + 2 * HALO + 2 * F.PAD,
            dx=dx, dt=dt, charge=const.ELECTRON_CHARGE,
            mass=const.ELECTRON_MASS, row_off=HALO + F.PAD,
        )
        results[label] = kernel_vs_plain(label, st, spec)
        del st
        torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        card_vs_cpu(tmp)
        ts_launches, _ = cli_drive(tmp)
        bench_scale(smi)
        hb = hole_boring_kernels()
        hb_card_vs_cpu(tmp)
        hb_launches = hb_cli_drive(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # each form at the shape of this slice's main path (hole_boring);
    # the Vay error covers the earlier shapes too
    err_vay = max(results[k][0] for k in results)
    kernels = []
    for pusher, label in (("vay", "lite Vay, electrons"),
                          ("boris", "lite Boris, ions")):
        err, ms, plain_ms, bound_ms, bound_by = hb[pusher]
        kernels.append(dict(
            name=f"fused_push_deposit[{pusher}] ({label})", **KERNEL,
            launches=hb_launches[pusher],
            launches_by_path={"two_stream": ts_launches if pusher == "vay"
                              else 0, "hole_boring": hb_launches[pusher]},
            max_abs_err=max(err, err_vay) if pusher == "vay" else err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
        ))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
