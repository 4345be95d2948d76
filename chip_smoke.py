"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``opal_tpu_torch/csrc`` and drives
the port on the card, phase by phase, each printing one line:

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
   defaults through ``Simulation`` for two sort periods (640 steps).

Any failed check raises, so the script exits non-zero without the final
line.  Before the last line it prints one JSON object describing each
kernel of the path, and ``nvidia-smi``'s name and power limit; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
    name="fused_push_deposit",
    route="cuda",
    source="opal_tpu_torch/csrc/fused_push_deposit.cu",
    replaces="opal_tpu/ops/fused.py:727",
)
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


def kernel_vs_plain(label, st, spec, fields_seed=1):
    """Compare the kernel with its plain version on one sorted state and
    random E/B (E ~ 10 V/m, B ~ 1e-8 T); returns (max_abs_err, ms,
    plain_ms)."""
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    dev = st.x.device
    n_loc = spec.n_rows - 2 * F.PAD - 8
    st = sort_state(st, n_loc)
    g = torch.Generator(device="cpu").manual_seed(fields_seed)
    E = (10.0 * torch.randn(n_loc + 8, 3, generator=g)).to(dev)
    B = (1e-8 * torch.randn(n_loc + 8, 3, generator=g)).to(dev)
    eb = F.make_eb_rows(E, B)
    anchors = F.block_anchors(spec, st.cell)
    args = (spec, anchors, st.cell, st.x, st.y, st.z, st.ux, st.uy, st.uz,
            st.gamma, st.weight, st.work, eb)
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
    log(3, f"{label}: rows {st.cell.shape[0]} (alive {n_alive}), block "
           f"{spec.block}, window {spec.window}, n_rows {spec.n_rows}: push "
           f"columns, miss and anchors bitwise equal; slab max |err| "
           f"{slab_err:.3e} (max |slab| {scale:.3e}); misses "
           f"{int(mk.sum().item())}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
           f"ms (median of 20)")
    return max(push_err, slab_err), ms, plain_ms


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
    F.fused_push_deposit.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main([str(run / "deck.yaml")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = F.fused_push_deposit.launches
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron]" in out, out
    assert "buffer-overflow particle losses" not in err, err
    assert launches > 0
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
    F.fused_push_deposit.launches = 0
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
    assert F.fused_push_deposit.launches == steps
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


def main() -> int:
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
        launches, steps_per_s = cli_drive(tmp)
        bench_scale(smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    err, ms, plain_ms = results["two_stream CLI shape"]
    err_b = results["bench shape"][0]
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max(err, err_b), ms=ms,
        plain_ms=plain_ms,
    )]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
