"""The plain reference against the program's CPU path, its control, and
the check's verdict on a timed path broken underneath (on the CPU at a
tiny size; the harness's look for a card is skipped)."""

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pic_bench import harness  # noqa: E402
from pic_bench.drivers import periodic  # noqa: E402
from pic_bench.reference import compare, pic1d  # noqa: E402

CELLS = ("two_stream_128m.column", "two_stream_128m.decomposed")


def tiny_run(workload: str, steps: int = 128, seed: int = 2**31 + 7):
    """The cell at a CPU test's size: 64 cells a rank, 64 electrons a
    cell, the cadences cut in step; the cell's own limits."""
    run = harness.load_run(["--workload", workload, "--seed", str(seed),
                            "--seconds", "0"], time.time())
    run.config.update(nx=64 * run.cell["chips"], npc=64, draw_chunk_cells=32)
    run.cell["knobs"].update(
        fused_block=512, fused_window=16, fused_resort_every=32,
        migration_every=16, migration_capacity=400, migration_window=4096,
        fused_misfit_capacity=256)
    run.cell.update(segment_steps=steps)
    return run


def result_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def run_solo(run, capsys) -> dict:
    from opal_tpu_torch.parallel.dist import Ring

    assert periodic.measure(run, Ring(device=torch.device("cpu"))) == 0
    return result_line(capsys.readouterr().out)


def test_reference_ops_match_the_programs_plain_ops():
    from opal_tpu_torch.ops import interp, pusher

    g = torch.Generator().manual_seed(3)
    x = torch.rand(4096, generator=g)
    xf = x + 0.02 * torch.randn(4096, generator=g)
    for b in (-1.5, -0.5, 0.5, 1.5):
        assert torch.equal(pic1d.flux(b - x, b - xf), interp.flux(b - x, b - xf))
    E = torch.randn(32, 3, generator=g) * 1e3
    B = torch.randn(32, 3, generator=g) * 1e-6
    cell = torch.randint(0, 32, (4096,), generator=g)
    Ep, Bp = pic1d.gather(E, B, cell, x)
    # the program's slab: HALO periodic ghosts a side
    slab = lambda F: torch.cat([F[-4:], F, F[:4]])
    Eq, Bq = interp.fields_at(slab(E), slab(B), cell + 4, x)
    assert torch.equal(Ep, Eq) and torch.equal(Bp, Bq)
    u = torch.randn(4096, 3, generator=g)
    gamma = torch.sqrt(1 + (u * u).sum(1))
    un, gn = pic1d.vay(u, gamma, Ep, Bp, 1e-15)
    res = pusher.vay_push(cell, x, x, x, u, gamma, None, torch.zeros_like(x),
                          Ep, Bp, 1e-6, 1e-15)
    assert torch.equal(un, res.u) and torch.equal(gn, res.gamma)


def test_longitudinal_path_matches_the_general_path():
    """The reference's continuity-form path (no transverse state) against
    its general flux-form path, forced by a negligible Ey."""
    run = tiny_run(CELLS[0])
    cfg = run.config
    blk = periodic.draw_cells(cfg, 9, 0, cfg["nx"], "cpu")
    n = blk["x"].numel()
    zero = torch.zeros(n)
    u = torch.stack([blk["ux"], zero, zero], dim=1)
    w = torch.full((n,), periodic.weight(cfg))
    dt = cfg["cfl"] * cfg["dx"] / pic1d.C
    alive = torch.ones(n, dtype=torch.bool)
    out = {}
    for ey in (0.0, 1e-30):
        E = torch.zeros(cfg["nx"], 3)
        E[:, 1] = ey
        c, _, uu, E, B = pic1d.run_electrons(blk["cell"], blk["x"], u, w, E,
                                             torch.zeros_like(E), cfg["dx"],
                                             dt, 256)
        out[ey] = compare.summarize(c, uu[:, 0], alive, E, B, cfg["nx"])
    checks = compare.compare(out[0.0], out[1e-30], cfg["drift_u"])
    assert checks["field_gap"] < 1e-5 and checks["count_gap"] == 0, checks


@pytest.mark.parametrize("workload", CELLS[:1])
def test_program_matches_the_reference_on_the_cpu(workload, capsys):
    line = run_solo(tiny_run(workload), capsys)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] == 128 * 64 * 64
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_bfloat16_is_not_correct(workload, capsys):
    """The reference in the precision below the deck's, judged by the
    harness's own verdict, is not correct under the cell's limits (the
    chip readings at the cell's size are in PERF.md)."""
    from pic_bench import control

    assert control.check(tiny_run(workload, steps=256), 11, "cpu") == 0
    line = result_line(capsys.readouterr().out)
    assert line["correct"] is False and line["dtype"] == "bfloat16"
    assert set(line["checks"]) == set(tiny_run(workload).cell["limits"])


# -- the timed path broken underneath --------------------------------------

def _unchanged(run_fn):
    def run(self, E, B, J, rho, species, t0, counters, nsteps, **kw):
        return E, B, J, rho, species, t0 + nsteps * self.options.dt, counters
    return run


def _half_left_out(run_fn):
    def run(self, *args, **kw):
        out = list(run_fn(self, *args, **kw))
        st = out[4]["electron"]
        keep = torch.arange(st.alive.numel()) % 2 == 0
        out[4] = {**out[4], "electron": dataclasses.replace(
            st, alive=st.alive & keep)}
        return tuple(out)
    return run


def _field_altered(run_fn):
    def run(self, *args, **kw):
        out = list(run_fn(self, *args, **kw))
        E = out[0].clone()
        E[3, 0] += 10 * E.abs().max()
        out[0] = E
        return tuple(out)
    return run


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "field_altered": _field_altered}


def _patch(fault: str):
    from opal_tpu_torch.sim import Simulation

    Simulation.run = FAULTS[fault](Simulation.run)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, capsys, monkeypatch):
    from opal_tpu_torch.sim import Simulation

    monkeypatch.setattr(Simulation, "run", Simulation.run)
    _patch(fault)
    line = run_solo(tiny_run(CELLS[0]), capsys)
    assert not line["correct"], line["checks"]


def _rank(rank, world, init_method, run, fault):
    from opal_tpu_torch.parallel import dist, halo

    if fault == "halo_left_out":
        # every rank wraps its own slab instead of taking its
        # neighbours' edge cells
        exchange = halo.exchange_fields
        halo.exchange_fields = lambda E, B, geom, ring: exchange(
            E, B, geom, dist.SOLO)
    ring = dist.init(rank, world, init_method, "cpu")
    try:
        rc = periodic.measure(run, ring)
        ring.barrier()
    finally:
        dist.close(ring)
    sys.exit(rc)


@pytest.mark.parametrize("fault", [None, "halo_left_out"])
def test_decomposed_ranks_against_the_undecomposed_reference(fault, capfd):
    from opal_tpu_torch.parallel import dist

    # long enough for the fields to move the electrons at the slabs'
    # edges: the halo fault then reads ~1e-4 in ux_gap
    run = tiny_run(CELLS[1], steps=512)
    run.cell["chips"] = 2
    run.config["nx"] = 128
    codes = dist.launch(_rank, 2, (run, fault), timeout=600)
    assert codes == [0, 0]
    line = result_line(capfd.readouterr().out)
    assert line["correct"] == (fault is None), line["checks"]
