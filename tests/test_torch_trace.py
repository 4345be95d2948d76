"""The program's spans and counters (``opal_tpu_torch.trace``) on the CPU.

With no profiler recording, a span is a shared no-op and nothing is
counted.  Under a CPU profiler, on a small periodic fused deck whose
window is tight enough that rows miss it: every step holds each phase
once (the push twice: the deck's mixed precision adds the work
increment after the fallback), the sorts and exchanges follow the
deck's cadences, no step reads the device, the misfit counters, added
up on the device, equal the rows of the fallback's tables, and the
final state equals the unprofiled run's bit for bit.
"""

import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from opal_tpu_torch import constants as const
from opal_tpu_torch import trace
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.ops import fused as F
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize

pytestmark = pytest.mark.unit

NX, NPC, CAP, STEPS = 64, 16, 1536, 24
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
#: sorts every 8 steps, exchanges every 4: 3 sorts and 6 exchanges
OPTS = dict(dt=DT, fused_pusher=True, fused_block=128, fused_window=12,
            fused_resort_every=8, migration_every=4,
            max_drift_cells_per_step=0.45, migration_window=256,
            migration_capacity=64, fused_misfit_capacity=256)
#: the phases of a step: the push's second span adds the work increment
#: (f32 particles, f64 fields) over every row after the fallback
STEP_PHASES = (trace.HALO, trace.PUSH, trace.MISFIT, trace.PUSH,
               trace.DEPOSIT, trace.FIELDS)


def _deck(**over):
    geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    sim = Simulation(geom, SimOptions(**{**OPTS, **over}),
                     {"electron": SpeciesSpec.electron()}, device="cpu",
                     dtype=torch.float32, field_dtype=torch.float64)
    st = initialize(
        SpeciesSpec.electron(), geom, NPC,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.25 * np.sign(u - 0.5) * (1.0 + 0.2 * nr),
        uy=lambda x, u, nr: 0.05 * nr, uz=lambda x, u, nr: np.zeros_like(x),
        dt=DT, capacity_per_device=CAP, seed=3, dtype=np.float32,
        work_dtype=np.float64, device="cpu")
    return sim, st


def _run(sim, st, steps=STEPS):
    E, B, J, rho = sim.init_fields()
    B[:, 2] = 1e-7  # a gyrating orbit: rows leave their windows
    return sim.run(E, B, J, rho, {"electron": st}, 0.0, sim.zero_counters(),
                   steps)


@pytest.fixture(autouse=True)
def _clean_record():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _spans(prof):
    """The program's spans on the host: (name, start_us, end_us)."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name in trace.SPANS]


def test_spans_are_inert_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with trace.span(trace.STEP), trace.span(trace.HALO, torch.device("cpu")):
        trace.count(trace.MISFIT_ROWS, 5)
        assert trace.host_read(torch.tensor(7)) == 7
    assert trace.span(trace.PUSH) is trace.span(trace.SORT)
    assert trace.device_counts((trace.MISFIT_ROWS,), "cpu") is None
    sim, st = _deck()
    _run(sim, st, steps=4)
    snap = trace.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"] == dict.fromkeys(trace.COUNTERS, 0)


def test_host_read_returns_python_numbers():
    assert trace.host_read(torch.tensor(3, dtype=torch.int64)) == 3
    assert trace.host_read(torch.tensor([1, 2])) == [1, 2]
    (got, pair), _ = _profiled(lambda: (
        trace.host_read(torch.tensor(2.5)),
        trace.host_read(torch.tensor([4, 5]))))
    assert (got, pair) == (2.5, [4, 5])
    snap = trace.snapshot()
    assert snap["counters"][trace.HOST_READS] == 2
    assert snap["spans"][trace.HOST_READ] == {"calls": 2}


def test_phase_spans_time_the_host_clock_on_the_cpu():
    def work():
        for _ in range(3):
            with trace.span(trace.SORT, torch.device("cpu")):
                torch.ones(1000).cumsum(0)
        with trace.span(trace.STEP):
            pass

    _profiled(work)
    snap = trace.snapshot()
    assert snap["spans"][trace.SORT]["calls"] == 3
    assert snap["spans"][trace.SORT]["device_ms"] > 0.0
    # not a phase: calls alone
    assert snap["spans"][trace.STEP] == {"calls": 1}


def test_a_new_profiler_session_starts_a_new_record():
    def one():
        with trace.span(trace.STEP):
            trace.count(trace.MISFIT_ROWS, 3)

    _profiled(one)
    assert trace.snapshot()["counters"][trace.MISFIT_ROWS] == 3
    # no span between the sessions: the snapshot closed the record
    _profiled(one)
    assert trace.snapshot()["counters"][trace.MISFIT_ROWS] == 3
    _profiled(one)
    one()  # a span with no profiler between the sessions closes it too
    _profiled(one)
    snap = trace.snapshot()
    assert snap["counters"][trace.MISFIT_ROWS] == 3
    assert snap["spans"][trace.STEP]["calls"] == 1
    trace.reset()
    assert trace.snapshot()["spans"] == {}


def test_each_step_holds_its_phases_and_the_cadences_hold():
    sim, st = _deck()
    _, prof = _profiled(lambda: _run(sim, st))
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == trace.STEP]
    assert len(steps) == STEPS
    for _, a, b in steps:
        inside = [n for n, s, e in spans if a <= s and e <= b and
                  n in trace.PHASES]
        assert sorted(inside) == sorted(STEP_PHASES), inside
    names = [n for n, _, _ in spans]
    assert names.count(trace.SORT) == 3
    assert names.count(trace.EXCHANGE) == 6
    # sorts and exchanges run between the steps, phases never nest
    for n, a, b in spans:
        if n in (trace.SORT, trace.EXCHANGE):
            assert not any(s <= a and b <= e for _, s, e in steps)
    snap = trace.snapshot()
    for name in (*STEP_PHASES, trace.SORT, trace.EXCHANGE):
        assert snap["spans"][name]["device_ms"] > 0.0, name
    assert snap["spans"][trace.STEP]["calls"] == STEPS


def test_device_counts_are_read_at_the_snapshot():
    """A tally lives through the profiled stretch, every call handing
    back the same tensor; the snapshot adds it to the counters once (a
    second snapshot reads the same), and a new session starts anew."""
    def one():
        t = trace.device_counts((trace.MISFIT_ROWS, trace.MISFIT_STEPS),
                                "cpu")
        t += torch.tensor([5, 1])
        assert trace.device_counts((trace.MISFIT_ROWS, trace.MISFIT_STEPS),
                                   torch.device("cpu")) is t
        t += torch.tensor([2, 1])
        trace.count(trace.MISFIT_ROWS, 10)

    _profiled(one)
    for _ in range(2):
        counters = trace.snapshot()["counters"]
        assert counters[trace.MISFIT_ROWS] == 17
        assert counters[trace.MISFIT_STEPS] == 2
    _profiled(one)
    assert trace.snapshot()["counters"][trace.MISFIT_ROWS] == 17


def test_host_reads_and_misfit_rows_are_counted(monkeypatch):
    """No step reads the device; the misfit counters are the rows of
    each fallback table (its entries below the state's row count) and
    the tables that hold any."""
    sim, st = _deck()
    tables = []
    real = F.misfit_compact

    def spy(miss, capacity, counts=None):
        mtab, losses = real(miss, capacity, counts)
        tables.append(int((mtab < miss.numel()).sum()))
        return mtab, losses

    monkeypatch.setattr(F, "misfit_compact", spy)
    out, _ = _profiled(lambda: _run(sim, st))
    assert int(out[6]["electron"]) == 0
    snap = trace.snapshot()
    assert snap["counters"][trace.HOST_READS] == 0
    assert trace.HOST_READ not in snap["spans"]
    assert len(tables) == STEPS
    assert sum(tables) > 0, "the deck's window should make misfits"
    assert snap["counters"][trace.MISFIT_ROWS] == sum(tables)
    assert snap["counters"][trace.MISFIT_STEPS] == sum(n > 0 for n in tables)
    # the deck's flags fit one tile, read again when it holds a row
    assert CAP <= F.COMPACT_TILE
    assert snap["counters"][trace.MISFIT_TILES] == sum(n > 0 for n in tables)


@pytest.mark.parametrize("packed", [False, True])
def test_the_profiler_changes_no_result(packed):
    sim, st = _deck(packed_fused=packed)
    plain = _run(sim, st)
    traced, _ = _profiled(lambda: _run(sim, st))
    for i in range(4):
        assert torch.equal(plain[i], traced[i]), i
    assert plain[5] == traced[5]
    for k, v in plain[4]["electron"].columns().items():
        assert torch.equal(v, traced[4]["electron"].columns()[k]), k
    snap = trace.snapshot()
    assert snap["counters"][trace.HOST_READS] == 0
    # the column layout adds the work increment in a second push span;
    # the packed one accumulates the work in its hot matrix
    assert snap["spans"][trace.PUSH]["calls"] == STEPS * (1 if packed else 2)


def test_ring_collectives_have_spans_with_a_group(tmp_path):
    """A world of 1 under a ``gloo`` group issues its reductions and
    gathers (its shift is a local copy); a ring without a group issues
    none and records no collective span.  Each collective is timed (by
    the host clock on the CPU) and counted with its payload's bytes; the
    barrier is a span alone; nothing is recorded with no profiler."""
    from opal_tpu_torch.parallel import dist

    x = torch.arange(4.0)
    _profiled(lambda: (dist.SOLO.psum(x), dist.SOLO.all_gather(x),
                       dist.SOLO.shift(x, x)))
    assert trace.snapshot()["spans"] == {}
    ring = dist.init(0, 1, f"file://{tmp_path}/rendezvous", "cpu")
    try:
        ring.psum(x), ring.all_gather(x), ring.barrier()
        unrecorded = trace.snapshot()
        (total, every, first, _, _), _ = _profiled(lambda: (
            ring.psum(x), ring.all_gather(x), ring.gather(x),
            ring.shift(x, x), ring.barrier()))
    finally:
        dist.close(ring)
    assert unrecorded["spans"] == {}
    assert unrecorded["counters"] == dict.fromkeys(trace.COUNTERS, 0)
    assert torch.equal(total, x) and torch.equal(every, x[None])
    assert torch.equal(first, x[None])
    snap = trace.snapshot()
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    assert calls == {trace.PSUM: 1, trace.ALL_GATHER: 1, trace.GATHER: 1,
                     trace.BARRIER: 1}
    for name in (trace.PSUM, trace.ALL_GATHER, trace.GATHER):
        assert snap["spans"][name]["device_ms"] > 0.0, name
    assert "device_ms" not in snap["spans"][trace.BARRIER]
    assert snap["counters"][trace.COLLECTIVE_CALLS] == 3
    assert snap["counters"][trace.COLLECTIVE_BYTES] == 3 * 4 * 4


def test_collectives_stay_out_of_the_phase_sums(tmp_path):
    """A collective inside a phase is timed on its own, and the phase's
    extent holds it: the phases are the same spans, with the same calls,
    whether the step runs under a group or not, and the deck's step
    issues one collective a ``run`` call at a world of 1 (the losses'
    sum)."""
    from opal_tpu_torch.parallel import dist

    cpu = torch.device("cpu")
    x = torch.arange(4.0)
    sim, st = _deck()
    _profiled(lambda: _run(sim, st, steps=4))
    solo = trace.snapshot()
    ring = dist.init(0, 1, f"file://{tmp_path}/rendezvous", "cpu")
    try:
        geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
        grouped = Simulation(geom, SimOptions(**OPTS),
                             {"electron": SpeciesSpec.electron()},
                             device="cpu", dtype=torch.float32,
                             field_dtype=torch.float64, ring=ring)
        _profiled(lambda: _run(grouped, st, steps=4))
        snap = trace.snapshot()

        def nested():
            with trace.span(trace.HALO, cpu):
                ring.psum(x)
                time.sleep(0.002)

        _profiled(nested)
        inner = trace.snapshot()
    finally:
        dist.close(ring)
    phases = lambda s: {n: v["calls"] for n, v in s["spans"].items()
                        if n in trace.PHASES}
    assert phases(snap) == phases(solo)
    assert set(snap["spans"]) - set(solo["spans"]) == {trace.PSUM}
    assert not set(trace.COLLECTIVES) & set(trace.PHASES)
    assert snap["counters"][trace.COLLECTIVE_CALLS] == 1
    assert solo["counters"][trace.COLLECTIVE_CALLS] == 0
    halo = inner["spans"][trace.HALO]["device_ms"]
    psum = inner["spans"][trace.PSUM]["device_ms"]
    assert 0.0 < psum < halo and halo >= 2.0
