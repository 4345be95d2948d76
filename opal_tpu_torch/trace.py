"""The program's spans and counters: where a step's time goes.

Every span name of the program is written here and only here.  The
step opens :func:`span` around each of its phases and stages, and turns
device values into Python numbers only through :func:`host_read`.

All of it is gated on one attribute read: while no ``torch.profiler``
session records, :func:`span` returns a shared no-op context, and
:func:`count` and :func:`host_read` record nothing.  While one records:

- a span enters ``torch.profiler.record_function(name)``, so that its
  host interval lies on the profiler's clock beside the device trace;
- a *phase* span (:data:`PHASES`) also times its extent on the device:
  a CUDA event recorded on the device's current stream where it opens
  and one where it closes, so that its time is its kernels plus the
  idle gaps between them; on a CPU device, which runs each operation as
  it is issued, the host clock;
- a *collective* span (:data:`COLLECTIVES`, opened by
  :func:`collective`) times its extent the same way, around the
  collective and its wait: the compute stream's stall for the other
  ranks.  It is counted in :data:`COLLECTIVE_CALLS`, and its payload,
  from the tensors' shapes, in :data:`COLLECTIVE_BYTES`;
- counters add up what the host already holds (no read of their own),
  or, with :func:`device_counts`, what only the device knows, added up
  there and read once, by :func:`snapshot`.

Phases never nest inside each other, so their times add up.  The
collectives lie inside the phases (the halo, the deposit's fold, the
exchange) or between them: they are no phase, and their device
milliseconds are reported beside the phases', never in their sum.
Nothing is written anywhere: :func:`snapshot` returns what the last
profiled stretch recorded, resolving the CUDA events (call it after the
device has been synchronised), and :func:`reset` clears it.  The record
clears itself when a new profiler session starts.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

#: one step of ``Simulation.run`` (``_device_step``); the parent of the
#: phases inside it
STEP = "opal.step"
#: the halo refresh of the field slabs
HALO = "opal.halo"
#: a species' push: the fused kernel with its field table and work and
#: optical-depth updates, or the unfused push
PUSH = "opal.push"
#: the misfit fallback: the compaction, the push of the misfit rows and
#: their deposit
MISFIT = "opal.misfit"
#: photon absorption and stimulated emission (``interactions.absorb``)
ABSORB = "opal.absorb"
#: photon emission (``interactions.emit_radiation``)
EMIT = "opal.emit"
#: the kernel's slabs folded out to J and rho, the unfused deposit and
#: the halo fold of the currents
DEPOSIT = "opal.deposit"
#: the boundaries and the Yee advance
FIELDS = "opal.fields"
#: the maintenance sort and the block anchors
SORT = "opal.sort"
#: the edge exchange (migration) of the species
EXCHANGE = "opal.exchange"

#: the spans that time their extent on the device
PHASES = (HALO, PUSH, MISFIT, ABSORB, EMIT, DEPOSIT, FIELDS, SORT, EXCHANGE)

#: a device value turned into a Python number (:func:`host_read`)
HOST_READ = "opal.host_read"
#: stages inside the phases
TAU_DECREMENT = "opal.push.tau_decrement"
EMIT_SAMPLE = "opal.emit.sample"
ABSORB_SEGMENTS = "opal.absorb.segments"
ABSORB_WORKING_SET = "opal.absorb.working_set"
ABSORB_TABLE = "opal.absorb.table"
ABSORB_DRAWS = "opal.absorb.draws"
ABSORB_WALK = "opal.absorb.walk"
#: the collectives of ``parallel.dist.Ring`` (with a process group)
SHIFT = "opal.collective.shift"
PSUM = "opal.collective.psum"
ALL_GATHER = "opal.collective.all_gather"
GATHER = "opal.collective.gather"
#: the collectives timed on the device and counted (:func:`collective`)
COLLECTIVES = (SHIFT, PSUM, ALL_GATHER, GATHER)
#: a wait for every rank (``Ring.barrier``): a span alone, neither timed
#: nor counted, since it stands between the steps
BARRIER = "opal.collective.barrier"

#: every span of the program
SPANS = (STEP, *PHASES, HOST_READ, TAU_DECREMENT, EMIT_SAMPLE,
         ABSORB_SEGMENTS, ABSORB_WORKING_SET, ABSORB_TABLE, ABSORB_DRAWS,
         ABSORB_WALK, SHIFT, PSUM, ALL_GATHER, GATHER, BARRIER)

#: counters: host reads; misfit rows pushed by the fallback; steps (of a
#: species) in which the fallback had rows; tiles of flags the misfit
#: compaction read a second time (the last three counted on the device);
#: collectives issued and the bytes of their payloads
HOST_READS = "host_reads"
MISFIT_ROWS = "misfit_rows"
MISFIT_STEPS = "misfit_steps"
MISFIT_TILES = "misfit_tiles"
COLLECTIVE_CALLS = "collectives"
COLLECTIVE_BYTES = "collective_bytes"
COUNTERS = (HOST_READS, MISFIT_ROWS, MISFIT_STEPS, MISFIT_TILES,
            COLLECTIVE_CALLS, COLLECTIVE_BYTES)

#: the spans timed on the device
_TIMED_SET = frozenset(PHASES + COLLECTIVES)


class _Record:
    """What the current profiled stretch recorded: the calls of each
    span, the (start, end) marks of each phase (CUDA event pairs, or
    host seconds), the counters, and the device's tallies of counters
    (:func:`device_counts`) not yet read."""

    def __init__(self):
        self.live = False
        self.calls: dict = {}
        self.marks: dict = {}
        self.counters: dict = {}
        self.tallies: dict = {}

    def clear(self):
        self.calls, self.marks, self.counters = {}, {}, {}
        self.tallies = {}

    def arm(self):
        """Start a new record at the first event of a profiler session."""
        if not self.live:
            self.clear()
            self.live = True


_RECORD = _Record()


#: the context of a span while nothing records
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "_range", "_start")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        rec = _RECORD
        rec.arm()
        rec.calls[self.name] = rec.calls.get(self.name, 0) + 1
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.name in _TIMED_SET:
            self._start = _mark(self.device)
        return self

    def __exit__(self, *exc):
        if self.name in _TIMED_SET:
            _RECORD.marks.setdefault(self.name, []).append(
                (self._start, _mark(self.device)))
        self._range.__exit__(*exc)
        return False


def _mark(device):
    """A point on the device's timeline: a CUDA event recorded on its
    current stream, or the host clock for any other device."""
    if device is not None and device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def span(name: str, device=None):
    """A context around ``name``: nothing while no profiler records; a
    ``record_function`` range while one does, timed on ``device`` if
    ``name`` is a phase."""
    if not _profiler._is_profiler_enabled:
        if _RECORD.live:
            _RECORD.live = False
        return _NULL
    return _Span(name, device)


def collective(name: str, device, *tensors):
    """The span of the collective ``name`` of :data:`COLLECTIVES` over
    ``tensors`` (what this rank sends), timed on ``device`` as a phase is:
    nothing while no profiler records; while one does, also counted once
    in :data:`COLLECTIVE_CALLS` and by the tensors' bytes in
    :data:`COLLECTIVE_BYTES` (their shapes, no read)."""
    s = span(name, device)
    if s is not _NULL:
        count(COLLECTIVE_CALLS, 1)
        count(COLLECTIVE_BYTES, sum(t.numel() * t.element_size()
                                    for t in tensors))
    return s


def count(name: str, n: int):
    """Add ``n``, a number the host holds, to the counter ``name`` while
    a profiler records."""
    if _profiler._is_profiler_enabled:
        _RECORD.arm()
        _RECORD.counters[name] = _RECORD.counters.get(name, 0) + n


def device_counts(names: tuple, device):
    """While a profiler records: an int64 tensor on ``device``, an entry
    for each counter of ``names``, for the step to add to on the device
    (no read, no launch of its own); :func:`snapshot` reads it once and
    adds it to the counters.  ``None`` while nothing records."""
    if not _profiler._is_profiler_enabled:
        return None
    rec = _RECORD
    rec.arm()
    key = (names, torch.device(device))
    if key not in rec.tallies:
        rec.tallies[key] = torch.zeros(len(names), dtype=torch.int64,
                                       device=device)
    return rec.tallies[key]


def host_read(t: torch.Tensor):
    """``t`` as Python numbers (``t.tolist()``: a number for a 0-d
    tensor), the one way the step reads the device; it waits for the
    device's queue.  Counted in :data:`HOST_READS` under its own span
    while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return t.tolist()
    with span(HOST_READ):
        count(HOST_READS, 1)
        return t.tolist()


def snapshot() -> dict:
    """The last profiled stretch: ``{"counters": {name: n}, "spans":
    {name: {"calls": n, "device_ms": ms}}}``, every counter of
    :data:`COUNTERS` present (those the device added up read here, once),
    ``device_ms`` on the phases and the collectives alone (summed over
    their calls).  The device must have been synchronised."""
    rec = _RECORD
    for (names, _), t in rec.tallies.items():
        for name, n in zip(names, t.tolist()):
            rec.counters[name] = rec.counters.get(name, 0) + n
    rec.tallies = {}
    spans = {}
    for name, calls in rec.calls.items():
        spans[name] = {"calls": calls}
        if name in _TIMED_SET:
            spans[name]["device_ms"] = sum(
                _elapsed_ms(a, b) for a, b in rec.marks.get(name, ()))
    # the next session starts a new record
    rec.live = False
    return {"counters": {k: rec.counters.get(k, 0) for k in
                         (*COUNTERS, *rec.counters)},
            "spans": spans}


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


def reset():
    """Clear the record."""
    _RECORD.clear()
    _RECORD.live = False
