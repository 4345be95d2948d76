"""The readers of the ring's collectives (``collective_wait_ms``,
``collectives_per_step``) on a record made through
``opal_tpu_torch.trace``'s API under a CPU profiler, and on none."""

import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from opal_tpu_torch import trace as program  # noqa: E402
from pic_bench.metrics import (  # noqa: E402
    collective_wait_ms, collectives_per_step, field_ms,
)
from pic_bench.tracing import Trace  # noqa: E402

READERS = (collective_wait_ms, collectives_per_step)
CPU = torch.device("cpu")


def _trace(steps):
    return Trace(device=[], host=[], wall_s=1.0, steps=steps)


@pytest.fixture(autouse=True)
def _clean_record():
    program.reset()
    yield
    program.reset()


def _collective(name, seconds, *tensors):
    with program.collective(name, CPU, *tensors):
        time.sleep(seconds)


def _record(steps):
    """``steps`` steps of a decomposed deck: the halo's shift inside
    ``opal.halo``, the fold's inside ``opal.deposit``, one exchange's
    shift and one losses' sum after them."""
    halo = torch.zeros(2, 4, 3)
    fold = torch.zeros(4, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(steps):
            with program.span(program.STEP):
                with program.span(program.HALO, CPU):
                    _collective(program.SHIFT, 0.001, halo, halo)
                with program.span(program.DEPOSIT, CPU):
                    _collective(program.SHIFT, 0.001, fold, fold)
        with program.span(program.EXCHANGE, CPU):
            _collective(program.SHIFT, 0.002, torch.zeros(9, 17),
                        torch.zeros(9, 17))
        _collective(program.PSUM, 0.001, torch.zeros(3, dtype=torch.int64))
    return program.snapshot()


def test_readers_divide_the_record_by_the_steps():
    snap = _record(4)
    t = _trace(4)
    spans = snap["spans"]
    assert spans[program.SHIFT]["calls"] == 9
    assert collectives_per_step.read(t) == 10 / 4
    assert collective_wait_ms.read(t) == pytest.approx(
        (spans[program.SHIFT]["device_ms"]
         + spans[program.PSUM]["device_ms"]) / 4)
    # host clock extents of the sleeps: 4 x 2 ms, 2 ms and 1 ms
    assert collective_wait_ms.read(t) >= 11.0 / 4
    # the payloads' bytes, from the shapes alone
    assert snap["counters"][program.COLLECTIVE_BYTES] == (
        4 * 2 * (2 * 4 * 3 * 4 + 4 * 4 * 4) + 2 * 9 * 17 * 4 + 3 * 8)
    # the shifts lie inside the phases, and no phase sum holds them twice
    assert field_ms.read(t) == pytest.approx(
        (spans[program.HALO]["device_ms"]
         + spans[program.DEPOSIT]["device_ms"]) / 4)
    assert field_ms.read(t) >= 8.0 / 4


def test_readers_find_nothing_without_a_record():
    t = _trace(4)
    for reader in READERS:
        assert reader.read(t) is None, reader.__name__
    with profile(activities=[ProfilerActivity.CPU]):
        torch.ones(4).sum()
    for reader in READERS:
        assert reader.read(t) is None, reader.__name__


def test_a_world_of_one_reads_no_wait():
    """A step with no collective (one card, no process group): no wait
    to read, and a count of 0."""
    with profile(activities=[ProfilerActivity.CPU]):
        with program.span(program.STEP):
            with program.span(program.HALO, CPU):
                pass
    t = _trace(1)
    assert collective_wait_ms.read(t) is None
    assert collectives_per_step.read(t) == 0.0


def test_readers_find_nothing_in_an_older_program(monkeypatch):
    """A program whose collective spans carry no device time and that
    has no ``collectives`` counter (the tree before them): the readers
    leave their metrics out and do not raise."""
    _record(2)
    real = program.snapshot

    def older():
        snap = real()
        for name in (program.SHIFT, program.PSUM):
            snap["spans"][name].pop("device_ms", None)
        for name in (program.COLLECTIVE_CALLS, program.COLLECTIVE_BYTES):
            snap["counters"].pop(name)
        return snap

    monkeypatch.setattr(program, "snapshot", older)
    for reader in READERS:
        assert reader.read(_trace(2)) is None, reader.__name__
    monkeypatch.setitem(sys.modules, "opal_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["opal_tpu_torch"], "trace")
    for reader in READERS:
        assert reader.read(_trace(2)) is None, reader.__name__
