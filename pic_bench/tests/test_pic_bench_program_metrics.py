"""The readers of the program's own spans and counters, on a record made
through ``opal_tpu_torch.trace``'s API under a CPU profiler."""

import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from opal_tpu_torch import trace as program  # noqa: E402
from pic_bench.metrics import (  # noqa: E402
    field_ms, host_syncs_per_step, misfit_ms, misfit_rows, sort_migrate_ms,
)
from pic_bench.tracing import Trace  # noqa: E402

READERS = (host_syncs_per_step, misfit_rows, misfit_ms, sort_migrate_ms,
           field_ms)
CPU = torch.device("cpu")


def _trace(steps):
    return Trace(device=[], host=[], wall_s=1.0, steps=steps)


@pytest.fixture(autouse=True)
def _clean_record():
    program.reset()
    yield
    program.reset()


def _phase(name, seconds):
    with program.span(name, CPU):
        time.sleep(seconds)


def _record(steps):
    """``steps`` steps of every phase the readers read, one misfit read
    a step and 3 misfit rows in the first step; a sort and an exchange
    in all."""
    with profile(activities=[ProfilerActivity.CPU]):
        _phase(program.SORT, 0.002)
        for i in range(steps):
            with program.span(program.STEP):
                for name in (program.HALO, program.PUSH, program.MISFIT,
                             program.DEPOSIT, program.FIELDS):
                    _phase(name, 0.001)
                n = program.host_read(torch.tensor(3 if i == 0 else 0))
                program.count(program.MISFIT_ROWS, n)
        _phase(program.EXCHANGE, 0.002)
    return program.snapshot()


def test_readers_divide_the_record_by_the_steps():
    snap = _record(4)
    t = _trace(4)
    ms = {k: v["device_ms"] for k, v in snap["spans"].items()
          if "device_ms" in v}
    assert host_syncs_per_step.read(t) == 1.0
    assert misfit_rows.read(t) == 0.75
    assert misfit_ms.read(t) == pytest.approx(ms[program.MISFIT] / 4)
    assert sort_migrate_ms.read(t) == pytest.approx(
        (ms[program.SORT] + ms[program.EXCHANGE]) / 4)
    assert field_ms.read(t) == pytest.approx(
        (ms[program.HALO] + ms[program.DEPOSIT] + ms[program.FIELDS]) / 4)
    # host clock extents of the sleeps
    assert ms[program.MISFIT] >= 4 * 1.0
    assert sort_migrate_ms.read(t) >= 4.0 / 4


def test_readers_find_nothing_without_a_record():
    t = _trace(4)
    for reader in READERS:
        assert reader.read(t) is None, reader.__name__
    # a session that ran no span of the program records nothing either
    with profile(activities=[ProfilerActivity.CPU]):
        torch.ones(4).sum()
    for reader in READERS:
        assert reader.read(t) is None, reader.__name__


def test_a_phase_that_did_not_run_is_left_out():
    with profile(activities=[ProfilerActivity.CPU]):
        with program.span(program.STEP):
            _phase(program.HALO, 0.001)
    t = _trace(1)
    assert field_ms.read(t) > 0.0
    assert misfit_ms.read(t) is None and sort_migrate_ms.read(t) is None
    assert host_syncs_per_step.read(t) == 0.0


def test_readers_find_nothing_in_a_program_without_the_module(monkeypatch):
    """A program without ``opal_tpu_torch.trace`` (an older tree): the
    readers leave their metrics out and do not raise."""
    _record(2)
    monkeypatch.setitem(sys.modules, "opal_tpu_torch.trace", None)
    monkeypatch.delattr(sys.modules["opal_tpu_torch"], "trace")
    for reader in READERS:
        assert reader.read(_trace(2)) is None, reader.__name__
