"""The per-layer readers on synthetic traces."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pic_bench.metrics import (  # noqa: E402
    device_idle_pct, kernels_per_step, push_deposit_roofline as roof,
)
from pic_bench.tracing import SEGMENT_RANGE, Trace  # noqa: E402

VAY = "void fused_push_deposit_kernel<false, true, false, true, false>(Args)"
#: the bench deck's state (PERF.md section 6's first row)
BENCH = dict(rows=10_485_760, live=8_388_608, block=8192, table_rows=1048,
             work_in=True)


def _trace(device, host=(), wall_s=1e-3, steps=2, context=None):
    return Trace(device=list(device), host=list(host), wall_s=wall_s,
                 steps=steps, context=context or {})


def test_busy_is_the_union_of_the_device_intervals():
    # [0, 100] and [50, 150] overlap, [300, 400] stands alone: 250 us
    t = _trace([("a", 0, 100), ("b", 50, 150), ("c", 300, 400)])
    assert t.busy_s() == pytest.approx(250e-6)
    assert device_idle_pct.read(t) == pytest.approx(75.0)
    assert t.idle_gaps() == [(150, 300)]


def test_kernels_per_step_counts_every_device_operation():
    t = _trace([("a", 0, 1), ("Memcpy DtoD", 2, 3), ("a", 4, 5)], steps=2)
    assert kernels_per_step.read(t) == 1.5


def test_readers_find_nothing_in_an_empty_trace():
    t = _trace([])
    for reader in (device_idle_pct, kernels_per_step, roof):
        assert reader.read(t) is None


def test_breakdown_labels_gaps_by_the_innermost_host_event():
    host = [(SEGMENT_RANGE, 0, 1000), ("aten::nonzero", 90, 400),
            ("cudaStreamSynchronize", 100, 390), ("aten::add", 500, 520)]
    t = _trace([("k1", 0, 100), ("k2", 400, 450), ("k2", 700, 800)], host)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k2", pytest.approx(150e-6)]
    # 100-400 while the host synchronised, 450-700 in Python
    assert dict(b["idle_gaps"]) == {
        "cudaStreamSynchronize": pytest.approx(300e-6),
        "python": pytest.approx(250e-6)}


@pytest.mark.parametrize("name, form", [
    (VAY, "vay"),
    ("_Z25fused_push_deposit_kernelILb0ELb1ELb1ELb1ELb0EEv4Args", "vay_full"),
    ("void fused_push_deposit_kernel<true, false, false, false, true>(A)",
     "boris_packed_dep_skip"),
    ("void cell_envelope_kernel(int)", None),
])
def test_form_of_kernel_names(name, form):
    assert roof.form_of(name) == form


@pytest.mark.parametrize("form, state, bound_ms", [
    # PERF.md section 6's bounds: the bench deck, lite Vay with the work
    # column, and the packed form; two_stream's CLI deck (155,648 rows,
    # block 2048, nx 1000); hole_boring's electrons and carbon ions
    ("vay", BENCH, 0.2504),
    ("vay_packed", dict(BENCH, work_in=False), 0.2880),
    ("vay", dict(rows=155_648, live=100_000, block=2048, table_rows=1024,
                 work_in=True), 0.0037),
    ("vay", dict(rows=753_664, live=700_000, block=2048, table_rows=20_228,
                 work_in=False), 0.0177),
    ("boris", dict(rows=753_664, live=700_000, block=2048, table_rows=20_228,
                   work_in=False), 0.0168),
])
def test_bound_matches_the_kernel_table(form, state, bound_ms):
    assert round(roof.bound_s(form, state) * 1e3, 4) == bound_ms


def test_roofline_share_over_the_form_launches():
    # two launches at PERF.md's 0.4654 ms, and one of another kernel
    t = _trace([(VAY, 0, 465.4), (VAY, 1000, 1465.4), ("other", 2000, 2100)],
               context={"push_deposit": {"vay": BENCH}})
    assert roof.read(t) == pytest.approx(100 * 0.2504393 / 0.4654, rel=1e-6)
    # a form the deck's module does not name is not read
    assert roof.read(_trace([(VAY, 0, 1)], context={
        "push_deposit": {"vay_packed": BENCH}})) is None
