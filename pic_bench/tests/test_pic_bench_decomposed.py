"""The decomposed cell ``two_stream_512m.decomposed`` on the CPU, cut to
64 cells a rank as ``tiny_run`` cuts every cell, on four ``gloo`` ranks
through the driver's own ``measure``: against the undecomposed
reference, with the halo left out, traced (the ring's collectives read
by their metrics), the reference's shares of four ranks against the
uncut reference, and the control over four ranks."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from pic_bench import control_decomposed, harness  # noqa: E402
from pic_bench.drivers import periodic  # noqa: E402
from pic_bench.reference import compare  # noqa: E402
from test_pic_bench_reference import _rank, result_line, tiny_run  # noqa: E402

CELL = "two_stream_512m.decomposed"
WORLD = 4


def test_the_cell_is_four_ranks_of_the_column_cell():
    """A rank's share of the deck is the column cell's whole deck, run
    with the column cell's knobs."""
    run = tiny_run(CELL)
    full = harness.load_run(["--workload", CELL, "--seed", "1",
                             "--seconds", "1"], 0.0)
    column = harness.load_run(["--workload", "two_stream_128m.column",
                               "--seed", "1", "--seconds", "1"], 0.0)
    assert run.cell["chips"] == WORLD
    assert full.config["nx"] == WORLD * column.config["nx"]
    assert full.config["nx"] * full.config["npc"] == 2**29
    for key in ("dx", "cfl", "ne", "npc", "drift_u", "spread",
                "draw_chunk_cells", "precision", "driver", "deck"):
        assert full.config[key] == column.config[key], key
    assert full.cell["knobs"] == column.cell["knobs"]
    assert full.cell["layout"] == column.cell["layout"]
    assert full.cell["segment_steps"] == column.cell["segment_steps"]
    # each rank's draw is whole chunks
    n_loc = full.config["nx"] // WORLD
    assert n_loc % full.config["draw_chunk_cells"] == 0


@pytest.mark.parametrize("fault", [None, "halo_left_out"])
def test_four_ranks_against_the_undecomposed_reference(fault, capfd):
    from opal_tpu_torch.parallel import dist

    # long enough for the fields to move the electrons at the slabs'
    # edges, as the two-rank test of the reference's file
    run = tiny_run(CELL, steps=512)
    codes = dist.launch(_rank, WORLD, (run, fault), timeout=900)
    assert codes == [0] * WORLD
    line = result_line(capfd.readouterr().out)
    assert line["correct"] == (fault is None), line["checks"]
    assert line["device"]["count"] == WORLD
    if fault is None:
        assert line["failed"] == 0
        assert line["attempted"] == 512 * 64 * WORLD * 64


def test_a_traced_run_reads_the_collectives(capfd):
    """The traced run's line holds the ring's metrics from rank 0's
    record: two shifts a step, an exchange's shift every 16 steps and
    at the end, the losses' sum once; and a wait on each (the host
    clock on the CPU)."""
    from opal_tpu_torch.parallel import dist

    steps = 128
    run = tiny_run(CELL, steps=steps)
    traced = harness.load_run(["--workload", CELL, "--seed", "1",
                               "--seconds", "0", "--trace", "1"], 0.0)
    run.trace, run.metrics = True, traced.metrics
    assert {"collective_wait_ms", "collectives_per_step"} <= set(run.metrics)
    codes = dist.launch(_rank, WORLD, (run, None), timeout=900)
    assert codes == [0] * WORLD
    line = result_line(capfd.readouterr().out)
    assert line["correct"], line["checks"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    exchanges = steps // run.cell["knobs"]["migration_every"]
    assert metrics["collectives_per_step"] == pytest.approx(
        (2 * steps + exchanges + 1) / steps)
    assert metrics["collective_wait_ms"] > 0.0
    assert line["metrics"]["collective_wait_ms"]["unit"] == "ms/step"


def _reference_rank(rank, world, init_method, cfg, seed, steps, out):
    from opal_tpu_torch.parallel import dist

    ring = dist.init(rank, world, init_method, "cpu")
    try:
        s = periodic.reference_summary(cfg, seed, steps, "cpu", ring=ring)
        if rank == 0:
            torch.save(s, out)
        ring.barrier()
    finally:
        dist.close(ring)


@pytest.mark.parametrize("steps", [0, 256])
def test_the_ranks_shares_add_up_to_the_uncut_reference(steps, tmp_path):
    """The reference over four ranks (each the electrons of its slab,
    the grid whole, the currents summed) against the one-rank reference
    on the same draw: at the start every number equal, after 256 steps
    the same up to the order of the currents' sums."""
    from opal_tpu_torch.parallel import dist

    run = tiny_run(CELL)
    seed = 2**31 + 11
    out = tmp_path / "summary.pt"
    codes = dist.launch(_reference_rank, WORLD,
                        (run.config, seed, steps, str(out)), timeout=900)
    assert codes == [0] * WORLD
    ranks = torch.load(out)
    whole = periodic.reference_summary(run.config, seed, steps, "cpu")
    assert set(ranks) == set(whole)
    if steps == 0:
        for k in whole:
            assert torch.equal(ranks[k], whole[k]), k
        assert int(whole["alive"]) == run.config["nx"] * run.config["npc"]
    else:
        checks = compare.compare(ranks, whole, run.config["drift_u"])
        assert checks["lost"] == 0 and checks["count_gap"] <= 1, checks
        assert checks["field_gap"] < 1e-6 and checks["ux_gap"] < 1e-7, checks


def test_control_over_four_ranks_is_not_correct(capfd):
    """The bfloat16 reference over the cell's four ranks, judged by the
    harness's own verdict, is not correct under the cell's limits (the
    chip readings at the cell's size are in PERF.md)."""
    run = tiny_run(CELL, steps=256)
    assert control_decomposed.control(run, [11], "cpu") == 0
    line = result_line(capfd.readouterr().out)
    assert line["correct"] is False and line["dtype"] == "bfloat16"
    assert line["device"]["count"] == WORLD
    assert set(line["checks"]) == set(run.cell["limits"])
