"""The control of a decomposed cell's comparison, at the cell's own size
and over its own ranks: the plain reference in the nearest precision
below the deck's (bfloat16 for float32), put in the program's place and
compared with the float32 reference as a run's check compares the
program.

    python3 pic_bench/control_decomposed.py --workload <cell> --seeds 81 82 83

``control.py`` runs the reference on one card; a deck that no card holds
runs it here over the cell's ``chips`` ranks, a process and card each
(NCCL; ``gloo`` with ``--device cpu``), through the driver's
``reference_summary(..., ring=)``: each rank keeps the electrons of its
slab, the grid whole on every rank, the currents summed each step.  Each
seed's verdict goes through the harness's own (``harness.report``) on
rank 0, so it prints the compared numbers beside the cell's limits as
the last lines of standard error and a result line whose ``correct``
has to read false.  It is not part of a run; ``PERF.md`` gives its
readings and the limits set from them.
"""

import argparse
import importlib
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pic_bench import harness  # noqa: E402


def check(run: harness.Run, seed: int, ring) -> int:
    """The control's verdict on one seed of ``run``'s cell over the
    ranks of ``ring``, printed by ``harness.report`` on rank 0."""
    import torch

    from pic_bench.reference import compare

    driver = importlib.import_module(
        f"pic_bench.drivers.{run.config['driver']}")
    steps = run.cell["segment_steps"]
    t0 = time.perf_counter()
    ref = driver.reference_summary(run.config, seed, steps, ring.device,
                                   ring=ring)
    low = driver.reference_summary(run.config, seed, steps, ring.device,
                                   dtype=torch.bfloat16, ring=ring)
    if ring.rank != 0:
        return 0
    checks = compare.compare(low, ref, run.config["drift_u"])
    print(f"pic_bench: control of {run.workload} over {ring.world} ranks, "
          f"seed {seed}, bfloat16: {time.perf_counter() - t0!r} s",
          file=sys.stderr)
    result = dict(correct=True, attempted=0, failed=0, metrics={},
                  device=harness.device_info(ring.device, ring.world, 0),
                  workload=run.workload, seed=seed, dtype="bfloat16")
    return harness.report(result, checks, run.cell["limits"])


def _rank_main(rank: int, world: int, init_method: str, run: harness.Run,
               seeds, device_type: str):
    """One rank of the control: its own process (and card)."""
    from opal_tpu_torch.parallel import dist

    ring = dist.init(rank, world, init_method, device_type)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    try:
        rc = max(check(run, seed, ring) for seed in seeds)
        ring.barrier()
    finally:
        dist.close(ring)
    sys.exit(rc)


def control(run: harness.Run, seeds, device_type: str) -> int:
    """Every seed's verdict over the cell's ranks; the largest exit
    code of the ranks."""
    from opal_tpu_torch.parallel import dist

    codes = dist.launch(_rank_main, int(run.cell["chips"]),
                        (run, list(seeds), device_type))
    return max(codes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pic_bench/control_decomposed.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    harness.set_cache_env()
    run = harness.load_run(["--workload", args.workload, "--seed", "0",
                            "--seconds", "0"], time.time())
    return control(run, args.seeds, args.device)


if __name__ == "__main__":
    from pic_bench import control_decomposed

    sys.exit(control_decomposed.main())
