"""The control of a cell's comparison: the plain reference computed in
the nearest precision below the deck's (bfloat16 for float32), put in
the program's place and compared with the float32 reference as a run's
check compares the program, at the cell's own size:

    python3 pic_bench/control.py --workload <cell> --seeds 11 12 13

Each seed's verdict goes through the harness's own (``harness.report``),
so it prints the compared numbers beside the cell's limits as the last
lines of standard error and a result line whose ``correct`` has to read
false.  It runs where the cell runs (one card) and is not part of a
run; ``PERF.md`` gives its readings and the limits set from them.
"""

import argparse
import importlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pic_bench import harness  # noqa: E402


def check(run: harness.Run, seed: int, device) -> int:
    """The control's verdict on one seed of ``run``'s cell, printed by
    ``harness.report``."""
    import torch

    from pic_bench.reference import compare

    driver = importlib.import_module(
        f"pic_bench.drivers.{run.config['driver']}")
    steps = run.cell["segment_steps"]
    t0 = time.perf_counter()
    ref = driver.reference_summary(run.config, seed, steps, device)
    low = driver.reference_summary(run.config, seed, steps, device,
                                   dtype=torch.bfloat16)
    checks = compare.compare(low, ref, run.config["drift_u"])
    print(f"pic_bench: control of {run.workload}, seed {seed}, bfloat16: "
          f"{time.perf_counter() - t0!r} s", file=sys.stderr)
    result = dict(correct=True, attempted=0, failed=0, metrics={},
                  device=harness.device_info(torch.device(device), 1, 0),
                  workload=run.workload, seed=seed, dtype="bfloat16")
    return harness.report(result, checks, run.cell["limits"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pic_bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.set_cache_env()
    run = harness.load_run(["--workload", args.workload, "--seed", "0",
                            "--seconds", "0"], time.time())
    return max(check(run, seed, args.device) for seed in args.seeds)


if __name__ == "__main__":
    sys.exit(main())
