"""The general part of the benchmark: what every cell shares.

``run.py`` hands its arguments to :func:`main`, which finds the cell's
file ``cells/<workload>.json`` by its name, the configuration's file
``configs/<config>.json`` that the cell names, and the deck's module
``drivers/<kind>.py`` that the configuration names, and hands a
:class:`Run` to that module's ``main``.  It builds the deck from
the seed, warms it up, and calls back here for the measured window
(:func:`window`), the traced segment (:func:`traced`) and the result
line (:func:`report`).  The per-layer metrics are the readers
``metrics/<name>.py`` that ``BENCHMARK.json`` names.

No module of the benchmark imports JAX or the JAX package; the result
line is refused (exit code 3) if the process holds either once the
window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the program's build and kernel caches, inside the checkout
CACHE = ROOT / ".pic_bench_cache"
#: top-level module names that must not be loaded (compared whole:
#: ``opal_tpu_torch`` is the program, ``opal_tpu`` the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "opal_tpu")


def process_start_epoch() -> float:
    """The epoch seconds at which this process started (Linux's
    ``/proc``), so that ``setup_s`` counts the interpreter's start and
    the imports too; the time of the call where ``/proc`` is absent."""
    try:
        with open("/proc/self/stat") as f:
            after = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(after[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - max(0.0, age)
    except (OSError, IndexError, ValueError):
        return time.time()


def set_cache_env():
    """Every cache the program or PyTorch may write goes into the
    checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


@dataclasses.dataclass
class Run:
    """One run of one cell: its arguments, files and metric names."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    #: the names of the metrics this run reports, with their units
    metrics: dict
    start_epoch: float

    def setup_s(self) -> float:
        return time.time() - self.start_epoch


def parse(argv):
    p = argparse.ArgumentParser(prog="pic_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_run(argv, start_epoch: float) -> Run:
    """The run that ``argv`` asks for, from ``BENCHMARK.json`` and the
    cell's and configuration's files."""
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((HERE / "cells" / f"{args.workload}.json").read_text())
    config = json.loads(
        (HERE / "configs" / f"{cell['config']}.json").read_text())
    if args.trace:
        metrics = {m["name"]: m["unit"] for m in bench["per_layer"]
                   if args.workload in m.get("workloads", [args.workload])}
    else:
        metrics = {m["name"]: m["unit"] for m in bench["end_to_end"]
                   if args.workload in m.get("workloads", [args.workload])}
    return Run(args.workload, args.seed, args.seconds, bool(args.trace),
               cell, config, metrics, start_epoch)


def main(argv) -> int:
    start = process_start_epoch()
    set_cache_env()
    run = load_run(argv, start)
    import torch

    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pic_bench: {run.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"pic_bench.drivers.{run.config['driver']}")
    return driver.main(run)


def window(segment, seconds: float, sync, agree=None):
    """The measured window: whole replays of ``segment()`` (which
    restores the segment's start state itself) until the first segment
    boundary at or after ``seconds``; ``sync()`` waits for the device
    (on several ranks, for every rank), and ``agree(stop)`` makes the
    ranks take rank 0's decision.  Returns (seconds, segments, the last
    replay's output)."""
    sync()
    t0 = time.perf_counter()
    ends = []
    while True:
        out = segment()
        sync()
        ends.append(time.perf_counter() - t0)
        stop = ends[-1] >= seconds
        if agree is not None:
            stop = agree(stop)
        if stop:
            laps = [b - a for a, b in zip([0.0] + ends, ends)]
            print(f"pic_bench: segment seconds {laps!r}", file=sys.stderr)
            return ends[-1], len(ends), out


def traced(segment, sync, steps: int, context: dict):
    """One replay of ``segment()`` under the profiler: (output,
    :class:`tracing.Trace`)."""
    from pic_bench import tracing

    return tracing.capture(segment, sync, steps, context)


def read_metrics(run: Run, trace) -> dict:
    """The per-layer metrics of ``run`` from ``trace``, each by its
    reader ``metrics/<name>.py``; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for name, unit in run.metrics.items():
        reader = importlib.import_module(f"pic_bench.metrics.{name}")
        value = reader.read(trace)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_info(device, count: int, peak_bytes: int) -> dict:
    """The result's ``device``; a CPU run (the tests') says so."""
    import torch

    gpu = device.type == "cuda"
    return {"platform": "gpu" if gpu else "cpu",
            "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def report(result: dict, checks: dict, limits: dict) -> int:
    """Print the compared numbers beside their limits as the last lines
    of standard error, then the result line (``correct`` decided here,
    with ``checks`` as its last key) as the last line of standard
    output.  Refuses (exit code 3, no line) when JAX or the JAX package
    is loaded."""
    found = forbidden_modules()
    if found:
        print(f"pic_bench: loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    compared = {k: {"value": float(checks[k]), "limit": float(limits[k])}
                for k in limits}
    correct = bool(result.pop("correct", True)) and all(
        v["value"] <= v["limit"] for v in compared.values())
    for k, v in compared.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    line = {"correct": correct, **result, "checks": compared}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
