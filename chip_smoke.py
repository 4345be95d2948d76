"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile DIR   # phases 1, 2 and a profiled phase 8
    python3 chip_smoke.py --profile DIR --profile-deck colliding_beams
                                          # ... and a profiled phase 11
    python3 chip_smoke.py --ranks N       # the decks on N cards (phase 27)

Builds the port's CUDA kernels from ``opal_tpu_torch/csrc`` and drives
the port on the card, phase by phase, each printing one line or more:

1. device: the card, the CUDA version and ``nvidia-smi``'s name and
   power limit (there is no CPU fallback: without a card this exits 1);
2. build: ``nvcc`` of the kernel sources, the compiler's registers and
   spills of each kernel form (and of each instantiation of K1-K3, the
   QED stages' kernels), and the atomic instructions in each one's SASS
   (``cuobjdump -sass``);
3. kernel vs plain: the fused kernel against its plain PyTorch version
   on the same CUDA tensors, at the bench shape (8.39M electrons, nx
   1024, block 8192, window 12) and at the two_stream CLI shape (1e5
   electrons, nx 1000, block 2048, window 40), with both times; then a
   small two-stream deck stepped through ``Simulation`` on the card and
   on the CPU, whose fields and energies must agree;
4. CLI drive (the main path): ``opal_tpu_torch.cli.main`` on
   ``examples/two_stream.yaml`` at its full width, cut to 2000 steps
   over 4 outputs, with the kernel's launch count;
5. bench scale: the 8.39M-electron periodic deck of ``bench.py``'s
   defaults through ``Simulation`` for two sort periods (640 steps);
6. hole_boring kernels vs plain: the Boris form (carbon ions) and the
   Vay form with the work increment (electrons) against their plain
   versions at the hole_boring shapes (753,664 rows a species, block
   2048, window 56, n_rows 20,228), on the deck's sorted initial states
   and random laser-strength fields, with both times;
7. a small hole_boring deck (nx 800, npc 10, 200 steps, both species)
   stepped on the card and on the CPU, whose fields and energies must
   agree;
8. hole_boring CLI drive (the hole_boring main path):
   ``opal_tpu_torch.cli.main`` on ``examples/hole_boring.yaml`` at its
   full width (nx 20,000, npc 100 a species), with the slab moved to
   -9..-4 um and the run cut to t = -17..-8.5 um/c (8946 steps over 3
   outputs), so that the pulse's peak reaches the slab: the launches of
   each kernel form, the losses, the outputs and the ions' heating;
9. colliding_beams kernels vs plain: the full Vay form without the
   deposit (the QED main path's, also with the work increment), full
   Vay with it, lite Vay and lite Boris without it, on the deck's
   ``--f32`` sorted initial beam (75,776 rows, block 2048, window 56,
   n_rows 4228) under random laser-strength fields: push columns,
   prev_x, gh, chi, miss and anchors bitwise, no slab without the
   deposit;
10. a small emission deck (the QED burst deck of the JAX tests at one
    device) stepped at ``--f32`` on the card and on the CPU with the
    same host-made draws: photon counts and energies must agree;
11. colliding_beams CLI drive (the QED main path):
    ``opal_tpu_torch.cli.main`` on ``examples/colliding_beams.yaml
    --f32`` at full width (nx 4000, 50,000 electrons, 3155 steps over
    5 outputs): one launch of the full Vay form without the deposit a
    step, the emission sampler's inversions through K3 and no plain QED
    code, no loss, finite outputs, the photon FITS files, the photons'
    energy rising;
12. the mixed-precision colliding_beams deck (the unfused push with
    f64 arithmetic) over its whole window through ``Simulation.run``:
    the radiated-energy ledger closes below 1e-5;
13. packed kernels vs plain: kernel B2 (the packed layout's forms) in
    all four forms against its plain version at the bench shape, the Vay
    form at the two_stream CLI shape, and the hole_boring shape
    (electrons through Vay, ions through Boris): hot matrix, aux matrix
    and anchors bitwise, with B1's full Vay time on the same rows beside
    it;
14. the small two_stream deck of phase 3 and the small hole_boring deck
    of phase 7 with ``tpu: packed_fused: 1``, card vs CPU within 1e-5 of
    their scale, through the packed Vay and Boris forms;
15. the bench twin, ``python -m opal_tpu_torch.bench`` at its defaults
    with and without ``--packed`` (and ``--packed --no-deposition`` at 64
    steps a block): one JSON line each with no loss, one launch of the
    layout's form a step, and the twin's set-up seconds (the state drawn
    on the card);
16. the two_stream CLI drive of phase 4 with ``tpu: packed_fused: 1``,
    cut to 1000 steps: every step through the packed Vay form, no loss,
    energy drift below 1e-3;
17. the deposit on row orders that break its fast path: at the bench
    and two_stream CLI shapes, rows shuffled within each block, every
    row of a block in one cell, two cells alternating row by row, and
    dead and misfit rows interleaved (and at the CLI shape, blocks of
    128 rows), through B1's lite Vay form and B2's ``vay_packed``
    against their plain versions, with each case's device time;
18. QED absorption's functions: ``airy_ai`` over every branch and
    ``pair_cross_sections`` on 2**16 pairs, card against CPU at f64;
19. one ``absorb`` call on a forced-event state (4096 cells, ~65k
    electrons, 6144 photons), card against CPU with the same draws, in
    the three pairing modes with the active-set compaction on and off,
    and with it on over the electrons' segment rows instead of the
    per-cell table (the walk's other source): equal events and counts,
    every column within 1e-12;
20. B1's full Vay form with the deposit against its plain version at
    the shapes that now run it: ``bench --qed`` at 2,097,152 particles
    and ``bench --no-lite``;
21. the bench twin's QED deck, ``python -m opal_tpu_torch.bench --qed
    --particles 2097152`` (below 4e6 particles, as in ``bench.py``, the
    only size at which the deck runs the kernel), the same with
    ``--no-absorption``, and ``--no-lite`` cut to blocks of 256 steps:
    no loss, one launch of the full Vay form a step, the photons, the
    absorbed and stimulated events, K1's (one walk an ``absorb`` call
    with walkers), K2's (one a step) and K3's launches with no plain QED
    code on the card, and the ``absorb`` time a step;
22. the CLI's absorption path: ``examples/colliding_beams.yaml`` with
    ``photon_absorption: true`` at ``--f32`` and full width, cut to the
    crossing (5 outputs of 473 steps): one launch of the full Vay form
    without the deposit and one bracketed absorption call a step (K2
    once, K1 once a call with walkers, K3 for the sampler, no plain QED
    code), no
    loss, absorbed and stimulated events both seen, and the ledger
    closure with the laser's work within 1e-4;
23. the electrostatic field set-up at f64, card against CPU:
    ``electrostatic_init`` on random rho and J at the full hole_boring
    grid and on a periodic one, and ``initialize_fields`` on
    ``examples/hole_boring.yaml``'s full-width initial state with both
    species and with its electrons alone, within 1e-12 of each field's
    scale;
24. the field set-up and checkpoint/resume path: phase 8's full-width
    hole_boring deck with ``initialise_fields: true`` and ``checkpoint:
    true`` through the CLI, runs A and A' over 4 outputs of 150 steps
    (A' as a world of 1 under an NCCL process group: ``--coordinator``),
    run B over the first 2, then B resumed with A's deck
    (``--resume``): lite Vay and lite Boris on every step, no loss, the
    resumed output 2 byte-equal to B's, outputs 3-4 of B and all of A'
    within 1e-6 of A's energies with equal alive counts, the grid's
    difference from A's beside the same difference of A', and the
    checkpoint's size and the seconds of its save and load;
25. the generator across a resume: phase 10's small emission deck
    through ``Simulation.run`` with a save and a load between its two
    halves, against the continuous run: equal photons, energies within
    1e-12, and whether every column is bitwise equal;
26. the distributed path on one card: phase 4's two_stream CLI drive
    (2000 steps) again as a world of 1 under an NCCL group
    (``--coordinator``), and the bench twin at its defaults under the
    group beside phase 15's run without: energies to the printed digits
    and alive counts equal to the runs without a group, every step
    through the kernel, and the collectives each run issued with their
    time a step (phase 24's run A' is the hole_boring deck's such run);
28. photon absorption in the replicated-field mode: ``absorb``'s
    replicated branch at a world of 1 under NCCL against the plain
    branch on phase 19's forced-event state, bitwise; then, if this
    PyTorch's ``gloo`` reduces and gathers CUDA tensors, two gloo ranks
    sharing the card: the replicated ``absorb`` card vs CPU within 1e-12,
    and a small absorption deck at ``--f32`` (the full Vay form without
    the deposit and K1-K3 on each rank) card vs CPU within phase 10's
    bars;
29. the QED stages' kernels against their plain versions: K1 (the whole
    absorption walk in one launch, ``csrc/absorb_walk.cu``), K2 (the
    cell envelopes, ``csrc/cell_envelope.cu``) and K3 (the sampler's CDF
    inversions, ``csrc/pwmci_invert.cu``) on the arguments of their
    largest call in phases 19, 21 and 22 (phase 19's forced-event state,
    the ``bench --qed`` shape and the colliding_beams crossing), as
    captured (f32) and at f64: K2 and K3 bitwise, K1 equal event kinds,
    electrons and done masks (and the replicated mode's columns) and its
    depths within 1e-14 (f64) and one ulp (f32, in at most 1e-5 of them)
    of each photon's scale, with each kernel's device, call, plain and
    library times and its bound; K2 (one cooperative launch a call) with
    its grid's CTAs, tiles and shared memory;
30. the initial state drawn on the card: the bench twin's electrons at
    its default deck and at ``--qed --particles 2097152`` (with the QED
    deck's empty photon buffer) through ``species.initialize_device``
    on the card against the host draw ``species.initialize`` of the
    same deck copied to it: equal cells, alive masks and weights, row
    for row, and each draw's seconds;
31. the misfit fallback kernel against its plain version at the
    two_stream_128m cell's field table and table capacity (2048), after
    B1 on 16.8M electrons with 15 moved out of their window: columns, slab
    and losses within the tolerances of ``tests/test_torch_misfit_cuda.py``,
    and the kernel's device, call and plain times with an empty table
    and with the 15 rows;
32. the misfit compaction kernel (``csrc/misfit_compact.cu``) against
    its plain version, the PyTorch chain it replaced, at the shapes of
    its callers: the two_stream_128m cell's 147,644,416 flags with a
    table of 2048 (no flag, then 15), and ``bench --qed``'s and the
    colliding_beams crossing's emitter compactions (2,621,440 and 75,776
    flags, 1% flagged, a table of every flagged row): tables and
    overflows equal, with the kernel's device, call and plain times, its
    bound (the flags read and the table written once at the HBM rate),
    the device time of each of its three launches and their registers.

``python3 chip_smoke.py --ranks N`` runs phases 1-2, then phase 27
instead of 3-28: the two_stream deck (2000 steps), phase 24's
hole_boring deck (600 steps) and phase 22's colliding_beams deck with
absorption at ``--f32`` through ``--devices N`` on N cards, each in the
domain and the replicated-field mode, against the same deck on one
card, and the bench twin.  It exits 1 on a machine with fewer than N
cards.

Kernel times (``ms``) are device time: 20 calls queued behind a
device-side spin run back to back between two CUDA events.  The
wrapper's whole call (``call_ms``) and the plain version's
(``plain_ms``) are timed by CUDA events around each call, host launch
included.  Phases 1-32 take about ten to
eighteen minutes.  Any failed check raises, so the
script exits non-zero without the final line.  Before the last line it
prints one JSON object describing each kernel form of the paths, and
``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL = dict(
    route="cuda",
    source="opal_tpu_torch/csrc/fused_push_deposit.cu",
    replaces="opal_tpu/ops/fused.py:727",
)
#: kernel B2, the packed layout's forms of the same source
KERNEL_PACKED = dict(KERNEL, replaces="opal_tpu/ops/fused.py:1041")
#: the H100 SXM's HBM rate and f32 (non-tensor-core) peak, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations a pushed row costs, counted from the kernel source:
#: the 4-tap gather ~114, the push (Vay ~113, Boris ~81), the x/y/z
#: advance ~10; the full form's gamma at the half step and chi ~30; the
#: deposit's weights, fluxes and 15 adds ~143
OPS_PUSH = {"vay": 237, "boris": 205}
OPS_FULL, OPS_DEPOSIT = 30, 143
#: the H100 SXM's f64 peak outside the tensor cores (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12
#: the hand kernels of the QED stages opal_tpu's XLA fuses (K1-K3), by
#: wrapper: the source, and the opal_tpu code each replaces
QED_KERNELS = {
    "absorb_walk": dict(route="cuda",
                        source="opal_tpu_torch/csrc/absorb_walk.cu",
                        replaces="opal_tpu/interactions.py:843"),
    "cell_envelopes": dict(route="cuda",
                           source="opal_tpu_torch/csrc/cell_envelope.cu",
                           replaces="opal_tpu/interactions.py:298"),
    "invert_many": dict(route="cuda",
                        source="opal_tpu_torch/csrc/pwmci_invert.cu",
                        replaces="opal_tpu/qed/pwmci.py:214"),
}
#: their instantiations, as :func:`_form_of` names them
QED_FORMS = ("absorb_walk<f32,f32>", "absorb_walk<f32,f64>",
             "absorb_walk<f64,f32>", "absorb_walk<f64,f64>",
             "cell_envelope", "pwmci_invert<f32>", "pwmci_invert<f64>")
#: operations of K1 by what a valid (photon, candidate) pair needs,
#: counted from its source with each pow, exp, log and sqrt as one: the
#: shared invariants with the probabilities, sums and fire tests (with
#: stimulated emission or without); each cross section the plain code
#: keeps (its channel valid), outside its Airy function; and the Airy
#: function, only where its argument lies in [0, 50) (the plain code
#: discards the value elsewhere)
OPS_PAIR_BASE = {True: 30, False: 20}
OPS_XS, OPS_AIRY = 20, 60
#: PR 10's count: every valid pair charged both cross sections (one
#: without stimulated emission) and their Airy functions
OPS_PAIR = {stim: OPS_PAIR_BASE[stim] + (2 if stim else 1)
            * (OPS_XS + OPS_AIRY) for stim in (True, False)}
#: K1's bars for the depths against its plain version, of each photon's
#: scale: one ulp at f32 (the kernel's f64 sums round to the plain
#: version's f32 sums but where the card's cumsum, a tree, rounds the
#: other way near a tie), and in at most DEPTH_MOVED of the depths
DEPTH_BAR = {torch.float32: 2.0**-23, torch.float64: 1e-14}
DEPTH_MOVED = 1e-5
#: operations of one query in K3: its segment search (n compares), then
#: 44 halvings of ~22 operations (the Hermite cubic and the midpoint)
OPS_HALVING = 22
# bench.py's non-QED defaults (bench.py:145-498)
BENCH = dict(particles=8 * 2**20, nx=1024, block=8192, window=12,
             resort=320, migrate=160, misfit=256, drift_cells=0.0095,
             capacity_factor=1.25)


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def qed_wrappers() -> dict:
    """The wrappers of K1-K3 by name (:data:`QED_KERNELS`); each counts
    its kernel's launches in ``.launches``."""
    from opal_tpu_torch.ops import absorb_walk as AW
    from opal_tpu_torch.qed import pwmci

    return {"absorb_walk": AW.absorb_walk,
            "cell_envelopes": AW.cell_envelopes,
            "invert_many": pwmci.invert_many}


def reset_launches():
    """Set every kernel form's launch count, and K1-K3's, to 0."""
    from opal_tpu_torch.ops import fused as F

    F.fused_push_deposit.launches.update(dict.fromkeys(F.FORMS, 0))
    for w in qed_wrappers().values():
        w.launches = 0


def launched() -> dict:
    """The kernel forms launched since the last reset, with their
    counts."""
    from opal_tpu_torch.ops import fused as F

    return {k: v for k, v in F.fused_push_deposit.launches.items() if v}


def qed_launched() -> dict:
    """K1-K3's launches since the last reset, by wrapper."""
    return {k: w.launches for k, w in qed_wrappers().items()}


@contextlib.contextmanager
def no_plain_qed():
    """Fails if K1-K3's plain versions, ``torch.cummax`` or
    ``torch.cummin`` run inside the block: on the card the QED stages
    go through the kernels alone."""
    from opal_tpu_torch.ops import absorb_walk as AW
    from opal_tpu_torch.qed import pwmci

    calls = collections.Counter()
    spots = [(AW, "absorb_walk_reference"), (AW, "absorb_pass_reference"),
             (AW, "cell_envelopes_reference"),
             (pwmci, "invert_many_reference"), (torch, "cummax"),
             (torch, "cummin")]
    real = [getattr(m, n) for m, n in spots]

    def spy(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for (m, n), fn in zip(spots, real):
        setattr(m, n, spy(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(spots, real):
            setattr(m, n, fn)
    assert not calls, f"plain QED code ran on the card: {dict(calls)}"


class _Spy:
    """Calls ``before(*args)``, then ``fn``; its ``launches`` is ``fn``'s,
    so a wrapper that counts through its module's name still counts in
    ``fn`` while the spy stands in for it."""

    def __init__(self, fn, before):
        self.fn, self.before = fn, before

    def __call__(self, *a, **kw):
        self.before(*a, **kw)
        return self.fn(*a, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def capture_qed(store: dict):
    """Keeps, in ``store``, the arguments of the largest call of each of
    K1-K3 made inside the block (K1's walk with the most photons, K2's
    longest cell column, K3's call with the most queries), for phase 29,
    and counts in ``store["walks"]`` the walk calls that had photons
    (each launches the walk kernel once).  Each argument is a fresh
    tensor the caller never changes, so a reference is kept, not a
    copy."""
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.qed import pwmci

    real = dict(absorb_walk=I.absorb_walk, cell_envelopes=I.cell_envelopes,
                invert_many=pwmci.invert_many)
    store.setdefault("walks", 0)

    def keep(name, size, args):
        if size > store.get(name, (0, None))[0]:
            store[name] = (size, args)

    def absorb_walk(*a, **kw):
        store["walks"] += a[0].shape[0] > 0
        keep("absorb_walk", a[0].shape[0], (a, kw))

    def cell_envelopes(cell):
        keep("cell_envelopes", cell.shape[0], cell)

    def invert_many(problems):
        keep("invert_many", sum(p[2].shape[0] for p in problems), problems)

    I.absorb_walk = _Spy(real["absorb_walk"], absorb_walk)
    I.cell_envelopes = _Spy(real["cell_envelopes"], cell_envelopes)
    pwmci.invert_many = _Spy(real["invert_many"], invert_many)
    try:
        yield store
    finally:
        I.absorb_walk = real["absorb_walk"]
        I.cell_envelopes = real["cell_envelopes"]
        pwmci.invert_many = real["invert_many"]


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


#: the template arguments of one instantiation of the kernel in its
#: mangled name: kBoris, kWork, kFull, kDeposit, kPacked
_FORM_BITS = re.compile(r"fused_push_deposit_kernelILb([01])ELb([01])ELb([01])"
                        r"ELb([01])ELb([01])E")
#: K1-K3's kernels in their mangled names (:data:`QED_FORMS`)
_QED_FORM = re.compile(r"(absorb_walk)_kernelI([fd])([fd])E|"
                       r"(pwmci_invert)_kernelI([fd])E|"
                       r"(cell_envelope)_kernel")
_TYPE = {"f": "f32", "d": "f64"}


def _form_of(mangled: str) -> str | None:
    """The launch counts' name of the kernel form a mangled symbol
    instantiates (``ops.fused.form_name``/``packed_form_name``), or the
    name of a K1-K3 kernel in :data:`QED_FORMS`."""
    q = _QED_FORM.search(mangled)
    if q is not None:
        if q[1]:
            return f"absorb_walk<{_TYPE[q[2]]},{_TYPE[q[3]]}>"
        if q[4]:
            return f"pwmci_invert<{_TYPE[q[5]]}>"
        return q[6]
    m = _FORM_BITS.search(mangled)
    if m is None:
        return None
    boris, _, full, deposit, packed = (b == "1" for b in m.groups())
    name = ("boris" if boris else "vay") + (
        "_packed" if packed else "_full" if full else "")
    return name + ("" if deposit else "_dep_skip")


def ptxas_report(log_text: str) -> dict:
    """{form: "N registers, S B spill stores, L B spill loads"} from the
    build's ``-Xptxas -v`` output."""
    out, form, spill = {}, None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            form = _form_of(line)
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            spill = f"{m[1]} B spill stores, {m[2]} B spill loads"
        elif "Used" in line and "registers" in line and form is not None:
            regs = re.search(r"Used (\d+) registers", line)[1]
            out[form] = f"{regs} registers, {spill}"
            form = None
    return out


def sass_atomics(lib: Path) -> dict | None:
    """{form: {opcode: count}}: the atomic instructions (``ATOMS``
    shared, ``ATOM``/``RED`` global) in each kernel form's SASS, read with
    the toolkit's ``cuobjdump -sass``; None without cuobjdump."""
    from opal_tpu_torch import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True)
    out, form = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            form = _form_of(line)
            if form is not None:
                out[form] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"((?:ATOMS|ATOMG|ATOM|RED)\b[\w.]*)", line)
        if m and form is not None:
            out[form][m[1]] += 1
    return {f: dict(c) for f, c in out.items()}


def cuda_ms(fn, reps=20):
    """Median milliseconds of ``fn()`` on the current stream, each call
    timed with its own pair of CUDA events after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20, spin_cycles=200_000_000):
    """Mean device milliseconds of one call of ``fn()``, after one
    warm-up: the device's own time for the work the call enqueues,
    without the host's launch and allocations (which :func:`cuda_ms`
    includes, and which set the call's time at small shapes).  The
    device first spins for ``spin_cycles`` clock cycles (~0.1 s) while
    the host enqueues ``reps`` calls behind it, so that they then run
    back to back between two CUDA events; the spin must outlast the
    enqueue, or the host's gaps would be timed too."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(spin_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    assert enqueue_ms < spin_ms, (enqueue_ms, spin_ms)
    return ev[1].elapsed_time(ev[2]) / reps


def two_stream_state(geom, npc, cap, dt, device, seed=0):
    """The bench/two_stream electron population: density 20 m^-1 per
    cell width, counter-streaming at +-2.5e-24 kg m/s with 0.1% spread."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.species import SpeciesSpec, initialize

    drift = 2.5e-24 / (const.ELECTRON_MASS * const.SPEED_OF_LIGHT)
    return initialize(
        SpeciesSpec.electron(), geom, npc,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, n: drift * (1.0 + 0.001 * n) * np.sign(u - 0.5),
        uy=lambda x, u, n: np.zeros_like(x),
        uz=lambda x, u, n: np.zeros_like(x),
        dt=dt, capacity_per_device=cap, seed=seed, dtype=np.float32,
        device=device,
    )


def bound(spec, n_rows_state, n_pushed, packed=False):
    """(bound_ms, bound_by): the least time the card could take for one
    launch: each input column read once and each output written once
    (4 B a value: 9 inputs, the work column when it is read, the 8
    updated columns, the work output and ``miss``, and prev_x gh chi in
    the full form; the packed layout always 23: the 9 columns of H read
    and written, the weight, the 4 of A; the anchors both ways, the field
    table read, the deposit slab written unless the deposit is skipped)
    over the HBM rate, against the f32 operations of the rows that were
    pushed over the f32 peak."""
    cols = 23 if packed else (
        9 + (spec.work_out and not spec.work_inc) + 8 + spec.work_out
        + 1 + 3 * (not spec.lite))
    nblk = n_rows_state // spec.block
    slab = 0 if spec.dep_skip else 16
    nbytes = 4 * (cols * n_rows_state + 2 * nblk + spec.n_rows * (8 + slab))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = (OPS_PUSH[spec.pusher] + OPS_FULL * (packed or not spec.lite)
           + OPS_DEPOSIT * (not spec.dep_skip))
    t_ops = n_pushed * ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_vs_plain(label, st, spec, fields_seed=1, e_scale=10.0,
                    b_scale=1e-8, phase=3, sort=True):
    """Compare the kernel with its plain version on one state, sorted
    first unless ``sort`` is false, and random E/B (E ~ ``e_scale`` V/m,
    B ~ ``b_scale`` T): the push columns (with prev_x, gh and chi in the
    full form), ``miss`` and the next anchors bitwise, the slab within
    1e-5 of its scale; without the deposit, no slab at all (the kernel
    is handed a null pointer, so a write would fault).  Returns
    (max_abs_err, ms, plain_ms, bound_ms, bound_by, call_ms): ``ms`` the
    device time of the wrapper's call (the kernel, and with the deposit
    the slab's zero fill), ``call_ms`` and ``plain_ms`` the wrapper's and
    the plain version's calls timed as a whole with CUDA events, host
    launch included."""
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    dev = st.x.device
    n_loc = spec.n_rows - 2 * F.PAD - 8
    if sort:
        st = sort_state(st, n_loc)
    g = torch.Generator(device="cpu").manual_seed(fields_seed)
    E = (e_scale * torch.randn(n_loc + 8, 3, generator=g)).to(dev)
    B = (b_scale * torch.randn(n_loc + 8, 3, generator=g)).to(dev)
    eb = F.make_eb_rows(E, B)
    anchors = F.block_anchors(spec, st.cell)
    work = st.work if spec.work_out and not spec.work_inc else None
    args = (spec, anchors, st.cell, st.x, st.y, st.z, st.ux, st.uy, st.uz,
            st.gamma, st.weight, work, eb)
    ck, mk, ok, ak = F.fused_push_deposit(*args)
    cr, mr, orf, ar = F.fused_push_deposit_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(mk, mr), "miss flags differ"
    assert torch.equal(ak, ar), "next anchors differ"
    bitwise = all(torch.equal(ck[c], cr[c]) for c in cr)
    push_err = max((ck[c].double() - cr[c].double()).abs().max().item()
                   for c in cr)
    assert bitwise, f"push columns differ from the plain version ({push_err})"
    if spec.dep_skip:
        assert ok is None and orf is None
        slab_err, slab_txt = 0.0, "no slab (deposit skipped)"
    else:
        slab_err = (ok - orf).abs().max().item()
        scale = orf.abs().max().item()
        assert scale > 0 and slab_err <= 1e-5 * scale, (slab_err, scale)
        slab_txt = f"slab max |err| {slab_err:.3e} (max |slab| {scale:.3e})"
    ms = device_ms(lambda: F.fused_push_deposit(*args))
    call_ms = cuda_ms(lambda: F.fused_push_deposit(*args))
    plain_ms = cuda_ms(lambda: F.fused_push_deposit_reference(*args))
    n_alive = int(st.alive.sum())
    n_miss = int(mk.sum().item())
    bound_ms, bound_by = bound(spec, st.cell.shape[0], n_alive - n_miss)
    cols = "push columns" + ("" if spec.lite else ", prev_x, gh, chi")
    log(phase, f"{label} ({F.form_name(spec)}"
               f"{', work_inc' if spec.work_inc else ''}"
               f"): rows {st.cell.shape[0]} (alive {n_alive}), block "
               f"{spec.block}, window {spec.window}, n_rows {spec.n_rows}: "
               f"{cols}, miss and anchors bitwise equal; {slab_txt}; misses "
               f"{n_miss}; kernel {ms:.4f} ms of device time (20 calls back "
               f"to back), the wrapper's call {call_ms:.4f} ms, plain "
               f"{plain_ms:.4f} ms (medians of 20), bound {bound_ms:.4f} "
               f"ms ({bound_by})")
    return max(push_err, slab_err), ms, plain_ms, bound_ms, bound_by, call_ms


#: the deck option that carries the fused species in the packed layout
PACKED_DECK = "\ntpu:\n packed_fused: 1\n"


def small_deck(tmp: Path, nx=128, npc=64, steps=40, outputs=2,
               packed=False) -> Path:
    from opal_tpu_torch import constants as const

    dt = 0.95 * 500.0 / const.SPEED_OF_LIGHT
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", f"nx: {nx}").replace("npc: 100", f"npc: {npc}")
    src = src.replace("end: 0.1", f"end: {(steps + 0.5) * dt!r}")
    src = src.replace("n_outputs: 20", f"n_outputs: {outputs}")
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "deck.yaml").write_text(src + (PACKED_DECK if packed else ""))
    return tmp / "deck.yaml"


def card_vs_cpu(tmp: Path, packed=False):
    """A small deck stepped on the card (kernel) and on the CPU (plain
    version): f32 particles, f64 fields; the CUDA and CPU float ops round
    alike but the deposit adds in another order, so fields and energies
    agree to within 1e-5 of their scale.  With ``packed`` the deck sets
    ``tpu: packed_fused: 1`` and every step launches the packed Vay
    form (phase 14)."""
    from opal_tpu_torch.cli import build

    deck = small_deck(tmp / ("small_packed" if packed else "small"),
                      packed=packed)
    out = {}
    for dev in ("cuda", "cpu"):
        sim, sp, _ = build(deck, device=dev)
        assert sim._fused_applicable("electron", sp["electron"])
        assert sim._packed_applicable("electron", sp["electron"]) == packed
        reset_launches()
        res = sim.run(*sim.init_fields(), sp, 0.0, sim.zero_counters(), 40)
        if dev == "cuda":
            form = "vay_packed" if packed else "vay"
            assert launched() == {form: 40}, launched()
        assert int(res[6]["electron"]) == 0
        out[dev] = (res, sim.em_field_energy(res[0], res[1]),
                    sim.total_kinetic_energy("electron", res[4]["electron"]))
    (rc, fc, kc), (rp, fp, kp) = out["cuda"], out["cpu"]
    worst = 0.0
    for i, name in enumerate(("E", "B", "J", "rho")):
        a, b = rc[i].cpu(), rp[i]
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
        assert err < 1e-5, (name, err)
        worst = max(worst, err)
    assert abs(fc - fp) <= 1e-5 * abs(fp) and abs(kc - kp) <= 1e-5 * abs(kp)
    log(14 if packed else 3,
        f"small two-stream deck (nx 128, npc 64, 40 steps"
        f"{', tpu: packed_fused: 1, 40 launches of vay_packed' if packed else ''}"
        f"), card vs CPU: fields within {worst:.2e} of their scale, field "
        f"energy {fc:.6e} vs {fp:.6e} J, kinetic {kc:.6e} vs {kp:.6e} J")


def cli_drive(tmp: Path, steps=2000, outputs=4, packed=False, group=False):
    """The main path through the user's entry point (with ``packed``, the
    deck with ``tpu: packed_fused: 1``: phase 16; with ``group``, as a
    world of 1 under an NCCL group: phase 26).  Returns (launches,
    steps/s, the alive counts of each output, the collectives)."""
    from opal_tpu_torch import cli

    src = _two_stream_deck(steps, outputs)
    run = tmp / ("two_stream_packed" if packed else
                 "two_stream_group" if group else "two_stream")
    run.mkdir(parents=True)
    (run / "deck.yaml").write_text(src + (PACKED_DECK if packed else ""))
    so, se = io.StringIO(), io.StringIO()
    reset_launches()
    alive = []
    real_gather = cli._gather

    def gather(*args):
        res = real_gather(*args)
        alive.append({n: int(c["alive"].sum()) for n, c in res[1].items()})
        return res

    cli._gather = gather
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se), \
                Collectives() as coll:
            rc = cli.main([str(run / "deck.yaml"),
                           *(coordinator() if group else ())])
        torch.cuda.synchronize()
    finally:
        cli._gather = real_gather
    wall = time.perf_counter() - t0
    launches = launched()
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron]" in out, out
    assert "buffer-overflow particle losses" not in err, err
    form = "vay_packed" if packed else "vay"
    assert list(launches) == [form], launches
    launches = launches[form]
    totals = []
    for i in range(outputs + 1):
        g = np.loadtxt(run / f"{i}_grid.dat")
        assert g.shape == (1000, 11) and np.isfinite(g).all()
        e = dict(l.split() for l in (run / f"{i}_energy.dat").read_text()
                 .splitlines())
        e = {k: float(v) for k, v in e.items()}
        assert all(math.isfinite(v) for v in e.values()) and e["electrons"] > 0
        totals.append(e["em_field"] + e["electrons"])
        assert (run / f"{i}_electron_x-px.fits").stat().st_size % 2880 == 0
    drift = abs(totals[-1] - totals[0]) / totals[0]
    assert drift < 1e-3, drift
    banner = out.splitlines()[0]
    log(26 if group else 16 if packed else 4,
        f"python -m opal_tpu_torch two_stream.yaml (nx 1000, npc 100, "
        f"{steps} steps, {outputs} outputs"
        f"{', tpu: packed_fused: 1' if packed else ''}"
        f"{', a world of 1 under an NCCL group' if group else ''}): "
        f"'{banner}', launches of {form} {launches}, no losses, total "
        f"energy drift {drift:.3e}, {steps / wall:.1f} steps/s over "
        f"{wall:.2f} s incl. output dumps")
    return launches, steps / wall, alive, coll


def bench_scale(smi: str):
    """bench.py's default deck through Simulation: all-f32, deposition
    and migration on, 2 sort periods."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.sim import SimOptions, Simulation
    from opal_tpu_torch.species import SpeciesSpec

    b = BENCH
    nx = b["nx"]
    npc = b["particles"] // nx
    cap = int(npc * nx * b["capacity_factor"])
    cap = -(-cap // b["block"]) * b["block"]
    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
    opts = SimOptions(
        dt=dt, fused_pusher=True, fused_block=b["block"],
        fused_window=b["window"], fused_resort_every=b["resort"],
        migration_every=b["migrate"], fused_misfit_capacity=b["misfit"],
        max_drift_cells_per_step=b["drift_cells"],
        migration_capacity=-(-int(npc * b["migrate"] * 0.0095 * 1.5 + 384)
                             // 8) * 8,
        migration_window=max(4096, -(-int(npc * (0.0095 * b["resort"] + 3))
                                     // 8) * 8),
    )
    sim = Simulation(geom, opts, {"electron": SpeciesSpec.electron()},
                     device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    st = two_stream_state(geom, npc, cap, dt, "cuda")
    setup = time.perf_counter() - t0
    n_alive = int(st.alive.sum())
    assert sim._cadences({"electron": st}) == (b["migrate"], b["resort"])
    E, B, J, rho = sim.init_fields()
    counters = sim.zero_counters()
    species = {"electron": st}
    t = 0.0
    reset_launches()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E, B, J, rho, species, t, counters = sim.run(
            E, B, J, rho, species, t, counters, b["resort"]
        )
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps = 2 * b["resort"]
    assert launched() == {"vay": steps}, launched()
    assert int(counters["electron"]) == 0, int(counters["electron"])
    ke = sim.total_kinetic_energy("electron", species["electron"])
    fe = sim.em_field_energy(E, B)
    assert math.isfinite(ke) and math.isfinite(fe) and ke > 0
    rate = n_alive * b["resort"] / walls[1]
    log(5, f"bench deck ({n_alive} electrons, cap {cap}, nx {nx}, f32, "
           f"block {b['block']}, window {b['window']}, R {b['resort']}, "
           f"M {b['migrate']}): {steps} steps, launches {steps}, no losses; "
           f"setup {setup:.1f} s; period 1 {walls[0]:.3f} s, period 2 "
           f"{walls[1]:.3f} s -> {rate:.4e} pushes/s (period 2) on {smi}")


#: a hole_boring deck cut to nx 800 and npc 10 (the deck of
#: tests/test_torch_hole_boring.py, with the port's own auto-sizing):
#: 200 steps, the pulse's peak reaching the slab near step 150.  Later
#: the driven slab turns chaotic: a one-ulp change of some electrons'
#: positions grows past 1e-5 of the current's scale by step 300, so a
#: longer run could not hold the card to 1e-5
HB_SMALL = """\
control:
 dx: micro / 100
 nx: 800
 xmin: -2*micro
 start: -2.0e-6/c
 end: -0.1e-6/c
 current_deposition: true
 n_outputs: 1
qed:
 photon_emission: false
 photon_absorption: false
electrons:
 npc: 10
 ne: density * critical(omega) * step(x,xmin,xmax)
 ux: sqrt(kT/(m*c^2)) * nrand
 uy: sqrt(kT/(m*c^2)) * nrand
 uz: sqrt(kT/(m*c^2)) * nrand
 output: [x:px]
ions:
 name: carbon
 npc: 10
 Z: Z
 A: A
 ni: density * critical(omega) * step(x,xmin,xmax) / Z
 ux: sqrt(kT/(A*mp*c^2)) * nrand
 uy: sqrt(kT/(A*mp*c^2)) * nrand
 uz: sqrt(kT/(A*mp*c^2)) * nrand
 output: [x:px]
laser:
 Ey: (a0*me*c*omega/e) * gauss_pulse_re(t,x,omega,sigma)
 Ez: (a0*me*c*omega/e) * gauss_pulse_im(t,x,omega,sigma)
constants:
 density: 4.0
 a0: 10.0
 omega: 2*pi*c/0.8e-6
 sigma: pi * 2.0 / sqrt(ln(2.0))
 kT: 500 * eV
 Z: 6.0
 A: 12.0
 xmin: -0.5 * micro
 xmax: 1.5 * micro
"""
#: examples/hole_boring.yaml as shipped, but for the time span, the
#: output count and the slab, moved together so that the pulse's peak
#: reaches the slab within the run (the injected envelope at t = -17
#: um/c is 1.3e-3 of its peak, which meets the slab's front at -9 um/c)
HB_CLI_EDITS = (
    ("start: -20.0e-6/c", "start: -17.0e-6/c"),
    ("end: 10.0e-6/c", "end: -8.0e-6/c"),
    (" xmin: 0.0 * micro", " xmin: -9.0 * micro"),
    (" xmax: 5.0 * micro", " xmax: -4.0 * micro"),
)


def hole_boring_kernels():
    """Phase 6: both kernel forms against their plain versions on the
    full hole_boring deck's initial states (sorted), under random
    fields of laser strength (E ~ 1e13 V/m, B ~ 3e4 T).  Returns
    {pusher: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    from opal_tpu_torch.cli import build

    sim, states, _ = build(ROOT / "examples" / "hole_boring.yaml",
                           device="cuda")
    out = {}
    for name, st in states.items():
        spec = sim._fused_spec(name)
        assert sim._fused_applicable(name, st)
        assert (spec.block, spec.window, spec.n_rows, st.x.shape[0]) == (
            2048, 56, 20_228, 753_664), spec
        out[spec.pusher] = kernel_vs_plain(
            f"hole_boring {name} shape", st, spec, fields_seed=2,
            e_scale=1e13, b_scale=3e4, phase=6,
        )
    del sim, states
    torch.cuda.empty_cache()
    return out


def hb_card_vs_cpu(tmp: Path, packed=False):
    """Phase 7: the small hole_boring deck stepped on the card (both
    kernel forms) and on the CPU (their plain versions), f32 particles
    and f64 fields: the push columns round alike, the deposits add in
    another order, so fields and energies agree within 1e-5 of their
    scale.  With ``packed`` (phase 14) the deck sets ``tpu:
    packed_fused: 1``: the packed Vay and Boris forms.  Returns the
    card's launches."""
    from opal_tpu_torch.cli import build

    name = "hb_small_packed" if packed else "hb_small"
    (tmp / name).mkdir()
    deck = tmp / name / "deck.yaml"
    deck.write_text(HB_SMALL + (PACKED_DECK[1:] if packed else ""))
    out = {}
    for dev in ("cuda", "cpu"):
        sim, sp, rp = build(deck, device=dev)
        assert all(sim._fused_applicable(n, sp[n]) for n in sp)
        assert all(sim._packed_applicable(n, sp[n]) == packed for n in sp)
        steps = rp["total_steps"]
        reset_launches()
        res = sim.run(*sim.init_fields(), sp, rp["tstart"],
                      sim.zero_counters(), steps)
        if dev == "cuda":
            launches = launched()
            forms = ("vay_packed", "boris_packed") if packed else (
                "vay", "boris")
            assert launches == dict.fromkeys(forms, steps), launches
        assert all(int(v) == 0 for v in res[6].values()), res[6]
        out[dev] = (res, sim.em_field_energy(res[0], res[1]), {
            n: sim.total_kinetic_energy(n, res[4][n]) for n in sp})
    (rc, fc, kc), (rp_, fp, kp) = out["cuda"], out["cpu"]
    worst = 0.0
    for i, name in enumerate(("E", "B", "J", "rho")):
        a, b = rc[i].cpu(), rp_[i]
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)
        assert err < 1e-5, (name, err)
        worst = max(worst, err)
    assert fp > 0 and abs(fc - fp) <= 1e-5 * abs(fp), (fc, fp)
    for n in kp:
        assert abs(kc[n] - kp[n]) <= 1e-5 * abs(kp[n]), (n, kc[n], kp[n])
    log(14 if packed else 7,
        f"small hole_boring deck (nx 800, npc 10 a species, {steps} steps"
        f"{', tpu: packed_fused: 1' if packed else ''}; launches "
        f"{launches}), card vs CPU: fields within {worst:.2e} of their "
        f"scale, field energy {fc:.6e} vs {fp:.6e} J, electrons "
        f"{kc['electron']:.6e} vs {kp['electron']:.6e} J, ions "
        f"{kc['ion']:.6e} vs {kp['ion']:.6e} J")
    return launches


class _Echo(io.StringIO):
    """Keeps what is written to it and echoes it to the process's
    standard output."""

    def write(self, s):
        sys.__stdout__.write(s)
        sys.__stdout__.flush()
        return super().write(s)


def hb_cli_drive(tmp: Path, smi: str, outputs=3, profile=None):
    """Phase 8, this slice's main path: the full-width hole_boring deck
    through the user's entry point, over ``outputs`` output blocks (with
    ``profile``, the CLI's ``--profile`` of the last block into that
    directory).  Returns the launches of each kernel form."""
    from opal_tpu_torch import cli, constants as const
    from opal_tpu_torch.config import Config

    src = (ROOT / "examples" / "hole_boring.yaml").read_text()
    # ended 0.5 um/c after the pulse's peak meets the slab's front, to
    # leave room for the later phases in the time limit
    for a, b in HB_CLI_EDITS + (("n_outputs: 30", f"n_outputs: {outputs}"),
                                ("end: -8.0e-6/c", "end: -8.5e-6/c")):
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    run = tmp / "hole_boring"
    run.mkdir()
    (run / "deck.yaml").write_text(src)
    cfg = Config.from_string(src)
    cfg.with_context("constants")
    dt = 0.95 * cfg.read_f64("control", "dx") / const.SPEED_OF_LIGHT
    total = int((cfg.read_f64("control", "end")
                 - cfg.read_f64("control", "start")) / dt)
    steps = outputs * (total // outputs)
    argv = [str(run / "deck.yaml")]
    if profile is not None:
        argv += ["--profile", str(profile)]

    # a profiled drive echoes the CLI's progress lines as they come
    so, se = (_Echo(), _Echo()) if profile else (io.StringIO(), io.StringIO())
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched()
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron, ion]" in out, out
    if profile is not None:
        log(8, [l for l in err.splitlines() if l.startswith("profile:")][0])
    assert "buffer-overflow particle losses" not in err, err
    assert launches == {"vay": steps, "boris": steps}, (launches, steps)
    ions = []
    for i in range(outputs + 1):
        g = np.loadtxt(run / f"{i}_grid.dat")
        assert g.shape == (20_000, 11) and np.isfinite(g).all()
        e = {k: float(v) for k, v in (l.split() for l in
             (run / f"{i}_energy.dat").read_text().splitlines())}
        assert all(math.isfinite(v) for v in e.values()), e
        assert e["electrons"] > 0 and e["ions"] > 0, e
        ions.append(e["ions"])
        for stem in ("electron_x-px", "electron_x-p_perp", "electron_py-pz",
                     "carbon_x-px", "carbon_x-p_perp", "carbon_py-pz"):
            assert (run / f"{i}_{stem}.fits").stat().st_size % 2880 == 0
    assert ions[-1] > ions[0], ions
    banner = out.splitlines()[0]
    log(8, f"python -m opal_tpu_torch hole_boring.yaml (nx 20000, npc 100 "
           f"a species, slab -9..-4 um, {steps} steps, {outputs} outputs): "
           f"'{banner}' '{out.splitlines()[1]}', launches vay "
           f"{launches['vay']} boris {launches['boris']}, no losses, "
           f"outputs finite, ion kinetic energy x{ions[-1] / ions[0]:.4g} "
           f"({ions[0]:.6e} -> {ions[-1]:.6e} J); {steps / wall:.1f} "
           f"steps/s over {wall:.1f} s incl. set-up and output dumps, on "
           f"{smi}")
    return launches


#: tests/test_qed_burst.py's deck (a colliding-beams crossing inside an
#: nx 800 box, 1200 electrons, 526 steps) at one device, with blocks of
#: 512 rows so that the kernel serves its 2048-row electron buffer
QED_SMALL = """\
control:
 dx: 0.01*micro
 nx: 800
 xmin: -1*micro
 start: -2.0e-6/c
 end: 3.0e-6/c
 current_deposition: false
 n_outputs: 2
qed:
 photon_emission: true
 photon_absorption: false
electrons:
 npc: 12
 ne: S * a0 * critical(omega) * step(x,xmin,xmax)
 ux: -1000.0 * (1.0 + 0.01 * nrand)
 uy: 0.0
 uz: 0.0
 output: [energy]
ions:
 npc: 0
photons:
 npc: 0
 output: [energy, x:energy]
laser:
 Ey: >
  (a0*m*c*omega/e)
  *sin(omega*(t-x/c))
  *exp(-ln(2.0)*(omega*(t-x/c))^2/(2.0*pi^2*ncycles^2))
 Ez: 0.0
constants:
 S: 1.0e-6
 a0: 20.0
 omega: 2*pi*c/0.8e-6
 ncycles: 4.0
 xmin: 4.0 * micro
 xmax: 5.0 * micro
tpu:
 photon_capacity: 32768
 fused_block: 512
"""
#: the laser's peak field at a0 20 and 0.8 um (a0 m c omega / e), V/m,
#: and its magnetic field, T
CB_E, CB_B = 8.0e13, 2.7e5


def colliding_beams_kernels():
    """Phase 9: the forms of this slice against their plain versions on
    the colliding_beams ``--f32`` initial beam (50,000 electrons in
    75,776 rows, sorted), under random fields of laser strength: the
    main path's full Vay form without the deposit (also with the work
    increment of a mixed-precision deck run with ``tpu: fused_pusher:
    1``), and the forms no shipped deck reaches: full Vay with the
    deposit, lite Vay without it, and lite Boris without it (carbon's
    charge and mass on the same rows).  Returns {form: (max_abs_err, ms,
    plain_ms, bound_ms, bound_by)}."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.cli import build

    sim, states, _ = build(ROOT / "examples" / "colliding_beams.yaml",
                           dtype=torch.float32, field_dtype=torch.float32,
                           device="cuda")
    st = states["electron"]
    spec = sim._fused_spec("electron")
    assert sim._fused_applicable("electron", st)
    assert (spec.block, spec.window, spec.n_rows, st.x.shape[0], spec.lite,
            spec.dep_skip, spec.work_inc) == (
                2048, 56, 4228, 75_776, False, True, False), spec
    ion = dict(pusher="boris", work_out=False, lite=True,
               charge=6.0 * const.ELEMENTARY_CHARGE,
               mass=12.0 * const.PROTON_MASS)
    forms = {
        "vay_full_dep_skip": spec,
        "vay_full_dep_skip+work_inc": spec._replace(work_inc=True),
        "vay_full": spec._replace(dep_skip=False),
        "vay_dep_skip": spec._replace(lite=True),
        "boris_dep_skip": spec._replace(**ion),
    }
    out = {label: kernel_vs_plain(f"colliding_beams {label}", st, sp,
                                  fields_seed=3, e_scale=CB_E,
                                  b_scale=CB_B, phase=9)
           for label, sp in forms.items()}
    del sim, states
    torch.cuda.empty_cache()
    return out


def _energy_file(path):
    return {k: float(v) for k, v in
            (l.split() for l in path.read_text().splitlines())}


def qed_card_vs_cpu(tmp: Path):
    """Phase 10: the small emission deck at ``--f32`` stepped on the card
    (the full Vay form without the deposit) and on the CPU (its plain
    version) with the same host-made draws.  The push columns round
    alike, but the emission rate's exp and log may differ by an ulp
    between the two, so an electron may cross its optical depth a step
    earlier or later; each electron keeps its own draws (the sampler's
    rows are the buffer rows here), so that moves only its own photon.
    Photon counts agree within 1%, the field, electron and photon
    energies within 1e-3 of their scale."""
    from opal_tpu_torch.cli import build
    from opal_tpu_torch.interactions import emission_widths

    (tmp / "qed_small").mkdir()
    deck = tmp / "qed_small" / "deck.yaml"
    deck.write_text(QED_SMALL)
    out, draws = {}, None
    for dev in ("cuda", "cpu"):
        sim, sp, rp = build(deck, dtype=torch.float32,
                            field_dtype=torch.float32, device=dev)
        assert sim._fused_applicable("electron", sp["electron"])
        steps = rp["total_steps"]
        if draws is None:
            m, mi = emission_widths(sim.options, sp["electron"].x.shape[0])
            rng = np.random.default_rng(7)
            draws = [dict(r1=rng.random(m, np.float32),
                          r2=rng.random(m, np.float32),
                          r3=rng.random(m, np.float32),
                          tau=rng.exponential(size=m).astype(np.float32),
                          tau_abs=rng.exponential(size=mi).astype(np.float32),
                          tau_st=rng.exponential(size=mi).astype(np.float32))
                     for _ in range(steps)]
        reset_launches()
        res = sim.run(*sim.init_fields(), sp, rp["tstart"],
                      sim.zero_counters(), steps, rng=draws.__getitem__)
        if dev == "cuda":
            assert launched() == {"vay_full_dep_skip": steps}, launched()
        lost = {k: int(v) for k, v in res[6].items() if k != "qed_deferred"}
        assert not any(lost.values()), lost
        out[dev] = dict(
            photons=int(res[4]["photon"].alive.sum()),
            field=sim.em_field_energy(res[0], res[1]),
            electrons=sim.total_kinetic_energy("electron", res[4]["electron"]),
            photon_J=sim.total_kinetic_energy("photon", res[4]["photon"]),
        )
    c, h = out["cuda"], out["cpu"]
    assert h["photons"] > 100 and abs(c["photons"] - h["photons"]) <= \
        0.01 * h["photons"], (c, h)
    for k in ("field", "electrons", "photon_J"):
        assert abs(c[k] - h[k]) <= 1e-3 * abs(h[k]), (k, c, h)
    log(10, f"small emission deck (nx 800, 1200 electrons, {steps} steps, "
            f"--f32, host-made draws), card vs CPU: photons {c['photons']} "
            f"vs {h['photons']}; field energy {c['field']:.6e} vs "
            f"{h['field']:.6e} J, electrons {c['electrons']:.6e} vs "
            f"{h['electrons']:.6e} J, photons {c['photon_J']:.6e} vs "
            f"{h['photon_J']:.6e} J (bar 1e-3 relative, counts 1%)")


#: the deck cut for a profile of the crossing: the run ends 0.5 um/c
#: after the pulse's peak meets the beam (2,368 steps), over 48 output
#: blocks, so the profiled last one (49 steps) holds the peak
CB_PROFILE_EDITS = (("end: 6.0e-6/c", "end: -1.5e-6/c"),
                    ("n_outputs: 5", "n_outputs: 48"))


def cb_cli_drive(tmp: Path, smi: str, profile=None):
    """Phase 11, this slice's main path: ``examples/colliding_beams.yaml
    --f32`` at full width through the user's entry point (with
    ``profile``, cut to the crossing and the last block profiled into
    that directory).  Returns the launches of each kernel form."""
    from opal_tpu_torch import cli

    src = (ROOT / "examples" / "colliding_beams.yaml").read_text()
    for a, b in CB_PROFILE_EDITS if profile is not None else ():
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    run = tmp / "colliding_beams"
    run.mkdir()
    (run / "deck.yaml").write_text(src)
    argv = [str(run / "deck.yaml"), "--f32"]
    if profile is not None:
        argv += ["--profile", str(profile)]
    so, se = (_Echo(), _Echo()) if profile else (io.StringIO(), io.StringIO())
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se), \
            no_plain_qed():
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched()
    qed = qed_launched()
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron]" in out, out
    if profile is not None:
        log(11, [l for l in err.splitlines() if l.startswith("profile:")][0])
    assert "buffer-overflow particle losses" not in err, err
    n_out = int(out.splitlines()[-1].split()[1])
    steps = launches.get("vay_full_dep_skip", 0)
    assert launches == {"vay_full_dep_skip": steps} and steps > 0, launches
    # emission only: K3 a sampled step, no absorption walk
    assert qed["invert_many"] > 0 and qed["absorb_walk"] == 0, qed
    energies = []
    for i in range(n_out + 1):
        g = np.loadtxt(run / f"{i}_grid.dat")
        assert g.shape == (4000, 11) and np.isfinite(g).all()
        e = _energy_file(run / f"{i}_energy.dat")
        assert all(math.isfinite(v) for v in e.values()) and e["electrons"] > 0
        energies.append(e)
    for stem in ("photon_x", "photon_energy", "photon_energy_energy_log",
                 "photon_longitude-latitude",
                 "photon_longitude-latitude_energy", "electron_x-chi",
                 "electron_x-energy"):
        f = run / f"{n_out}_{stem}.fits"
        assert f.stat().st_size % 2880 == 0, f
    e0, e1 = energies[0], energies[-1]
    assert e0["photons"] == 0.0 and e1["photons"] > 0.0, (e0, e1)
    backlog = [l for l in err.splitlines() if "backlog" in l]
    log(11, f"python -m opal_tpu_torch colliding_beams.yaml --f32 (nx "
            f"4000, 50,000 electrons in 75,776 rows, {steps} steps, {n_out} "
            f"outputs): '{out.splitlines()[0]}' '{out.splitlines()[1]}', "
            f"launches {launches}, K1-K3 launches {qed}, no losses, outputs "
            f"finite, no plain QED code on the card, photon FITS "
            f"written; photons 0 -> {e1['photons']:.6e} J, electrons "
            f"{e0['electrons']:.6e} -> {e1['electrons']:.6e} J; QED backlog "
            f"notes {len(backlog)}{': ' + backlog[-1] if backlog else ''}; "
            f"{steps / wall:.1f} steps/s over {wall:.1f} s incl. set-up and "
            f"output dumps, on {smi}")
    return {**launches, **qed}


def cb_ledger(smi: str, chunk=500):
    """Phase 12: the raw-float energy ledger of the colliding_beams deck
    at the default mixed precision (the unfused push with f64
    arithmetic), as ``tools/ledger_closure.py`` computes it, through
    ``cli.build`` and ``Simulation.run`` with the CLI's generator over
    the deck's whole window.  With deposition off the laser still does
    net work on the electrons (their work column), so the radiated
    energy is the electron loss plus that work: the closure
    |electron loss + work - photon gain| / photon gain is held to
    opal_tpu's bar of 1e-5 (its ``closure_with_work``; the bare
    |electron loss - photon gain| / photon gain is ~2.4e-5 in opal_tpu
    at every precision, the laser's ~32 J, and is printed beside it).
    Returns (closure_with_work, closure)."""
    from opal_tpu_torch.cli import build

    sim, species, rp = build(ROOT / "examples" / "colliding_beams.yaml",
                             device="cuda")
    opt = sim.options
    assert not opt.fused_pusher and opt.push_f64_compute
    rng = torch.Generator(device="cuda").manual_seed(opt.seed)
    E, B, J, rho = sim.init_fields()
    counters = sim.zero_counters()
    t = rp["tstart"]

    def energies(sp):
        e = sp["electron"]
        return dict(electron=sim.total_kinetic_energy("electron", e),
                    photon=sim.total_kinetic_energy("photon", sp["photon"]),
                    work=float(torch.sum(torch.where(
                        e.alive, e.weight.double() * e.work.double(), 0.0))))

    e0 = energies(species)
    total = rp["total_steps"]
    reset_launches()
    t0 = time.perf_counter()
    done = 0
    while done < total:
        n = min(chunk, total - done)
        E, B, J, rho, species, t, counters = sim.run(
            E, B, J, rho, species, t, counters, n, rng=rng)
        done += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert not launched(), launched()
    e1 = energies(species)
    lost = {k: int(v) for k, v in counters.items() if k != "qed_deferred"}
    assert not any(lost.values()), lost
    e_loss = e0["electron"] - e1["electron"]
    gain = e1["photon"] - e0["photon"]
    work = e1["work"] - e0["work"]
    assert gain > 0, (e0, e1)
    closure = abs(e_loss - gain) / gain
    closure_w = abs(e_loss + work - gain) / gain
    log(12, f"colliding_beams.yaml at mixed precision (unfused, f64 push "
            f"arithmetic), {total} steps: electron loss {e_loss:.9e} J, "
            f"laser work on the electrons {work:.9e} J, photon gain "
            f"{gain:.9e} J; closure with the work {closure_w:.3e} (bar "
            f"1e-5), without it {closure:.3e}; deferred "
            f"{int(counters['qed_deferred'])}; {total / wall:.1f} steps/s "
            f"over {wall:.1f} s, on {smi}")
    assert closure_w < 1e-5, (closure_w, e_loss, work, gain)
    return closure_w, closure


def _random_table(spec, dev, fields_seed, e_scale, b_scale):
    """An (n_rows, 8) field table of random E ~ ``e_scale`` V/m and B ~
    ``b_scale`` T over the slab's rows."""
    from opal_tpu_torch.ops import fused as F

    n_slab = spec.n_rows - 2 * F.PAD
    g = torch.Generator(device="cpu").manual_seed(fields_seed)
    E = (e_scale * torch.randn(n_slab, 3, generator=g)).to(dev)
    B = (b_scale * torch.randn(n_slab, 3, generator=g)).to(dev)
    return F.make_eb_rows(E, B)


def packed_vs_plain(label, ps, spec, fields_seed=1, e_scale=10.0,
                    b_scale=1e-8, phase=13):
    """Phase 13 (or ``phase``), one form at one shape: kernel B2 against
    its plain version on one sorted packed state and random E/B: the hot
    matrix,
    the aux matrix and the next anchors bitwise, the slab within 1e-5 of
    its scale, no slab without the deposit.  Returns (max_abs_err, ms,
    plain_ms, bound_ms, bound_by, call_ms), timed as
    :func:`kernel_vs_plain` times B1."""
    from opal_tpu_torch.ops import fused as F

    eb = _random_table(spec, ps.h.device, fields_seed, e_scale, b_scale)
    anchors = F.block_anchors(spec, ps.h[:, 0].reshape(-1))
    args = (spec, anchors, ps.h, ps.weight, eb)
    Hk, Ak, ok, ak = F.fused_push_deposit_packed(*args)
    Hr, Ar, orf, ar = F.fused_push_deposit_packed_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(ak, ar), "next anchors differ"
    assert torch.equal(Hk, Hr), "hot matrix differs from the plain version"
    assert torch.equal(Ak, Ar), "aux matrix differs from the plain version"
    if spec.dep_skip:
        assert ok is None and orf is None
        slab_err, slab_txt = 0.0, "no slab (deposit skipped)"
    else:
        slab_err = (ok - orf).abs().max().item()
        scale = orf.abs().max().item()
        assert scale > 0 and slab_err <= 1e-5 * scale, (slab_err, scale)
        slab_txt = f"slab max |err| {slab_err:.3e} (max |slab| {scale:.3e})"
    ms = device_ms(lambda: F.fused_push_deposit_packed(*args))
    call_ms = cuda_ms(lambda: F.fused_push_deposit_packed(*args))
    plain_ms = cuda_ms(lambda: F.fused_push_deposit_packed_reference(*args))
    n = ps.weight.numel()
    n_alive = int((ps.weight > 0).sum())
    n_miss = int(Ak[:, 3].sum().item())
    bound_ms, bound_by = bound(spec, n, n_alive - n_miss, packed=True)
    log(phase, f"{label} ({F.packed_form_name(spec)}): rows {n} (alive "
            f"{n_alive}), block {spec.block}, window {spec.window}, n_rows "
            f"{spec.n_rows}: H, A and anchors bitwise equal; {slab_txt}; "
            f"misses {n_miss}; kernel {ms:.4f} ms of device time (20 calls "
            f"back to back), the wrapper's call {call_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (medians of 20), bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return slab_err, ms, plain_ms, bound_ms, bound_by, call_ms


def b1_full_vay_ms(label, st, spec, fields_seed=1, e_scale=10.0,
                   b_scale=1e-8):
    """B1's full Vay form (the work column accumulated, prev_x gh chi
    written: B2's outputs in the column layout) on the same rows: its
    device time, printed beside B2's."""
    from opal_tpu_torch.ops import fused as F

    spec = spec._replace(lite=False, work_out=True, work_inc=False,
                         pusher="vay")
    eb = _random_table(spec, st.x.device, fields_seed, e_scale, b_scale)
    # the f32 work column (a mixed-precision deck keeps an f64 one)
    args = (spec, F.block_anchors(spec, st.cell), st.cell, st.x, st.y,
            st.z, st.ux, st.uy, st.uz, st.gamma, st.weight,
            st.work.to(torch.float32), eb)
    ms = device_ms(lambda: F.fused_push_deposit(*args))
    log(13, f"{label}: B1's full Vay form ({F.form_name(spec)} with the "
            f"work column) on the same rows, kernel {ms:.4f} ms of device "
            f"time")
    return ms


def packed_kernels():
    """Phase 13: the four forms of kernel B2 against their plain version,
    each at the shapes of the decks that run it: the Vay forms at the
    bench shape (10,485,760 rows, block 8192, window 12), the Vay form
    at the two_stream CLI shape (155,648 rows, block 2048, window 40),
    and at the hole_boring shape (753,664 rows a species, block 2048,
    window 56, n_rows 20,228) the electrons through the Vay forms and
    the carbon ions through the Boris forms; B1's full Vay time on the
    same electron rows beside them.  Returns {(shape, form): result of
    :func:`packed_vs_plain`}."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.cli import build
    from opal_tpu_torch.grid import HALO, GridGeometry
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    out = {}
    for shape, nx, npc, cap, block, window, forms in (
        ("bench", BENCH["nx"], BENCH["particles"] // BENCH["nx"],
         10_485_760, BENCH["block"], BENCH["window"],
         ("vay_packed", "vay_packed_dep_skip")),
        ("two_stream CLI", 1000, 100, 155_648, 2048, 40, ("vay_packed",)),
    ):
        geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
        st = sort_state(two_stream_state(geom, npc, cap, dt, "cuda"), nx)
        spec = F.FusedSpec(
            block=block, window=window, n_rows=nx + 2 * HALO + 2 * F.PAD,
            dx=dx, dt=dt, charge=const.ELECTRON_CHARGE,
            mass=const.ELECTRON_MASS, row_off=HALO + F.PAD,
        )
        b1_full_vay_ms(f"{shape} shape", st, spec)
        ps = F.pack_fused(st, block)
        for form in forms:
            sp = spec._replace(dep_skip=form.endswith("dep_skip"))
            out[shape, form] = packed_vs_plain(f"{shape} shape", ps, sp)
        del st, ps
        torch.cuda.empty_cache()

    sim, states, _ = build(ROOT / "examples" / "hole_boring.yaml",
                           device="cuda")
    for name, st in states.items():
        spec = sim._fused_spec(name)
        assert (spec.block, spec.window, spec.n_rows, st.x.shape[0]) == (
            2048, 56, 20_228, 753_664), spec
        st = sort_state(st, sim.geom.n_loc)
        if name == "electron":
            b1_full_vay_ms("hole_boring shape", st, spec, 2, 1e13, 3e4)
        ps = F.pack_fused(st, spec.block)
        for dep_skip in (False, True):
            sp = spec._replace(dep_skip=dep_skip)
            out["hole_boring", F.packed_form_name(sp)] = packed_vs_plain(
                f"hole_boring {name} shape", ps, sp, fields_seed=2,
                e_scale=1e13, b_scale=3e4)
    del sim, states
    torch.cuda.empty_cache()
    return out


def bench_twin(smi: str):
    """Phase 15: ``python -m opal_tpu_torch.bench`` at its defaults
    (bench.py's deck: 8*2**20 electrons, nx 1024, three blocks of 1024
    steps), with and without ``--packed``, and ``--packed
    --no-deposition`` cut to blocks of 64 steps: each prints its one
    JSON line with no loss, and every step of the three blocks launches
    the layout's kernel form once.  Returns ({form: launches}, {form:
    pushes/s})."""
    from opal_tpu_torch import bench

    launches, values = {}, {}
    for argv, form, steps in (([], "vay", 1024),
                              (["--packed"], "vay_packed", 1024),
                              (["--packed", "--no-deposition", "--steps",
                                "64"], "vay_packed_dep_skip", 64)):
        so, se = io.StringIO(), io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = bench.main(argv + ["--verbose"])
        torch.cuda.synchronize()
        got = launched()
        assert rc == 0, (rc, so.getvalue(), se.getvalue())
        lines = so.getvalue().strip().splitlines()
        assert len(lines) == 1, lines
        line = json.loads(lines[0])
        assert "error" not in line and line["value"] > 0, line
        assert got == {form: 3 * steps}, got
        launches[form] = got[form]
        values[form] = line["value"]
        log(15, f"python -m opal_tpu_torch.bench {' '.join(argv)}: "
                f"{lines[0]}; {se.getvalue().strip()}; launches of {form} "
                f"{got[form]}; on {smi}")
    return launches, values


#: phase 17's row orders, each breaking the deposit's fast path (one
#: tile row a warp)
STRESS_ORDERS = ("shuffled within each block", "one cell a block",
                 "two cells alternating row by row",
                 "dead and misfit rows interleaved")


def stress_state(st, block, window, order, seed=17):
    """The sorted state ``st`` with its rows reordered or changed within
    each block of ``block`` rows, as :data:`STRESS_ORDERS` names them: a
    random permutation of each block; every row of a block moved to the
    cell of the block's middle row, or to it and the next cell in turn;
    every 5th row dead (weight 0) and every 7th moved ``window + 4``
    cells up, past its block's window (a miss)."""
    n = st.x.shape[0]
    nblk = n // block
    dev = st.x.device
    if order == STRESS_ORDERS[0]:
        g = torch.Generator(device="cpu").manual_seed(seed)
        perm = torch.argsort(torch.rand(nblk, block, generator=g), dim=1)
        perm = (perm + block * torch.arange(nblk)[:, None]).reshape(-1)
        perm = perm.to(dev)
        return dataclasses.replace(
            st, **{k: v[perm] for k, v in st.columns().items()})
    r = torch.arange(n, device=dev)
    mid = st.cell.view(nblk, block)[:, block // 2].repeat_interleave(block)
    if order == STRESS_ORDERS[1]:
        return dataclasses.replace(st, cell=mid)
    if order == STRESS_ORDERS[2]:
        return dataclasses.replace(st, cell=(mid + r % 2).to(st.cell.dtype))
    dead = r % 5 == 3
    cell = torch.where(r % 7 == 1, st.cell + (window + 4), st.cell)
    return dataclasses.replace(
        st, cell=cell.to(st.cell.dtype), alive=st.alive & ~dead,
        weight=torch.where(dead, 0.0, st.weight))


def stress_kernels():
    """Phase 17: the deposit on row orders that break its fast path.  At
    the bench shape and the two_stream CLI shape, for each of
    :data:`STRESS_ORDERS`, and at the CLI shape also with blocks of 128
    rows (half the CTA's threads without a row): B1's lite Vay form and
    B2's ``vay_packed`` against their plain versions on the reordered
    rows, with the checks and times of phases 3 and 13 (push columns,
    H, A, miss and anchors bitwise, the slab within 1e-5 of its scale).
    Returns {(shape, case, form): result of :func:`kernel_vs_plain` or
    :func:`packed_vs_plain`}."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.grid import HALO, GridGeometry
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    out = {}
    for shape, nx, npc, cap, block, window in (
        ("bench", BENCH["nx"], BENCH["particles"] // BENCH["nx"],
         10_485_760, BENCH["block"], BENCH["window"]),
        ("two_stream CLI", 1000, 100, 155_648, 2048, 40),
    ):
        geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
        st = sort_state(two_stream_state(geom, npc, cap, dt, "cuda"), nx)
        spec = F.FusedSpec(
            block=block, window=window, n_rows=nx + 2 * HALO + 2 * F.PAD,
            dx=dx, dt=dt, charge=const.ELECTRON_CHARGE,
            mass=const.ELECTRON_MASS, row_off=HALO + F.PAD,
        )
        cases = [(order, spec, stress_state(st, block, window, order))
                 for order in STRESS_ORDERS]
        if shape == "two_stream CLI":
            cases.append(("blocks of 128 rows", spec._replace(block=128), st))
        for case, sp, rows in cases:
            label = f"{shape} shape, {case}"
            out[shape, case, "vay"] = kernel_vs_plain(
                label, rows, sp, phase=17, sort=False)
            out[shape, case, "vay_packed"] = packed_vs_plain(
                label, F.pack_fused(rows, sp.block), sp, phase=17)
        del st, cases
        torch.cuda.empty_cache()
    return out


def cross_sections_card_vs_cpu():
    """Phase 18: ``airy_ai`` over x in [-1, 60] (the series, the three
    fitted quadrature branches and both invalid ends) and
    ``pair_cross_sections`` on 2**16 pairs (photons and electrons from
    co- to counter-propagating, chi 1e-3..5, some pairs forbidden for
    stimulated emission, some with a non-positive chi), on the card
    against the CPU at f64: the valid masks equal, the values within
    1e-12 relative (below 1e-290, within 1e-300).  Returns the largest
    relative difference."""
    from opal_tpu_torch.qed.airy import airy_ai
    from opal_tpu_torch.qed.cross_sections import pair_cross_sections

    rng = np.random.default_rng(3)
    n = 1 << 16
    x = np.concatenate([np.linspace(-1, 0.999, 4096),
                        np.linspace(1, 60, 60_000)])
    g = 10 ** rng.uniform(0.2, 2.5, n)
    th = rng.uniform(0, math.pi, n)
    pm = np.sqrt(g**2 - 1)
    k0 = 10 ** rng.uniform(-2, 2.5, n)
    args = (np.stack([k0, -k0 * np.cos(th), k0 * np.sin(th), 0 * k0], 1),
            np.stack([g, -pm, 0 * g, 0 * g], 1),
            10 ** rng.uniform(-3, 0.7, n), 10 ** rng.uniform(-3, 0.7, n))
    args[2][:64] = 0.0
    args[3][64:128] = -0.5

    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        big = b.abs() > 1e-290
        assert ((a - b).abs()[~big] <= 1e-300).all()
        return float(((a - b).abs() / b.abs().clamp(min=1e-290))[big].max())

    on = lambda *a: [torch.from_numpy(v).cuda() for v in a]
    off = lambda *a: [torch.from_numpy(v) for v in a]
    (vc, okc), (vh, okh) = airy_ai(*on(x)), airy_ai(*off(x))
    assert torch.equal(okc.cpu(), okh)
    errs = {"airy_ai": rel(vc, vh)}
    for name, c, h in zip(("sigma_abs", "sigma_st"),
                          pair_cross_sections(*on(*args)),
                          pair_cross_sections(*off(*args))):
        assert torch.equal(c.cpu() > 0, h > 0), name
        assert int((h > 0).sum()) > n // 8, name
        errs[name] = rel(c, h)
    worst = max(errs.values())
    log(18, f"airy_ai on {x.size} points in [-1, 60] and "
            f"pair_cross_sections on {n} pairs, card vs CPU at f64: masks "
            "equal, largest relative difference " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items()) + " (bar 1e-12)")
    assert worst <= 1e-12, errs
    return worst


#: phase 19's pairing modes (absorb's presorted/bracketed flags)
ABSORB_MODES = {"sort": (False, False), "presorted": (True, False),
                "bracketed": (False, True)}


def forced_absorb_state(mode, n_cells=4096, seed=19):
    """The forced-event state of ``tests/test_torch_absorption.py``
    scaled up: 1..30 electrons in each of ``n_cells`` cells (a sixteenth
    of them with 80, past the candidate bound of 64), weights 1e10-2e10,
    and 1.5 photons a cell of 2.5, whose optical depths are a random
    share of their pairs' summed probabilities (an eighth 1e-30: they
    fire on their first candidate), so that both kinds of event fire in
    many cells.  ``mode`` arranges the electron rows as
    :data:`ABSORB_MODES` needs: cell-sorted with the dead tail, sorted
    with rows of adjacent cells swapped, or shuffled.  Returns numpy
    column dicts (electrons, photons) at f64."""
    from opal_tpu_torch.qed.cross_sections import pair_cross_sections
    from opal_tpu_torch.species import SpeciesSpec, _empty_fields

    rng = np.random.default_rng(seed)
    per = rng.integers(1, 31, n_cells)
    per[rng.permutation(n_cells)[: n_cells // 16]] = 80
    cells = np.repeat(np.arange(n_cells), per)
    n_a = cells.size
    n_e = n_a + n_a // 8
    e = _empty_fields(SpeciesSpec.electron(), n_e, np.float64)
    g = rng.uniform(5.0, 50.0, n_a)
    ang = rng.normal(0, 0.3, (2, n_a))
    pm = np.sqrt(g**2 - 1)
    e["cell"][:n_a], e["cell"][n_a:] = cells, n_cells - 1
    e["x"][:n_a] = rng.uniform(0, 1, n_a)
    e["ux"][:n_a] = -pm * np.cos(ang[0])
    e["uy"][:n_a] = pm * np.sin(ang[0]) * np.cos(ang[1])
    e["uz"][:n_a] = pm * np.sin(ang[0]) * np.sin(ang[1])
    e["gamma"][:n_a] = g
    e["chi"][:n_a] = rng.uniform(0.5, 3.0, n_a)
    e["weight"][:n_a] = rng.uniform(1e10, 2e10, n_a)
    e["alive"][:n_a] = True

    n_p = 3 * n_cells // 2
    ph = _empty_fields(SpeciesSpec.photon(), 5 * n_cells // 2, np.float64)
    pc = rng.integers(0, n_cells, n_p)
    k0 = 10 ** rng.uniform(-1.3, 0.5, n_p)
    th = rng.normal(0, 0.3, n_p)
    chi_g = rng.uniform(0.1, 1.5, n_p)
    ph["cell"][:n_p], ph["x"][:n_p] = pc, rng.uniform(0, 1, n_p)
    ph["prev_x"][:n_p] = ph["x"][:n_p]
    ph["ux"][:n_p], ph["uy"][:n_p] = -k0 * np.cos(th), k0 * np.sin(th)
    ph["gamma"][:n_p], ph["chi"][:n_p] = k0, chi_g
    ph["weight"][:n_p] = rng.uniform(1e10, 2e10, n_p)
    ph["birth_time"][:n_p] = 0.0
    ph["pol"][:n_p] = rng.normal(size=(n_p, 4))
    ph["basis"][:n_p] = rng.normal(size=(n_p, 6))
    ph["alive"][:n_p] = True
    # each photon's summed pair probabilities over its cell's electrons
    start = np.concatenate([[0], np.cumsum(per)])
    k4 = torch.from_numpy(np.stack([k0, -k0 * np.cos(th), k0 * np.sin(th),
                                    0 * k0], 1))
    p4 = torch.from_numpy(np.stack([e["gamma"], e["ux"], e["uy"], e["uz"]],
                                   1)[:n_a])
    tot = np.zeros((2, n_p))
    for j in range(80):  # the j-th electron of each photon's cell
        has = per[pc] > j
        idx = np.where(has, start[pc] + j, 0)
        sa, ss = pair_cross_sections(
            k4, p4[idx], torch.from_numpy(chi_g),
            torch.from_numpy(e["chi"][idx]))
        w = np.where(has, e["weight"][idx] * 0.95, 0.0)
        tot += w * np.stack([sa.numpy(), ss.numpy()])
    ph["tau_abs"][:n_p] = rng.uniform(0.0, 1.6, n_p) * tot[0]
    ph["tau_st"][:n_p] = np.where(tot[1] > 0,
                                  rng.uniform(0.0, 1.6, n_p) * tot[1], 1e30)
    ph["tau_abs"][: n_p // 8] = 1e-30

    order = np.arange(n_e)
    if mode == "bracketed":
        for i in np.nonzero(cells[1:] != cells[:-1])[0][::2]:
            order[i], order[i + 1] = order[i + 1], order[i]
    elif mode == "sort":
        order = rng.permutation(n_e)
    e = {k: (None if v is None else v[order]) for k, v in e.items()}
    return e, ph


def absorb_card_vs_cpu():
    """Phase 19: one ``absorb`` call on the forced-event state (4096
    cells, ~65k electrons, 6144 photons) on the card and on the CPU with
    the same draws (made on the host at the shapes of opal_tpu's arrays),
    in the three pairing modes with the active-set compaction on (2048 of
    the photons, so some defer) and off, and with the compaction on
    without the per-cell candidate table (the walk's kernel K1 then reads
    the electrons' segment rows), stimulated emission and the
    event records on and the event capacity at 1024: equal counts (lost,
    deferred, photons alive, absorbed and stimulated events), equal
    event kinds, cells and alive masks, and the event records, the
    depths, the momenta and every other f64 column within 1e-12 of its
    scale (the kicks of two photons on one electron add in another order
    on the card: ROADMAP C4).  Returns ({case: (events, card ms, CPU
    ms)}, the K1 and K2 calls of the bracketed case with the compaction
    on the per-cell table, for phase 29: they fire events)."""
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.grid import GridGeometry

    geom = GridGeometry(nx=4096, dx=1e-6, xmin=0.0, n_devices=1)
    out = {}
    table_bytes = I.CAND_TABLE_MAX_BYTES
    cases = [(mode, compact, True) for mode in ABSORB_MODES
             for compact in (2048, 0)]
    cases += [(mode, 2048, False) for mode in ABSORB_MODES]
    captured = {}
    for mode, compact, cell_table in cases:
        presorted, bracketed = ABSORB_MODES[mode]
        e, ph = forced_absorb_state(mode)
        opt = _absorb_opts(compact)
        sim = SimpleNamespace(geom=geom, options=opt)
        draws = _absorb_draws(opt, len(e["x"]), len(ph["x"]), 1, 5)
        res, ms = {}, {}
        for dev in ("cuda", "cpu"):
            sp = {"electron": state_from_numpy(e, device=dev),
                  "photon": state_from_numpy(ph, device=dev)}
            I.absorb.events.update(absorbed=0, stimulated=0)
            # without the per-cell table the walk reads the segment
            # rows of the electrons' table (K1's other source)
            I.CAND_TABLE_MAX_BYTES = table_bytes if cell_table else 0
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            keep = (dev == "cuda" and cell_table and compact
                    and mode == "bracketed")
            try:
                with capture_qed(captured if keep else {}):
                    r = I.absorb(sim, sp, 1e-15, draws, presorted=presorted,
                                 bracketed=bracketed)
            finally:
                I.CAND_TABLE_MAX_BYTES = table_bytes
            if dev == "cuda":
                torch.cuda.synchronize()
            ms[dev] = (time.perf_counter() - t0) * 1e3
            res[dev] = (_absorb_columns(r), dict(I.absorb.events))
        (rc, evc_c), (rh, evc_h) = res["cuda"], res["cpu"]
        assert evc_c == evc_h, (evc_c, evc_h)
        assert evc_h["absorbed"] > 100 and evc_h["stimulated"] > 10, evc_h
        assert rh[2] > 0  # truncated cells, past the capacities
        worst = _worst(rc, rh)
        label = (f"{mode}, "
                 f"{'compaction 2048' if compact else 'whole buffer'}"
                 f"{'' if cell_table else ', segment rows'}")
        log(19, f"absorb on the forced-event state ({label}): "
                f"{evc_h['absorbed']} absorbed and {evc_h['stimulated']} "
                f"stimulated events on both, deferred {rh[2]}, lost "
                f"{rh[1]}; records, depths, momenta and every column "
                f"within {worst:.3e} of their scale (bar 1e-12); card "
                f"{ms['cuda']:.1f} ms, CPU {ms['cpu']:.1f} ms")
        assert worst <= 1e-12, (label, worst)
        out[label] = (evc_h, ms["cuda"], ms["cpu"])
    return out, captured


def _absorb_draws(opt, n_e, n_ph, world, seed, dtype=np.float64):
    """Host-made draws of one ``absorb`` call at the shapes of opal_tpu's
    arrays (``interactions.absorb_widths``)."""
    from opal_tpu_torch import interactions as I

    nb, nw, evc = I.absorb_widths(opt, n_e, n_ph, world)
    rng = np.random.default_rng(seed)
    return dict(abs_rot=int(rng.integers(n_ph)),
                abs_r=rng.random((nb, nw)).astype(dtype),
                abs_exp=rng.exponential(size=(nb, 2, nw)).astype(dtype),
                abs_tau_abs=rng.exponential(size=evc).astype(dtype),
                abs_tau_st=rng.exponential(size=evc).astype(dtype))


def _absorb_opts(compact):
    """Phase 19's options: 64 candidates in passes of 32, the active-set
    compaction at ``compact`` photons (0: off), the event capacity at
    1024, the event records on."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.sim import SimOptions

    return SimOptions(
        dt=0.95 * 1e-6 / const.SPEED_OF_LIGHT, photon_absorption=True,
        absorption_candidates=64, absorption_block=32,
        absorption_active_capacity=compact, absorption_event_capacity=1024,
        extra_absorption_output=True, extra_stimulated_emission_output=True)


def _absorb_columns(res):
    """Host copies of one ``absorb`` result: (columns by species, lost,
    deferred, records and mask)."""
    from opal_tpu_torch.convert import to_numpy

    return ({n: to_numpy(res[0][n]) for n in ("electron", "photon")},
            int(res[1]), int(res[2]), to_numpy(res[3]))


def _worst(a, b) -> float:
    """The largest difference of two :func:`_absorb_columns` over their
    floating columns and logged records, relative to each one's scale;
    the integer and boolean columns, counts, masks and event kinds must
    be equal."""
    (ca, la, da, (ra, wa)), (cb, lb, db, (rb, wb)) = a, b
    assert (la, da) == (lb, db), ((la, da), (lb, db))
    assert np.array_equal(wa, wb)
    assert np.array_equal(ra[wa, 13], rb[wb, 13])
    worst = _rel_diff(torch.from_numpy(ra[wa]), torch.from_numpy(rb[wb]))
    for name in ca:
        for col, v in cb[name].items():
            if v.dtype.kind in "bi":
                assert np.array_equal(ca[name][col], v), (name, col)
            else:
                worst = max(worst, _rel_diff(torch.from_numpy(ca[name][col]),
                                             torch.from_numpy(v)))
    return worst


def _rel_diff(a, b):
    """max |a - b| over the finite entries, over max |b| there; the
    infinite entries (dead rows' depths) must be equal."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin)
    assert torch.equal(a[~fin], b[~fin])
    if not fin.any():
        return 0.0
    scale = float(b[fin].abs().max())
    return float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-300)


def full_deposit_kernels():
    """Phase 20: kernel B1's full Vay form with the deposit against its
    plain version at the shapes that now run it: the ``bench --qed``
    deck at 2,097,152 particles (2,621,440 rows over nx 16,384, block
    2048, window 24) under random fields of laser strength, and the
    ``bench --no-lite`` deck (the bench shape: 10,485,760 rows over nx
    1024, block 8192, window 12).  Returns {shape: result of
    :func:`kernel_vs_plain`}."""
    from opal_tpu_torch import bench

    out = {}
    for label, argv, scales in (
        ("bench --qed", ["--qed", "--particles", "2097152"],
         dict(fields_seed=5, e_scale=CB_E, b_scale=CB_B)),
        ("bench --no-lite", ["--no-lite"], {}),
    ):
        args = bench._parser().parse_args(argv)
        sim, _, species, _ = bench.build(args)
        spec = sim._fused_spec("electron")
        assert (spec.lite, spec.dep_skip, spec.pusher) == (False, False, "vay")
        out[label] = kernel_vs_plain(f"{label} shape", species["electron"],
                                     spec, phase=20, **scales)
        del sim, species
        torch.cuda.empty_cache()
    return out


def qed_bench_twin(smi: str):
    """Phase 21: the bench twin's QED deck and ``--no-lite``:
    ``python -m opal_tpu_torch.bench --qed --particles 2097152`` (three
    blocks of 50 steps through the full Vay form with the deposit), the
    same with ``--no-absorption``, and ``--no-lite`` at the default
    8,388,608 particles cut to blocks of 256 steps.  Each prints its one
    JSON line with no loss and launches the form once a step; the QED
    runs also give the photons alive, the absorbed and stimulated events
    and the time between the two ends of each ``absorb`` call on the
    card's clock, per step, and K1-K3's launches (no plain QED code runs
    on the card).  Returns ({run: (launches, line, extra)}, the largest
    K1-K3 calls of the ``--qed`` run for phase 29)."""
    from opal_tpu_torch import bench
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch import sim as S

    real = S.absorb
    spans = []

    def timed_absorb(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real(*a, **kw)
        ev[1].record()
        spans.append(ev)
        return res

    out = {}
    captured = {}
    runs = (("bench --qed", ["--qed", "--particles", "2097152"], 3 * 50),
            ("bench --qed --no-absorption",
             ["--qed", "--no-absorption", "--particles", "2097152"], 3 * 50),
            ("bench --no-lite", ["--no-lite", "--steps", "256"], 3 * 256))
    S.absorb = timed_absorb
    try:
        for label, argv, steps in runs:
            so, se = io.StringIO(), io.StringIO()
            spans.clear()
            I.absorb.events.update(absorbed=0, stimulated=0)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with contextlib.redirect_stdout(so), \
                    contextlib.redirect_stderr(se), no_plain_qed(), \
                    capture_qed(captured if label == "bench --qed" else {}):
                rc = bench.main(argv + ["--verbose"])
            torch.cuda.synchronize()
            got = launched()
            qed = qed_launched()
            assert rc == 0, (rc, so.getvalue(), se.getvalue())
            lines = so.getvalue().strip().splitlines()
            assert len(lines) == 1, lines
            line = json.loads(lines[0])
            assert "error" not in line and line["value"] > 0, line
            assert got == {"vay_full": steps}, got
            absorb_ms = (sum(a.elapsed_time(b) for a, b in spans) / len(spans)
                         if spans else None)
            assert (absorb_ms is not None) == (label == "bench --qed")
            if label == "bench --qed":
                # one envelope pair a bracketed absorb call, one walk a
                # call with walkers
                assert qed["cell_envelopes"] == len(spans), (qed, len(spans))
                assert 0 < qed["absorb_walk"] == captured["walks"] <= len(
                    spans), (qed, captured["walks"], len(spans))
                assert qed["invert_many"] > 0, qed
            elif "--qed" in argv:
                assert qed["absorb_walk"] == qed["cell_envelopes"] == 0, qed
                assert qed["invert_many"] > 0, qed
            else:
                assert not any(qed.values()), qed
            extra = dict(absorb_ms_per_step=absorb_ms,
                         **{f"{k}_launches": v for k, v in qed.items()},
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         **I.absorb.events)
            if "--qed" in argv:
                photons = int(se.getvalue().split("photons=")[1].split()[0])
                assert photons > 0
                extra["photons"] = photons
            out[label] = (got["vay_full"], line, extra)
            log(21, f"python -m opal_tpu_torch.bench {' '.join(argv)}: "
                    f"{lines[0]}; {' '.join(se.getvalue().split())}; launches "
                    f"of vay_full {got['vay_full']}; " + ", ".join(
                        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in extra.items() if v is not None)
                    + f"; on {smi}")
    finally:
        S.absorb = real
    return out, captured


#: the colliding_beams deck with absorption, cut to the crossing (the run
#: ends 0.5 um/c after the pulse's peak meets the beam: 2,368 steps, of
#: which the CLI runs 5 x 473)
CB_ABS_EDITS = (("photon_absorption: false", "photon_absorption: true"),
                ("end: 6.0e-6/c", "end: -1.5e-6/c"))


def cb_absorption_drive(tmp: Path, smi: str):
    """Phase 22, the absorption main path of the CLI: ``python -m
    opal_tpu_torch`` on ``examples/colliding_beams.yaml`` with
    ``photon_absorption: true`` at ``--f32``, at full width (nx 4000,
    50,000 electrons, 256 candidates a photon) and cut to the crossing,
    written to a temporary directory: one launch of the full Vay form
    without the deposit a step, the bracketed absorption pass a step, no
    loss, finite outputs, at least one absorbed and one stimulated
    event, and the radiated-energy ledger with the laser's work on the
    electrons (ROADMAP C8) from the states the CLI's ``Simulation.run``
    calls took and returned, summed in f64, within 1e-4.  Returns the
    launches of the kernel forms and K1-K3, the steps a second, the
    closure and the largest K1-K3 calls, for phase 29."""
    from opal_tpu_torch import cli
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch import sim as S
    from opal_tpu_torch.species import kinetic_energy_weights

    src = (ROOT / "examples" / "colliding_beams.yaml").read_text()
    for a, b in CB_ABS_EDITS:
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    run = tmp / "colliding_beams_absorption"
    run.mkdir()
    (run / "deck.yaml").write_text(src)
    seen, calls = {}, []
    real_run, real_absorb = S.Simulation.run, S.absorb

    def run_spy(self, E, B, J, rho, species, *a, **kw):
        seen.setdefault("first", (self, species))
        res = real_run(self, E, B, J, rho, species, *a, **kw)
        seen["last"] = res[4]
        return res

    def absorb_spy(*a, **kw):
        calls.append(kw["bracketed"])
        return real_absorb(*a, **kw)

    so, se = io.StringIO(), io.StringIO()
    I.absorb.events.update(absorbed=0, stimulated=0)
    S.Simulation.run, S.absorb = run_spy, absorb_spy
    reset_launches()
    captured = {}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se), \
                no_plain_qed(), capture_qed(captured):
            rc = cli.main([str(run / "deck.yaml"), "--f32"])
        torch.cuda.synchronize()
    finally:
        S.Simulation.run, S.absorb = real_run, real_absorb
    wall = time.perf_counter() - t0
    launches = launched()
    qed = qed_launched()
    out, err = so.getvalue(), se.getvalue()
    assert rc == 0, (rc, out, err)
    assert "[fused pusher: electron]" in out, out
    assert "buffer-overflow particle losses" not in err, err
    steps = launches.get("vay_full_dep_skip", 0)
    # the CLI runs n_outputs blocks of total_steps // n_outputs steps
    assert launches == {"vay_full_dep_skip": steps} and steps == 5 * (
        2368 // 5), launches
    assert set(calls) == {True} and len(calls) == steps
    # one envelope pair a bracketed absorb call, one walk a call with
    # walkers, K3
    assert qed["cell_envelopes"] == steps, qed
    assert 0 < qed["absorb_walk"] == captured["walks"] <= steps, (
        qed, captured["walks"])
    assert qed["invert_many"] > 0, qed
    n_out = int(out.splitlines()[-1].split()[1])
    for i in range(n_out + 1):
        g = np.loadtxt(run / f"{i}_grid.dat")
        assert g.shape == (4000, 11) and np.isfinite(g).all()
        e = _energy_file(run / f"{i}_energy.dat")
        assert all(math.isfinite(v) for v in e.values()) and e["electrons"] > 0
    sim, sp0 = seen["first"]
    sp1 = seen["last"]

    def joules(sp):
        el = sp["electron"]
        return (
            float(kinetic_energy_weights(sim.specs["electron"], el).double()
                  .sum()),
            float(kinetic_energy_weights(sim.specs["photon"], sp["photon"])
                  .double().sum()),
            float(torch.where(el.alive, el.weight.double() * el.work.double(),
                              0.0).sum()))

    (e0, p0, w0), (e1, p1, w1) = joules(sp0), joules(sp1)
    gain, e_loss, work = p1 - p0, e0 - e1, w1 - w0
    assert gain > 0
    closure_w = abs(e_loss + work - gain) / gain
    backlog = [l for l in err.splitlines() if "backlog" in l]
    log(22, f"python -m opal_tpu_torch colliding_beams.yaml with "
            f"photon_absorption: true --f32 (nx 4000, 50,000 electrons, cut "
            f"to the crossing: {steps} steps over {n_out} outputs): launches "
            f"{launches}, K1-K3 launches {qed} (no plain QED code on the "
            f"card), {len(calls)} bracketed absorption calls, "
            f"{I.absorb.events['absorbed']} absorbed and "
            f"{I.absorb.events['stimulated']} stimulated events, no losses, "
            f"outputs finite; electron loss {e_loss:.6e} J, laser work "
            f"{work:.6e} J, photon gain {gain:.6e} J: closure with the work "
            f"{closure_w:.3e}; QED backlog notes {len(backlog)}"
            f"{': ' + backlog[-1] if backlog else ''}; {steps / wall:.1f} "
            f"steps/s over {wall:.1f} s incl. set-up and dumps, on {smi}")
    # a check that sees no event proves nothing of the kicks and kills
    assert I.absorb.events["absorbed"] > 0, I.absorb.events
    assert I.absorb.events["stimulated"] > 0, I.absorb.events
    assert closure_w < 1e-4, closure_w
    return {**launches, **qed}, steps / wall, closure_w, captured


def _field_err(got, want) -> float:
    """max |got - want| over max |want|: the error in units of the
    field's scale."""
    got, want = got.cpu().double(), want.cpu().double()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-300)


def field_setup_card_vs_cpu():
    """Phase 23: the electrostatic field set-up at f64, card against CPU:
    ``fields.electrostatic_init`` on random rho and J at the full
    hole_boring grid (laser and absorbing zones, 20,204 cells) and on a
    periodic grid of as many interior cells, and
    ``Simulation.initialize_fields`` on ``examples/hole_boring.yaml``'s
    full-width initial state (500,000 electrons and as many carbon ions,
    in 2 x 625,000 rows), with both species (a neutral slab: its fields
    are the particles' noise) and with its electrons alone (the slab's
    charge: fields of a real scale).  The deposit adds in another order
    on the card, and the cumsum associates otherwise: every field within
    1e-12 of its scale."""
    from opal_tpu_torch.cli import build
    from opal_tpu_torch.convert import state_from_numpy, to_numpy
    from opal_tpu_torch.fields import electrostatic_init
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.sim import Simulation

    f64 = torch.float64
    rng = np.random.default_rng(23)
    parts = []
    for label, kw in (("hole_boring grid", dict(left_boundary="laser",
                                                right_boundary="absorbing")),
                      ("periodic grid", {})):
        geom = GridGeometry(nx=20_000, dx=1e-9, xmin=-1e-5, n_devices=1, **kw)
        rho = rng.standard_normal(geom.n_ext) * 1e3
        J = rng.standard_normal((geom.n_ext, 3)) * 1e11
        args = {dev: (torch.zeros((geom.n_ext, 3), dtype=f64, device=dev),
                      torch.zeros((geom.n_ext, 3), dtype=f64, device=dev),
                      torch.from_numpy(J).to(dev),
                      torch.from_numpy(rho).to(dev), geom)
                for dev in ("cuda", "cpu")}
        out = {dev: electrostatic_init(*a) for dev, a in args.items()}
        ms = cuda_ms(lambda: electrostatic_init(*args["cuda"]))
        err = max(_field_err(a, b) for a, b in zip(out["cuda"], out["cpu"]))
        assert err < 1e-12, (label, err)
        parts.append(f"electrostatic_init on the {label} ({geom.n_ext} cells) "
                     f"within {err:.2e} of scale, {ms:.3f} ms")

    sim, sp, _ = build(ROOT / "examples" / "hole_boring.yaml", dtype=f64,
                       field_dtype=f64, device="cpu")
    card = Simulation(sim.geom, sim.options, sim.specs, device="cuda",
                      dtype=f64, field_dtype=f64)
    sp_card = {n: state_from_numpy(to_numpy(st), device="cuda")
               for n, st in sp.items()}
    for label, names in (("both species", ("electron", "ion")),
                         ("electrons alone", ("electron",))):
        got = card.initialize_fields(*card.init_fields(),
                                     {n: sp_card[n] for n in names})
        want = sim.initialize_fields(*sim.init_fields(),
                                     {n: sp[n] for n in names})
        errs = [_field_err(a, b) for a, b in zip(got, want)]
        assert max(errs) < 1e-12, (label, errs)
        ms = cuda_ms(lambda: card.initialize_fields(
            *card.init_fields(), {n: sp_card[n] for n in names}), reps=5)
        ex = float(want[0][:, 0].abs().max())
        parts.append(
            f"initialize_fields, {label} (max |Ex| {ex:.4e} V/m): E, B, J, "
            f"rho within {', '.join(f'{e:.2e}' for e in errs)} of scale, "
            f"{ms:.3f} ms on the card")
    for p in parts:
        log(23, p)
    del sp_card, card
    torch.cuda.empty_cache()


#: phase 24's window: phase 8's deck (slab at -9..-4 um, from t = -17
#: um/c) with the field set-up and a checkpoint at every output, cut to
#: outputs of 150 steps
RESUME_SPAN = 150


def _timed(fn, into: list):
    """``fn`` with the seconds of each call, the card synchronised at
    both ends, appended to ``into``."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return res
    return call


#: the grid file's columns by field (``diagnostics.output.interpolate_
#: grid``): x, rho, J, E, B
GRID_FIELDS = {"rho": [1], "J": [2, 3, 4], "E": [5, 6, 7], "B": [8, 9, 10]}
#: the output files of a hole_boring output index
HB_STEMS = ("grid.dat", "energy.dat", "electron_x-px.fits",
            "electron_x-p_perp.fits", "electron_py-pz.fits",
            "carbon_x-px.fits", "carbon_x-p_perp.fits", "carbon_py-pz.fits")


def _grid_err(path_a: Path, path_b: Path) -> dict:
    """Each field's largest difference between two grid files over its
    largest magnitude in the first, its components together (phase 7's
    measure)."""
    a, b = np.loadtxt(path_a), np.loadtxt(path_b)
    assert a.shape == b.shape and np.isfinite(b).all()
    return {f: float(np.abs(b[:, c] - a[:, c]).max())
            / max(float(np.abs(a[:, c]).max()), 1e-300)
            for f, c in GRID_FIELDS.items()}


def hb_resume_drive(tmp: Path, smi: str):
    """Phase 24, this slice's main path: ``examples/hole_boring.yaml`` at
    full width through the user's entry point with ``initialise_fields:
    true`` and ``checkpoint: true``: runs A and A' over 4 outputs of 150
    steps (A' as a world of 1 under an NCCL group, whose energies and
    alive counts must equal A's: phase 26's hole_boring run), run B over
    the first 2, then B's directory resumed with A's deck
    (``--resume``).  Both species go through B1's lite Vay
    (``work_inc``) and lite Boris forms on every step, with no loss.

    The resume restores the state exactly: the resumed run's output 2,
    written again from the loaded state, is byte for byte B's own.  The
    slab's flush uses atomics (ROADMAP C4), so two runs of the deck part
    after that: the resumed outputs 3 and 4 must agree with A's in the
    energies within 1e-6 relative (they are printed to 7 digits) and in
    the alive counts.  Each field's largest difference from A's grid is
    reported beside the same difference of run A', the spread of two
    continuous runs: the atomics' rounding, amplified by the deck's
    thermal slab, takes that past 1e-5 of scale in this window, so no
    bar is set on it.  Returns the launches of each form over the four
    runs."""
    from opal_tpu_torch import checkpoint, cli, constants as const
    from opal_tpu_torch.config import Config

    src = (ROOT / "examples" / "hole_boring.yaml").read_text()
    for a, b in HB_CLI_EDITS + (
            ("control:\n", "control:\n initialise_fields: true\n"
                           " checkpoint: true\n"),):
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    cfg = Config.from_string(src)
    cfg.with_context("constants")
    dt = 0.95 * cfg.read_f64("control", "dx") / const.SPEED_OF_LIGHT
    start = cfg.read_f64("control", "start")

    def deck(outputs):
        end = start + (outputs * RESUME_SPAN + 0.5) * dt
        return src.replace("end: -8.0e-6/c", f"end: {end!r}").replace(
            "n_outputs: 30", f"n_outputs: {outputs}")

    def drive(run: Path, outputs: int, *flags):
        run.mkdir(exist_ok=True)
        (run / "deck.yaml").write_text(deck(outputs))
        so, se = io.StringIO(), io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = cli.main([str(run / "deck.yaml"), *flags,
                           *(coordinator() if run == run_a2 else ())])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out, err = so.getvalue(), se.getvalue()
        assert rc == 0, (rc, out, err)
        assert "[fused pusher: electron, ion]" in out, out
        assert "buffer-overflow particle losses" not in err, err
        launches = launched()
        steps = (outputs - (2 if "--resume" in flags else 0)) * RESUME_SPAN
        assert launches == {"vay": steps, "boris": steps}, (launches, steps)
        return out, launches, wall

    run_a, run_a2, run_b = tmp / "resume_a", tmp / "resume_a2", tmp / "resume_b"
    saves, loads = [], []
    real = checkpoint.save, checkpoint.load
    checkpoint.save, checkpoint.load = _timed(real[0], saves), _timed(
        real[1], loads)
    try:
        runs = [drive(run_a, 4)]
        with Collectives() as coll:
            runs.append(drive(run_a2, 4))
        runs.append(drive(run_b, 2))
        kept = {s: (run_b / f"2_{s}").read_bytes() for s in HB_STEMS}
        runs.append(drive(run_b, 4, "--resume"))
    finally:
        checkpoint.save, checkpoint.load = real
    assert "Resuming from output 2 (t =" in runs[3][0], runs[3][0]
    assert len(saves) == 5 + 5 + 3 + 3 and len(loads) == 1, (saves, loads)
    for s, data in kept.items():
        assert (run_b / f"2_{s}").read_bytes() == data, s

    spread = {"resumed": {}, "A'": {}}
    worst_energy = worst_group = 0.0
    for i in range(5):
        e_a = _energy_file(run_a / f"{i}_energy.dat")
        assert e_a["electrons"] > 0 and e_a["ions"] > 0, e_a
        # A' ran as a world of 1 under an NCCL group: the same energies
        # to the printed digits (C4: the atomics part the grids)
        worst_group = max(worst_group, _energy_err(
            run_a2 / f"{i}_energy.dat", run_a / f"{i}_energy.dat"))
        if i < 3:
            continue
        e_r = _energy_file(run_b / f"{i}_energy.dat")
        for k, v in e_a.items():
            err = abs(e_r[k] - v) / max(abs(v), abs(e_r[k]), 1e-300)
            assert err <= 1e-6, (i, k, e_r[k], v)
            worst_energy = max(worst_energy, err)
        for label, run in (("resumed", run_b), ("A'", run_a2)):
            for f, err in _grid_err(run_a / f"{i}_grid.dat",
                                    run / f"{i}_grid.dat").items():
                spread[label][f] = max(spread[label].get(f, 0.0), err)
    alive = {}
    for run in (run_a, run_a2, run_b):
        with np.load(run / checkpoint.FILENAME) as z:
            alive[run.name] = [int(z[f"{n}/alive"].sum())
                               for n in ("electron", "ion")]
            assert json.loads(bytes(z["manifest"]))["step"] == 4
    assert alive["resume_b"] == alive["resume_a"] == alive["resume_a2"], alive
    size = (run_a / checkpoint.FILENAME).stat().st_size
    la, la2, lb, lr = (r[1] for r in runs)
    walls = ", ".join(f"{w:.1f}" for w in (r[2] for r in runs))
    log(24, f"python -m opal_tpu_torch hole_boring.yaml with initialise_fields "
            f"and checkpoint (nx 20000, npc 100 a species, slab -9..-4 um, "
            f"outputs of {RESUME_SPAN} steps): runs A and A' over 4 outputs, "
            f"B over 2, B resumed to 4: {walls} s; launches vay "
            f"{la['vay']} + {la2['vay']} + {lb['vay']} + {lr['vay']}, boris "
            f"the same; no losses; the resumed output 2 byte-equal to B's; "
            f"outputs 3-4 vs A: energies within {worst_energy:.2e} relative, "
            f"alive {alive['resume_b']} (A {alive['resume_a']}, A' "
            f"{alive['resume_a2']})")
    log(24, "largest grid difference from A over outputs 3-4, of each "
            "field's scale: resumed " + ", ".join(
                f"{f} {e:.2e}" for f, e in spread["resumed"].items())
        + "; A' (continuous) " + ", ".join(
                f"{f} {e:.2e}" for f, e in spread["A'"].items()))
    log(24, f"checkpoint.npz at this width: {size} bytes ({size / 2**20:.1f} "
            f"MiB); save {statistics.median(saves):.3f} s median of "
            f"{len(saves)} (min {min(saves):.3f}, max {max(saves):.3f}), load "
            f"{loads[0]:.3f} s, on {smi}")
    steps = 4 * RESUME_SPAN
    log(26, f"hole_boring.yaml (phase 24's window, {steps} steps) as a world "
            f"of 1 under an NCCL group (run A'): energies within "
            f"{worst_group:.2e} of run A's without a group over outputs 0-4, "
            f"alive {alive['resume_a2']} equal; {runs[1][2]:.1f} s against "
            f"{runs[0][2]:.1f} s ({(runs[1][2] - runs[0][2]) / steps * 1e3:.3f} "
            f"ms a step of wall, one host's speed varying); collectives "
            f"{coll.report(steps)}; on {smi}")
    return {form: sum(r[1][form] for r in runs) for form in la}


def _same(a, b) -> bool:
    """Bitwise equality of two tensors, NaN where NaN."""
    if a.is_floating_point():
        nan = a.isnan()
        return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def qed_resume_on_card(tmp: Path):
    """Phase 25: the generator across a resume.  Phase 10's small
    emission deck at ``--f32`` through ``Simulation.run`` on the card,
    drawing from the CLI's ``torch.Generator``, with ``checkpoint.save``
    and ``load`` between its two halves, against the continuous run made
    of the same two calls: the same photons, and energies within 1e-12
    relative.  This path runs no deposit, so it reports whether every
    column is bitwise equal."""
    from opal_tpu_torch import checkpoint
    from opal_tpu_torch.cli import build

    run = tmp / "qed_resume"
    run.mkdir()
    (run / "deck.yaml").write_text(QED_SMALL)
    sim, sp, rp = build(run / "deck.yaml", dtype=torch.float32,
                        field_dtype=torch.float32, device="cuda")
    steps = rp["total_steps"]
    n1 = steps // 2
    rng = torch.Generator(device=sim.device).manual_seed(sim.options.seed)
    reset_launches()
    E, B, J, rho, sp1, t1, c1 = sim.run(
        *sim.init_fields(), sp, rp["tstart"], sim.zero_counters(), n1, rng=rng)
    checkpoint.save(run, 1, t1, E, B, J, rho, sp1, rng, c1, sim.geom.n_loc)
    cont = sim.run(E, B, J, rho, sp1, t1, c1, steps - n1, rng=rng)
    _, t2, *state, rng2, c2 = checkpoint.load(run, sim)
    res = sim.run(*state, t2, c2, steps - n1, rng=rng2)
    launches = launched()
    assert launches == {"vay_full_dep_skip": steps + (steps - n1)}, launches
    for out in (cont, res):
        lost = {k: int(v) for k, v in out[6].items() if k != "qed_deferred"}
        assert not any(lost.values()), lost
    photons = [int(o[4]["photon"].alive.sum()) for o in (cont, res)]
    assert photons[0] == photons[1] > 0, photons
    energies = {}
    for label, o in (("continuous", cont), ("resumed", res)):
        energies[label] = [sim.em_field_energy(o[0], o[1])] + [
            sim.total_kinetic_energy(n, o[4][n]) for n in ("electron", "photon")]
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(energies["resumed"], energies["continuous"]))
    assert worst <= 1e-12, energies
    bitwise = all(_same(a, b) for a, b in zip(res[:4], cont[:4])) and all(
        _same(a, b) for n in sim.specs
        for a, b in zip(res[4][n].columns().values(),
                        cont[4][n].columns().values()))
    log(25, f"small emission deck at --f32 ({steps} steps, {launches} "
            f"launches), saved and loaded after {n1} steps ("
            f"{int(sp1['photon'].alive.sum())} photons) on the card: "
            f"photons {photons[1]} vs {photons[0]} of the continuous run, "
            f"energies within {worst:.2e} relative, every column bitwise "
            f"equal: {bitwise}")


def coordinator() -> list:
    """The CLI flags of a world of 1 under a process group: rank 0 of 1,
    its rendezvous on a free localhost port (NCCL on the card)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return ["--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "1", "--process-id", "0"]


class Collectives:
    """Counts and times the ring's collectives (``Ring.shift``, ``psum``,
    ``all_gather``, ``gather``) issued inside the ``with`` block, the card
    synchronised around each (the time a collective holds the step).
    A world of 1's shift is a local copy, not a collective: it is
    counted apart and neither synchronised nor timed."""

    NAMES = ("shift", "psum", "all_gather", "gather")

    def __enter__(self):
        from opal_tpu_torch.parallel import dist

        self.calls = dict.fromkeys(self.NAMES, 0)
        self.local = 0
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self.real = {n: getattr(dist.Ring, n) for n in self.NAMES}

        def timed(name):
            fn = self.real[name]

            def call(ring, *args):
                if ring.group is None:
                    return fn(ring, *args)
                if ring.world == 1 and name == "shift":
                    self.local += 1
                    return fn(ring, *args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(ring, *args)
                torch.cuda.synchronize()
                self.calls[name] += 1
                self.seconds[name] += time.perf_counter() - t0
                return res
            return call

        for n in self.NAMES:
            setattr(dist.Ring, n, timed(n))
        return self

    def __exit__(self, *exc):
        from opal_tpu_torch.parallel import dist

        for n, fn in self.real.items():
            setattr(dist.Ring, n, fn)

    def total(self) -> float:
        return sum(self.seconds.values())

    def report(self, steps: int) -> str:
        calls = ", ".join(f"{n} {c}" for n, c in self.calls.items())
        return (f"{calls} calls, {self.total() * 1e3:.3f} ms in all, "
                f"{self.total() / steps * 1e3:.4f} ms a step (and "
                f"{self.local} shifts to the rank itself, local copies)")


def _energy_err(path_a: Path, path_b: Path) -> float:
    """The largest relative difference of two energy files' values (each
    printed to 7 digits)."""
    a, b = _energy_file(path_a), _energy_file(path_b)
    assert a.keys() == b.keys(), (a, b)
    return max(abs(a[k] - b[k]) / max(abs(a[k]), abs(b[k]), 1e-300)
               for k in a)


def _two_stream_deck(steps: int, outputs: int) -> str:
    from opal_tpu_torch import constants as const

    dt = 0.95 * 500.0 / const.SPEED_OF_LIGHT
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    return src.replace("end: 0.1", f"end: {(steps + 0.5) * dt!r}").replace(
        "n_outputs: 20", f"n_outputs: {outputs}")


def dist_world_one(tmp: Path, smi: str, ts_rate: float, ts_alive: list,
                   twin_value: float):
    """Phase 26: the distributed path on one card.  Phase 4's two_stream
    CLI drive (full width, 2000 steps over 4 outputs) again as a world
    of 1 under an NCCL group (``--coordinator``): the same energies to
    the printed digits and alive counts at every output as phase 4's run
    without a group (``ts_rate`` steps/s, ``ts_alive``), lite Vay on
    every step, no loss, and the collectives it issued.  Then the bench
    twin at its defaults under the group (``bench._bench`` with the
    ring), beside phase 15's run without it (``twin_value``): no loss,
    one launch a step.  Returns the launches of the two runs."""
    from opal_tpu_torch import bench
    from opal_tpu_torch.parallel import dist

    steps, outputs = 2000, 4
    launches, rate, alive, coll = cli_drive(tmp, steps, outputs, group=True)
    assert alive == ts_alive, (alive, ts_alive)
    worst = max(_energy_err(tmp / "two_stream_group" / f"{i}_energy.dat",
                            tmp / "two_stream" / f"{i}_energy.dat")
                for i in range(outputs + 1))
    assert worst <= 1e-6, worst
    log(26, f"two_stream.yaml as a world of 1 under an NCCL group against "
            f"phase 4's run without a group: energies within {worst:.2e} at "
            f"every output, alive {alive[-1]} equal; {rate:.1f} steps/s "
            f"against {ts_rate:.1f}; collectives {coll.report(steps)}; on "
            f"{smi}")

    args = bench._parser().parse_args(["--verbose"])
    ring = dist.init(0, 1, f"file://{tmp / 'rendezvous'}", "cuda")
    so, se = io.StringIO(), io.StringIO()
    reset_launches()
    try:
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se), \
                Collectives() as coll:
            rc = bench._bench(args, ring)
    finally:
        dist.close(ring)
    torch.cuda.synchronize()
    got = launched()
    assert rc == 0, (rc, so.getvalue(), se.getvalue())
    line = json.loads(so.getvalue().strip().splitlines()[-1])
    assert "error" not in line and line["value"] > 0, line
    assert got == {"vay": 3 * args.steps}, got
    log(26, f"the bench twin at its defaults ({3 * args.steps} steps) as a "
            f"world of 1 under an NCCL group: {line['value']:.4e} pushes/s "
            f"against {twin_value:.4e} without a group (phase 15); "
            f"{se.getvalue().strip()}; collectives "
            f"{coll.report(3 * args.steps)}; on {smi}")
    return launches, got["vay"]


def _ledger(run: Path, deck: Path, devices: int) -> dict:
    """The radiated-energy ledger of a CLI run of the colliding_beams
    absorption deck (ROADMAP C8): the electrons' kinetic energy and
    work at the start, from the initial state that ``cli.build`` makes
    for each of the run's ranks (on the host), and at the end, with the
    photons', from the run's last checkpoint; summed in f64.  Returns
    the electron loss, the laser's work, the photon gain and the closure
    ``|loss + work - gain| / gain``."""
    from opal_tpu_torch import checkpoint
    from opal_tpu_torch.cli import build
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.parallel.dist import Ring
    from opal_tpu_torch.species import SpeciesSpec, kinetic_energy_weights

    def joules(spec, st):
        return float(kinetic_energy_weights(spec, st).double().sum())

    def work(st):
        return float(torch.where(st.alive, st.weight.double()
                                 * st.work.double(), 0.0).sum())

    e0 = w0 = 0.0
    for r in range(devices):
        # a rank of the run, whose group build never reaches
        ring = (Ring(device=torch.device("cpu")) if devices == 1 else
                Ring(rank=r, world=devices, group=object()))
        sim, sp, _ = build(deck, dtype=torch.float32,
                           field_dtype=torch.float32, ring=ring)
        e0 += joules(sim.specs["electron"], sp["electron"])
        w0 += work(sp["electron"])
    with np.load(run / checkpoint.FILENAME) as z:
        cols = {n: {k.split("/", 1)[1]: z[k] for k in z.files
                    if k.startswith(n + "/")} for n in ("electron", "photon")}
    el = state_from_numpy(cols["electron"], device="cpu")
    ph = state_from_numpy(cols["photon"], device="cpu")
    e1, w1 = joules(sim.specs["electron"], el), work(el)
    gain = joules(sim.specs["photon"], ph)
    loss, lw = e0 - e1, w1 - w0
    return dict(loss=loss, work=lw, gain=gain,
                closure=abs(loss + lw - gain) / gain)


#: the seeds (``tpu: seed``) of phase 27's one-card runs of the
#: absorption deck, its sample of the run-to-run spread
CB_ABS_SEEDS = (0, 1, 2)


def cb_absorption_ranks(n: int, smi: str, tmp: Path) -> list:
    """Phase 27's absorption deck: ``examples/colliding_beams.yaml`` with
    ``photon_absorption: true`` at ``--f32`` and full width, cut to phase
    22's crossing, with the event records on (standard error), through
    ``python -m opal_tpu_torch --devices N`` on N cards in the
    replicated-field mode (opal_tpu's rule picks it for this deck) and in
    the domain mode (``tpu: replicate_fields: 0``), against one card at
    each seed of :data:`CB_ABS_SEEDS`, with the emission and absorption
    active sets unbounded (``tpu: emission_active_capacity: 0`` and
    ``absorption_active_capacity: 0``: a rank's capacities are one
    card's, so where one card defers emitters N ranks would not, and
    their physics a step would differ by that).

    The draws differ with the rank count, so the runs are held at the
    distribution level, against the one-card runs' spread over seeds: no
    counted loss, each run's ledger closure with the laser's work within
    phase 22's bar of 1e-4 (the f32 push's own bias puts one card at
    ~1.6e-5, ROADMAP C8), both kinds of event, and the photons' energy
    gain within 4 sample standard deviations of the one-card runs' mean.
    The event counts are printed beside the one-card range, not held to
    a Poisson band: a stimulated copy flies with its seed through the
    same electrons and may stimulate again, so the counts come in bursts
    and spread far wider than Poisson's from seed to seed.  Steps/s
    beside one card's.  Returns the rows as dicts."""
    src = (ROOT / "examples" / "colliding_beams.yaml").read_text()
    for a, b in CB_ABS_EDITS:
        assert src.count(a) == 1, a
        src = src.replace(a, b)
    src = src.replace("control:\n", "control:\n checkpoint: true\n")
    src += ("\nfeatures:\n extra_absorption_output: true\n"
            " extra_stimulated_emission_output: true\n"
            "\ntpu:\n emission_active_capacity: 0\n"
            " absorption_active_capacity: 0\n")
    steps = 5 * (2368 // 5)
    cases = [(f"one card, seed {seed}", 1, f" seed: {seed}\n")
             for seed in CB_ABS_SEEDS]
    cases += [("replicated", n, ""), ("domain", n, " replicate_fields: 0\n")]
    runs, rows = {}, []
    for label, devices, tpu in cases:
        run = tmp / f"cb_absorption_{len(runs)}"
        run.mkdir()
        deck = run / "deck.yaml"
        deck.write_text(src + tpu)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "opal_tpu_torch", str(deck), "--devices",
             str(devices), "--f32"], cwd=ROOT, capture_output=True,
            text=True, timeout=1200)
        wall = time.perf_counter() - t0
        assert res.returncode == 0, (res.stdout[-4000:], res.stderr[-4000:])
        assert "buffer-overflow" not in res.stderr, res.stderr[-4000:]
        assert "event ring overflow" not in res.stderr, res.stderr[-4000:]
        banner = res.stdout.splitlines()[0]
        assert ("replicated" in banner) == (label == "replicated"), banner
        assert "[fused pusher: electron]" in res.stdout, res.stdout[:2000]
        events = collections.Counter(
            line.rsplit(" ", 1)[1] for line in res.stderr.splitlines()
            if line.endswith((" abs", " stim")))
        ledger = _ledger(run, deck, devices)
        runs[label] = dict(events=events, wall=wall, ledger=ledger)
        log(27, f"colliding_beams.yaml with photon_absorption: true --f32 "
                f"(full width, {steps} steps) on {devices} card(s), {label} "
                f"('{banner}'): {events['abs']} absorbed and "
                f"{events['stim']} stimulated events, no loss; electron "
                f"loss {ledger['loss']:.6e} J, laser work "
                f"{ledger['work']:.6e} J, photon gain {ledger['gain']:.6e} J: "
                f"closure with the work {ledger['closure']:.3e}; "
                f"{steps / wall:.1f} steps/s (process start and set-up "
                f"included); on {smi}")
        assert ledger["closure"] < 1e-4, (label, ledger)
        assert events["abs"] > 0 and events["stim"] > 0, (label, events)
        rows.append(dict(deck="colliding_beams absorption --f32",
                         mode=label, ranks=devices, events=dict(events),
                         photon_gain_J=ledger["gain"],
                         closure=ledger["closure"], wall_s=wall,
                         steps_per_s=steps / wall, banner=banner))
    ones = [runs[c[0]] for c in cases[:len(CB_ABS_SEEDS)]]
    gains = [r["ledger"]["gain"] for r in ones]
    mean, sd = statistics.mean(gains), statistics.stdev(gains)
    rate = statistics.mean(steps / r["wall"] for r in ones)
    span = {k: (min(r["events"][k] for r in ones),
                max(r["events"][k] for r in ones)) for k in ("abs", "stim")}
    for label in ("replicated", "domain"):
        r = runs[label]
        z = (r["ledger"]["gain"] - mean) / sd
        log(27, f"colliding_beams with absorption on {n} cards, {label}: "
                f"photon gain {z:+.2f} sample sd from the one-card runs' "
                f"mean {mean:.6e} J (sd {sd:.3e} J over seeds "
                f"{CB_ABS_SEEDS}); events {r['events']['abs']} absorbed "
                f"and {r['events']['stim']} stimulated, one card "
                f"{span['abs'][0]}-{span['abs'][1]} and "
                f"{span['stim'][0]}-{span['stim'][1]}; "
                f"{steps / r['wall']:.1f} steps/s against {rate:.1f} on "
                f"one card; on {smi}")
        assert abs(z) <= 4, (label, z)
    return rows


def ranks_drive(n: int, smi: str) -> list:
    """Phase 27 (``--ranks N``): the two_stream deck (2000 steps over 4
    outputs) and phase 24's hole_boring deck (600 steps over 4) through
    ``python -m opal_tpu_torch deck.yaml --devices N`` on N cards, each
    in the domain mode and in the replicated-field mode (``tpu:
    replicate_fields``), against the same deck on one card: no loss,
    the alive counts of the last output equal (from its checkpoint), and
    the energies' largest relative difference printed beside the steps a
    second.  The two_stream deck in either mode, and hole_boring in the
    replicated mode, must agree with one card to 1e-6 (their printed
    digits and the atomics' rounding, C4); hole_boring's domain mode
    parts further (the halo's E at each slab edge is advanced without
    the neighbour's current, as in opal_tpu: ROADMAP C13), so it is
    reported only.  Then the colliding_beams deck with absorption
    (:func:`cb_absorption_ranks`), and the bench twin at its defaults
    with ``--devices N`` and on one card: no loss, pushes/s a card.
    Returns the rows as dicts."""
    from opal_tpu_torch import checkpoint, constants as const
    from opal_tpu_torch.config import Config

    hb = (ROOT / "examples" / "hole_boring.yaml").read_text()
    for a, b in HB_CLI_EDITS:
        hb = hb.replace(a, b)
    cfg = Config.from_string(hb)
    cfg.with_context("constants")
    dt = 0.95 * cfg.read_f64("control", "dx") / const.SPEED_OF_LIGHT
    end = cfg.read_f64("control", "start") + (4 * RESUME_SPAN + 0.5) * dt
    hb = hb.replace("end: -8.0e-6/c", f"end: {end!r}").replace(
        "n_outputs: 30", "n_outputs: 4")
    decks = {"two_stream": _two_stream_deck(2000, 4), "hole_boring": hb}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    rows = []
    try:
        for name, src in decks.items():
            src = src.replace("control:\n", "control:\n checkpoint: true\n")
            runs = {}
            for label, devices, rep in (("one card", 1, 0), ("domain", n, 0),
                                        ("replicated", n, 1)):
                run = tmp / f"{name}_{label.replace(' ', '_')}"
                run.mkdir()
                (run / "deck.yaml").write_text(
                    src + f"\ntpu:\n replicate_fields: {rep}\n")
                t0 = time.perf_counter()
                res = subprocess.run(
                    [sys.executable, "-m", "opal_tpu_torch",
                     str(run / "deck.yaml"), "--devices", str(devices)],
                    cwd=ROOT, capture_output=True, text=True, timeout=900)
                wall = time.perf_counter() - t0
                assert res.returncode == 0, (res.stdout, res.stderr)
                assert "buffer-overflow" not in res.stderr, res.stderr
                banner = res.stdout.splitlines()[0]
                assert ("replicated" in banner) == (label == "replicated"), \
                    banner
                with np.load(run / checkpoint.FILENAME) as z:
                    alive = {k: int(z[k].sum()) for k in z.files
                             if k.endswith("/alive")}
                runs[label] = (run, alive, wall, banner)
            one = runs["one card"]
            for label in ("domain", "replicated"):
                run, alive, wall, banner = runs[label]
                err = max(_energy_err(run / f"{i}_energy.dat",
                                      one[0] / f"{i}_energy.dat")
                          for i in range(5))
                assert alive == one[1], (name, label, alive, one[1])
                if name == "two_stream" or label == "replicated":
                    assert err <= 1e-6, (name, label, err)
                rows.append(dict(deck=name, mode=label, ranks=n,
                                 energy_err=err, alive=alive, wall_s=wall,
                                 one_card_wall_s=one[2], banner=banner))
                log(27, f"{name} on {n} cards, {label} mode ('{banner}'): "
                        f"energies within {err:.2e} of one card's, alive "
                        f"{alive} equal; {wall:.1f} s against {one[2]:.1f} s "
                        f"on one card (process start and set-up included); "
                        f"on {smi}")
        rows += cb_absorption_ranks(n, smi, tmp)
        # the bench twin's deck decomposed over the N cards, beside one
        twin = {}
        for devices in (1, n):
            res = subprocess.run(
                [sys.executable, "-m", "opal_tpu_torch.bench", "--devices",
                 str(devices), "--verbose"], cwd=ROOT, capture_output=True,
                text=True, timeout=900)
            assert res.returncode == 0, (res.stdout, res.stderr)
            twin[devices] = json.loads(res.stdout.strip().splitlines()[-1])
            assert "error" not in twin[devices], twin[devices]
        rows.append(dict(deck="bench", ranks=n,
                         pushes_per_s_a_card=twin[n]["value"],
                         one_card=twin[1]["value"]))
        log(27, f"python -m opal_tpu_torch.bench --devices {n}: "
                f"{twin[n]['value']:.4e} pushes/s a card "
                f"({n * twin[n]['value']:.4e} in all) against "
                f"{twin[1]['value']:.4e} on one card; on {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


#: phase 28's mini crossing with absorption (``tests/test_torch_absorption.
#: py``'s deck: nx 400, 600 electrons, the beam density raised so that
#: events fire, 8 candidates a photon) at ``--f32`` with blocks of 128
#: rows, so that its electrons take the full Vay form without the deposit
ABS_SMALL = """\
control:
 dx: 0.01*micro
 nx: 400
 xmin: -1*micro
 start: -1.5e-6/c
 end: -1.5e-6/c + 120.5 * 0.0095e-6/c
 current_deposition: false
 n_outputs: 1

qed:
 photon_emission: true
 photon_absorption: true
 photon_angle_max: 100 * milli

electrons:
 npc: 12
 ne: S * a0 * critical(omega) * step(x,xmin,xmax)
 ux: -1000.0 * (1.0 + 0.01 * nrand)
 uy: 0.0
 uz: 0.0
 output: [x, chi]

ions:
 npc: 0

photons:
 npc: 0
 output: [energy:(log;energy)]

laser:
 Ey: >
  (a0*m*c*omega/e)
  *sin(omega*(t-x/c))
  *exp(-ln(2.0)*(omega*(t-x/c))^2/(2.0*pi^2*ncycles^2))
 Ez: 0.0

constants:
 S: 1.0e6
 a0: 20.0
 omega: 2*pi*c/0.8e-6
 ncycles: 4.0
 xmin: 0.2 * micro
 xmax: 0.7 * micro

tpu:
 absorption_candidates: 8
 absorption_active_capacity: 512
 absorption_event_capacity: 64
 replicate_fields: 1
 fused_block: 128
"""


def _gloo_rank(rank, world, init_method, out):
    """One rank of phase 28's ``gloo`` group on the card (``cuda:0``,
    shared by the ranks): whether gloo reduces and gathers CUDA tensors,
    and if it does, the replicated ``absorb`` on the forced-event state
    split over the ranks, on the card and on the CPU with the same draws,
    and the small absorption deck (:data:`ABS_SMALL`) stepped on the
    card and on the CPU with the same host-made draws.  Writes its
    results to ``out/rank{rank}.pkl``."""
    import os
    import pickle

    import torch.distributed as tdist

    sys.path.insert(0, str(ROOT))
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.parallel.dist import Ring
    from opal_tpu_torch.species import rank_rows

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    tdist.init_process_group("gloo", init_method=init_method,
                             world_size=world, rank=rank)
    rings = {dev: Ring(rank, world, torch.device(dev), tdist.group.WORLD)
             for dev in ("cuda", "cpu")}
    res = {}
    # the question of the phase: a gloo collective of CUDA tensors either
    # runs or raises on every rank alike, before any message
    try:
        ring = rings["cuda"]
        res["probe"] = (
            ring.psum(torch.tensor([rank + 1], device="cuda")).tolist(),
            ring.all_gather(torch.tensor([rank], device="cuda")).tolist())
    except RuntimeError as exc:
        res["probe_error"] = f"{type(exc).__name__}: {exc}"
    if "probe" in res:
        geom = GridGeometry(nx=4096, dx=1e-6, xmin=0.0, n_devices=1)
        res["absorb"] = {}
        for mode, (presorted, bracketed) in ABSORB_MODES.items():
            e, ph = forced_absorb_state(mode)
            opt = _absorb_opts(2048 // world)
            sim = SimpleNamespace(geom=geom, options=opt)
            n_e, n_ph = len(e["x"]) // world, len(ph["x"]) // world
            draws = _absorb_draws(opt, n_e, n_ph, world, 50 + rank)
            got = {}
            for dev, ring in rings.items():
                sp = {"electron": rank_rows(state_from_numpy(e, device=dev),
                                            rank, n_e),
                      "photon": rank_rows(state_from_numpy(ph, device=dev),
                                          rank, n_ph)}
                I.absorb.events.update(absorbed=0, stimulated=0)
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = I.absorb(sim, sp, 1e-15, draws, presorted=presorted,
                             bracketed=bracketed, ring=ring,
                             replicated=True)
                if dev == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got[dev] = (_absorb_columns(r), dict(I.absorb.events), ms)
            res["absorb"][mode] = dict(
                worst=_worst(got["cuda"][0], got["cpu"][0]),
                events=(got["cuda"][1], got["cpu"][1]),
                deferred=got["cpu"][0][2],
                ms=(got["cuda"][2], got["cpu"][2]))
        res["deck"] = _gloo_deck(rings, rank, Path(out))
    (Path(out) / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    tdist.destroy_process_group()


def _gloo_deck(rings, rank, out: Path):
    """:data:`ABS_SMALL` at ``--f32`` on the rank of the gloo group, on
    the card and on the CPU, with the same host-made draws a step: the
    replicated mode, the kernel's launches on the card, no loss, the
    events applied, the photons alive, the energies (summed over the
    ranks) and the card's field arrays' checksum (the ranks hold the
    whole grid, and must hold it alike)."""
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.cli import build
    from opal_tpu_torch.interactions import absorb_widths, emission_widths

    deck = out / f"abs_small_{rank}" / "deck.yaml"
    deck.parent.mkdir()
    deck.write_text(ABS_SMALL)
    got, draws = {}, None
    for dev, ring in rings.items():
        sim, sp, rp = build(deck, dtype=torch.float32,
                            field_dtype=torch.float32, ring=ring)
        assert sim.options.replicate_fields
        assert sim._fused_applicable("electron", sp["electron"])
        steps = rp["total_steps"]
        if draws is None:
            opt, world = sim.options, ring.world
            n_e, n_ph = (sp[k].x.shape[0] for k in ("electron", "photon"))
            m, mi = emission_widths(opt, n_e)
            rng = np.random.default_rng(70 + rank)
            f32 = lambda a: a.astype(np.float32)
            draws = []
            for i in range(steps):
                d = _absorb_draws(opt, n_e, n_ph, world, 1000 * rank + i,
                                  np.float32)
                d.update(r1=f32(rng.random(m)), r2=f32(rng.random(m)),
                         r3=f32(rng.random(m)),
                         tau=f32(rng.exponential(size=m)),
                         tau_abs=f32(rng.exponential(size=mi)),
                         tau_st=f32(rng.exponential(size=mi)))
                draws.append(d)
        reset_launches()
        I.absorb.events.update(absorbed=0, stimulated=0)
        t0 = time.perf_counter()
        E, B, J, rho, species, t, counters = sim.run(
            *sim.init_fields(), sp, rp["tstart"], sim.zero_counters(), steps,
            rng=draws.__getitem__)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got[dev] = dict(
            launches=launched(), qed=qed_launched(), steps=steps, wall=wall,
            lost={k: int(v) for k, v in counters.items()
                  if k != "qed_deferred"},
            applied=dict(I.absorb.events),
            photons=int(ring.psum(species["photon"].alive.sum())),
            energies=[sim.em_field_energy(E, B)] + [
                sim.total_kinetic_energy(n, species[n]) for n in sim.specs],
            fields=ring.all_gather(torch.stack(
                [E.double().sum(), B.double().sum()])).tolist())
    return got


def replicated_absorb_on_card(tmp: Path, smi: str):
    """Phase 28, the replicated-field mode's absorption on the card.

    First at a world of 1 under an NCCL group: ``absorb(...,
    replicated=True)`` (its gathered table of 8 columns, the partner's
    row from the table, the kicks through the routing records and the
    gather) against the branch without it on phase 19's forced-event
    state, in the three pairing modes with the compaction on and off,
    under torch's deterministic algorithms (so that the kicks' index
    adds sum repeated rows in one order): the same events and every
    column, count and record bitwise.

    Then whether this PyTorch's ``gloo`` reduces and gathers CUDA
    tensors (the replicated mode needs no ring shift), on two ranks that
    share the card.  If it does: the replicated ``absorb`` on the forced
    state split over the two ranks, each rank on the card against the
    same rank on the CPU with the same draws (events equal, every column
    within 1e-12 at f64); and :data:`ABS_SMALL` at ``--f32`` stepped on
    the two ranks on the card and on the CPU with the same host-made
    draws: the kernel's full Vay form without the deposit once a step on
    each rank, no loss, both kinds of event, the ranks' fields alike,
    and the photons and energies card vs CPU within phase 10's bars (1%
    of the photons, 1e-3 of each energy), K1-K3 launched on each rank.
    Returns the launches of the deck's run on the card and K1-K3's, each
    summed over the ranks (0 if gloo took no CUDA tensor)."""
    import pickle

    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.parallel import dist

    geom = GridGeometry(nx=4096, dx=1e-6, xmin=0.0, n_devices=1)
    ring = dist.init(0, 1, f"file://{tmp / 'rendezvous28'}", "cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode, (presorted, bracketed) in ABSORB_MODES.items():
            e, ph = forced_absorb_state(mode)
            for compact in (2048, 0):
                opt = _absorb_opts(compact)
                sim = SimpleNamespace(geom=geom, options=opt)
                draws = _absorb_draws(opt, len(e["x"]), len(ph["x"]), 1, 5)
                got = {}
                for replicated in (False, True):
                    sp = {"electron": state_from_numpy(e, device="cuda"),
                          "photon": state_from_numpy(ph, device="cuda")}
                    I.absorb.events.update(absorbed=0, stimulated=0)
                    r = I.absorb(sim, sp, 1e-15, draws, presorted=presorted,
                                 bracketed=bracketed, ring=ring,
                                 replicated=replicated)
                    got[replicated] = (_absorb_columns(r),
                                       dict(I.absorb.events))
                (plain, ev_p), (rep, ev_r) = got[False], got[True]
                assert ev_p == ev_r and ev_p["absorbed"] > 100, (ev_p, ev_r)
                worst = _worst(rep, plain)
                label = (f"{mode}, "
                         f"{'compaction 2048' if compact else 'whole buffer'}")
                log(28, f"absorb's replicated branch at a world of 1 under "
                        f"NCCL vs the plain branch on the forced-event state "
                        f"({label}): {ev_p['absorbed']} absorbed and "
                        f"{ev_p['stimulated']} stimulated events on both, "
                        f"deferred {plain[2]}; every column and record "
                        f"differs by {worst:.3e} of its scale (bar 0)")
                assert worst == 0.0, (label, worst)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.close(ring)

    out = tmp / "gloo28"
    out.mkdir()
    t0 = time.perf_counter()
    codes = dist.launch(_gloo_rank, 2, (str(out),), timeout=600)
    assert codes == [0, 0], codes
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in range(2)]
    if "probe_error" in ranks[0]:
        assert all("probe_error" in r for r in ranks), ranks
        log(28, f"gloo does not take CUDA tensors in this PyTorch "
                f"({torch.__version__}): {ranks[0]['probe_error']}; the two "
                f"gloo ranks on the card are left out")
        return 0, dict.fromkeys(QED_KERNELS, 0)
    for r, res in enumerate(ranks):
        assert res["probe"] == ([3], [[0], [1]]), res["probe"]
    log(28, f"gloo reduces and gathers CUDA tensors (torch "
            f"{torch.__version__}): two ranks on the card, "
            f"{time.perf_counter() - t0:.1f} s for the rank processes")
    for mode in ABSORB_MODES:
        for r, res in enumerate(ranks):
            a = res["absorb"][mode]
            ev_c, ev_h = a["events"]
            assert ev_c == ev_h and ev_h["absorbed"] > 10, (mode, r, a)
            log(28, f"replicated absorb on 2 gloo ranks ({mode}, compaction "
                    f"1024 a rank), rank {r} card vs CPU: {ev_h['absorbed']} "
                    f"absorbed and {ev_h['stimulated']} stimulated events on "
                    f"both, deferred {a['deferred']}; every column within "
                    f"{a['worst']:.3e} of its scale (bar 1e-12); card "
                    f"{a['ms'][0]:.1f} ms, CPU {a['ms'][1]:.1f} ms")
            assert a["worst"] <= 1e-12, (mode, r, a["worst"])
    launches, qed = 0, collections.Counter()
    for r, res in enumerate(ranks):
        c, h = res["deck"]["cuda"], res["deck"]["cpu"]
        steps = c["steps"]
        assert c["launches"] == {"vay_full_dep_skip": steps}, c["launches"]
        # each rank walks through K1 and K2 and samples through K3
        assert all(c["qed"].values()), c["qed"]
        launches += steps
        qed.update(c["qed"])
        for d in (c, h):
            assert not any(d["lost"].values()), d["lost"]
            # the ranks hold the whole grid alike
            assert d["fields"][0] == d["fields"][1], d["fields"]
    c0, h0 = ranks[0]["deck"]["cuda"], ranks[0]["deck"]["cpu"]
    applied = {dev: {k: sum(res["deck"][dev]["applied"][k] for res in ranks)
                     for k in ("absorbed", "stimulated")}
               for dev in ("cuda", "cpu")}
    log(28, f"the small absorption deck (nx 400, 600 electrons, "
            f"{c0['steps']} steps, --f32, blocks of 128, replicate_fields: "
            f"1, host-made draws) on 2 gloo ranks on the card vs the CPU: "
            f"launches {c0['launches']} a rank, K1-K3 launches {dict(qed)} "
            f"over the ranks, events {applied['cuda']} vs "
            f"{applied['cpu']}, photons {c0['photons']} vs {h0['photons']}, "
            f"energies (field, electrons, photons) "
            f"{[f'{v:.6e}' for v in c0['energies']]} vs "
            f"{[f'{v:.6e}' for v in h0['energies']]} J; the ranks' fields "
            f"alike; {c0['steps'] / c0['wall']:.1f} steps/s on the card, "
            f"{h0['steps'] / h0['wall']:.1f} on the CPU; on {smi}")
    assert applied["cuda"]["absorbed"] > 0 and \
        applied["cuda"]["stimulated"] > 0, applied
    assert h0["photons"] > 100 and abs(c0["photons"] - h0["photons"]) <= \
        0.01 * h0["photons"], (c0, h0)
    for a, b in zip(c0["energies"], h0["energies"]):
        assert abs(a - b) <= 1e-3 * abs(b), (c0["energies"], h0["energies"])
    return launches, dict(qed)


def _cast_floats(obj, dtype):
    """``obj`` (a tensor, or a tuple, list or dict of them and other
    values) with its floating tensors cast to ``dtype``."""
    if torch.is_tensor(obj):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: _cast_floats(v, dtype) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_cast_floats(v, dtype) for v in obj)
    return obj


def _depth_rel(got, want, before) -> float:
    """The largest |got - want| of two walks' depths over each photon's
    scale, the larger of |want| and its depth before the walk (a depth
    taken down to near 0 at its event keeps the error of the sums that
    took it there)."""
    got, want, before = got.double(), want.double(), before.double()
    scale = torch.maximum(want.abs(), before.abs()).clamp(min=1e-300)
    return float(((got - want).abs() / scale).max()) if got.numel() else 0.0


def airy_arguments(k4, chi, rows, stimulated) -> dict:
    """For each (photon, candidate) of ``rows`` (nw, B, >= 5: p0 px py
    pz chi_e) and each cross section K1 computes (``abs``, and ``st``
    with stimulated emission): (whether the plain code keeps it, its
    channel valid; the Airy function's argument), at f64 as
    ``qed/cross_sections.py`` forms them."""
    tiny = 1e-300
    k, cg = k4.double()[:, None, :], chi.double()[:, None]
    p, ce = rows[..., :4].double(), rows[..., 4].double()
    k_p = k[..., 0] * p[..., 0] - (k[..., 1:] * p[..., 1:]).sum(-1)
    twoz_chi = 2.0 * ce * k_p / cg.clamp(min=tiny)
    out = {}
    for s, sign in (("abs", 1.0), ("st", -1.0))[:2 if stimulated else 1]:
        kept = (ce > 0) & (cg > 0)
        if s == "st":
            kept = kept & (cg < ce) & (k[..., 0] < p[..., 0])
        denom = (ce * (ce + sign * cg)).clamp(min=tiny)
        out[s] = kept, (cg.clamp(min=tiny) / denom) ** (2.0 / 3.0) * twoz_chi
    return out


def _k1_needs(a, kw, res):
    """What the walk needs by the reference's scan of these inputs:
    (the valid pairs of each pass up to each photon's event column, or
    all of its pass's without an event, over the passes up to its
    event; the operations they need, each pair :data:`OPS_PAIR_BASE`,
    each cross section the plain code keeps :data:`OPS_XS` and each
    Airy function whose argument lies in [0, 50) :data:`OPS_AIRY`;
    bytes: the photons' columns read and the results written once, the
    three draws of each event, and the candidate rows the walking
    photons' cells (or segments) hold in each pass)."""
    from opal_tpu_torch.ops import absorb_walk as AW

    k4, chi, tau_abs, tau_st, cell, start, r = a[:7]
    B, cdt_dx, stim = a[8:11]
    isz, tsz = k4.element_size(), tau_abs.element_size()
    nw, nb = k4.shape[0], r.shape[0]
    cols = torch.arange(B, device=k4.device)
    src = ({"cand": kw["cand"]} if kw.get("cand") is not None else
           {k: kw[k] for k in ("e_table", "end", "K", "bracketed")})
    if "e_table" in src:
        src["start"] = start
    done = torch.zeros(nw, dtype=torch.bool, device=k4.device)
    pairs = ops = cand_bytes = 0
    for bi in range(nb):
        live = ~done
        if "cand" in src:
            cand = src["cand"]
            rows = cand[cell, bi * B:(bi + 1) * B]
            valid = live[:, None] & (rows[..., 6] > 0.5)
            cand_bytes += (int(torch.unique(cell[live]).numel()) * B
                           * cand.shape[2] * isz)
        else:
            et = src["e_table"]
            rr = start[:, None] + bi * B + cols
            valid = live[:, None] & (rr < src["end"][:, None]) & (
                bi * B + cols < src["K"])
            rows = et[torch.clamp(rr, 0, et.shape[0] - 1)]
            if src["bracketed"]:
                valid = valid & (rows[..., 6] == cell[:, None].to(et.dtype))
            cand_bytes += (int(torch.unique(rr[valid]).numel())
                           * et.shape[1] * isz)
        p = AW.absorb_pass_reference(k4, chi, tau_abs, tau_st, done, cell,
                                     bi, B, cdt_dx, stim, **src)
        k_ev = torch.minimum(p.k_abs, p.k_st)
        take = valid & (cols <= torch.clamp(k_ev, max=B - 1)[:, None])
        pairs += int(take.sum())
        ops += int(take.sum()) * OPS_PAIR_BASE[bool(stim)]
        for kept, x in airy_arguments(k4, chi, rows, stim).values():
            kept = take & kept
            ops += (int(kept.sum()) * OPS_XS
                    + int((kept & (x >= 0) & (x < 50)).sum()) * OPS_AIRY)
        # a photon without an event walks on with its depths taken down
        tau_abs, tau_st = tau_abs - p.s_abs, tau_st - p.s_st
        done = done | (k_ev < B)
    events = int(res.done.sum())
    replicated = res.ev_dev is not None
    bytes_ = (nw * (5 * isz + 2 * tsz + 8 + (8 if "e_table" in src else 0)
                    + (0 if replicated and "cand" in src else 8))
              + nw * (2 * tsz + 4 + 8 + 1)
              + (nw * (8 + isz) if replicated else 0)
              + (res.ev_p4chi.numel() * isz if res.ev_p4chi is not None
                 else 0)
              + events * 3 * isz + cand_bytes)
    return pairs, ops, bytes_


def qed_kernels(captured: dict, smi: str) -> dict:
    """Phase 29: K1-K3 against their plain versions on the card, on the
    arguments of the largest call each made on the main paths
    (:func:`capture_qed` in phases 21 and 22): K1 on the walk with the
    most photons, K2 on the longest cell column, K3 on the emission call
    with the most queries, at ``bench --qed --particles 2097152`` and at
    the colliding_beams crossing with absorption, each as captured (f32)
    and cast to f64; and K1 and K2 on phase 19's forced-event state
    (bracketed, compaction 2048), where most photons fire (the main
    paths' largest walks fire none). K2 and K3 bitwise; K1 equal event
    kinds, electrons and done masks (and the replicated columns, where
    there are any) and its depths within :data:`DEPTH_BAR` of each
    photon's scale (at f32, in at most :data:`DEPTH_MOVED` of them). Each kernel's device ms (20 calls behind a
    device spin), the call's ms with its host launch, the plain
    version's, K2's ``torch.cummax`` with ``torch.cummin`` as the library
    call, and the bound from the bytes each input and output needs once
    at 3.35 TB/s and the operations this run's data needs at the f32 or
    f64 peak (K1: the valid pairs of every pass up to each photon's
    event, with the cross sections and Airy functions each needs, as
    :func:`_k1_needs` counts them; PR 10's :data:`OPS_PAIR` a pair in
    brackets). Returns {(kernel, label): row
    values}."""
    from opal_tpu_torch.ops import absorb_walk as AW
    from opal_tpu_torch.qed import pwmci

    out = {}

    def bound(bytes_, ops, f64):
        t_b = bytes_ / HBM_BYTES_PER_S * 1e3
        t_o = ops / (F64_OPS_PER_S if f64 else F32_OPS_PER_S) * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    def timed(kernel, plain, library=None):
        ms, call_ms = device_ms(kernel), cuda_ms(kernel)
        plain_ms = cuda_ms(plain, reps=5)
        lib_ms = cuda_ms(library) if library is not None else None
        return ms, call_ms, plain_ms, lib_ms

    for path, store in captured.items():
        # K1: the whole walk
        a, kw = store["absorb_walk"][1]
        for dtype in (torch.float32, torch.float64):
            ac, kwc = _cast_floats(a, dtype), _cast_floats(kw, dtype)
            got = AW.absorb_walk(*ac, **kwc)
            ref = AW.absorb_walk_reference(*ac, **kwc)
            torch.cuda.synchronize()
            for name in ("ev_kind", "ev_idx", "done", "ev_dev", "ev_we",
                         "ev_p4chi"):
                g, w = getattr(got, name), getattr(ref, name)
                assert (g is None and w is None) or torch.equal(g, w), (
                    path, name)
            rel = max(_depth_rel(got.tau_abs, ref.tau_abs, ac[2]),
                      _depth_rel(got.tau_st, ref.tau_st, ac[3]))
            moved = int((got.tau_abs != ref.tau_abs).sum()
                        + (got.tau_st != ref.tau_st).sum())
            err = max(float((g.double() - w.double()).abs().max())
                      for g, w in ((got.tau_abs, ref.tau_abs),
                                   (got.tau_st, ref.tau_st)))
            kinds = torch.bincount(ref.ev_kind.long(), minlength=3).tolist()
            pairs, ops, bytes_ = _k1_needs(ac, kwc, ref)
            f64 = dtype == torch.float64
            bound_ms, by = bound(bytes_, ops, f64)
            bound_pr10, _ = bound(bytes_, pairs * OPS_PAIR[bool(ac[10])], f64)
            bar = DEPTH_BAR[dtype]
            moved_bar = 2 * ac[0].shape[0] if f64 else int(
                DEPTH_MOVED * 2 * ac[0].shape[0])
            ms, call_ms, plain_ms, _ = timed(
                lambda: AW.absorb_walk(*ac, **kwc),
                lambda: AW.absorb_walk_reference(*ac, **kwc))
            tag = "f64" if f64 else "f32"
            src = ("per-cell table (n_cells, cols, CC) = "
                   f"{tuple(kwc['cand'].shape)}"
                   if kwc.get("cand") is not None else
                   f"segment rows {tuple(kwc['e_table'].shape)}")
            log(29, f"K1 absorb_walk at the {path} shape, {tag}: "
                    f"{ac[0].shape[0]} photons, {ac[6].shape[0]} passes of "
                    f"B {ac[8]}, {src}: {kinds[1]} absorbed and {kinds[2]} "
                    f"stimulated events, kinds, electrons and done masks "
                    f"equal to the plain version's; depths within "
                    f"{rel:.3e} of each photon's scale (bar {bar:.3g}), "
                    f"{moved} of {2 * ac[0].shape[0]} not bitwise (bar "
                    f"{moved_bar}); {pairs} pairs needed, {ops} operations; "
                    f"kernel {ms:.4f} ms, call {call_ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}) "
                    f"[PR 10's count {bound_pr10:.4f} ms]; on {smi}")
            assert rel <= bar and moved <= moved_bar, (path, tag, rel, moved)
            # a comparison that sees no event proves nothing of the fire
            # tests: the forced-event state fires in most photons
            assert kinds[1] + kinds[2] > 0 or path != "forced-event state", \
                path
            out["absorb_walk", f"{path} shape, {tag}"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)

        # K2: the cell envelopes
        cell = store["cell_envelopes"][1]
        got = AW.cell_envelopes(cell)
        ref = AW.cell_envelopes_reference(cell)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        n = cell.shape[0]
        bound_ms, by = bound(12 * n, 2 * n, False)
        ms, call_ms, plain_ms, lib_ms = timed(
            lambda: AW.cell_envelopes(cell),
            lambda: AW.cell_envelopes_reference(cell),
            lambda: (torch.cummax(cell, 0), torch.cummin(cell.flip(0), 0)))
        ctas, tiles, stored, smem = AW.cell_envelope_plan(n)
        log(29, f"K2 cell_envelopes at the {path} shape: {n} int32 cells "
                f"({ctas} CTAs of {tiles} tiles of 128 cells, {stored} of "
                f"them in {smem} B of shared memory), both envelopes "
                f"bitwise the plain version's; kernel "
                f"{ms:.4f} ms, call {call_ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, torch.cummax + torch.cummin {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({by}); on {smi}")
        out["cell_envelopes", f"{path} shape"] = dict(
            max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)

        # K3: one invert_many call of the emission sampler
        problems = store["invert_many"][1] if "invert_many" in store else []
        for dtype in (torch.float32, torch.float64) if problems else ():
            pc = [(p, t, f.to(dtype)) for p, t, f in problems]
            got = pwmci.invert_many(pc)
            ref = pwmci.invert_many_reference(pc)
            torch.cuda.synchronize()
            for (x, ok), (xr, okr) in zip(got, ref):
                assert torch.equal(x, xr) and torch.equal(ok, okr), path
            f64 = dtype == torch.float64
            isz = 8 if f64 else 4
            nq = sum(f.shape[0] for _, _, f in pc)
            ops = sum(f.shape[0] * (p.x.shape[1] + 10
                                    + pwmci.BISECTION_ITERS * OPS_HALVING)
                      for p, _, f in pc)
            tables = sum(4 * p.x.size * isz + 8 * p.x.shape[0]
                         for p in {id(p.x): p for p, _, _ in pc}.values())
            bound_ms, by = bound(nq * (2 * isz + 9) + tables, ops, f64)
            ms, call_ms, plain_ms, _ = timed(
                lambda: pwmci.invert_many(pc),
                lambda: pwmci.invert_many_reference(pc))
            tag = "f64" if f64 else "f32"
            log(29, f"K3 invert_many at the {path} shape, {tag}: "
                    f"{len(pc)} problems, {nq} queries, every x and in_range "
                    f"bitwise the plain version's; kernel {ms:.4f} ms, call "
                    f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.6f} ms ({by}); on {smi}")
            out["invert_many", f"{path} shape, {tag}"] = dict(
                max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)
    return out


def device_init_on_card(smi: str):
    """Phase 30: the bench twin's initial state drawn on the card
    (``bench.draw``: ``species.initialize_device`` of the electrons, and
    of the empty photon buffer on the QED deck) at its default deck and
    at ``--qed --particles 2097152``, against the host draw
    ``species.initialize`` of the same deck copied to the card: the
    cells, alive masks and weights equal row for row (both place cell
    ``c``'s particles in rows ``c * npc`` on), the device draw's x in
    [0, 1) with mean 0.5 within 1e-3 and its momenta the deck's.  Each
    draw's seconds on the host clock with the card synchronised (the
    second of two calls).  Returns {deck: (device s, host s)}."""
    from opal_tpu_torch import bench
    from opal_tpu_torch import species as SP

    out = {}
    for label, argv in (("bench", []),
                        ("bench --qed", ["--qed", "--particles", "2097152"])):
        args = bench._parser().parse_args(argv)
        sim, _, species, n = bench.build(args)
        cap = species["electron"].alive.shape[0]
        npc = n // sim.geom.nx
        del species
        qed = args.qed

        def on_card():
            return bench.draw(sim, npc, cap, qed)

        if qed:
            ux = lambda x, u, r: -1000.0 * (1.0 + 0.01 * r)
        else:
            ux = lambda x, u, r: bench.BENCH_DRIFT_U * (1.0 + 0.001 * r) * \
                np.sign(u - 0.5)
        zeros = lambda x, u, r: np.zeros_like(x)

        def on_host():
            return SP.initialize(
                sim.specs["electron"], sim.geom, npc,
                lambda x: np.full_like(x, 20.0), ux, zeros, zeros,
                sim.options.dt, cap, seed=0, dtype=np.float32,
                device="cuda")

        def timed(fn):
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        dev, dev_s = timed(on_card)
        host, host_s = timed(on_host)
        e = dev["electron"]
        for name in ("cell", "alive", "weight"):
            assert torch.equal(getattr(e, name), getattr(host, name)), (
                label, name)
        alive = e.alive
        assert int(alive.sum()) == n, (label, int(alive.sum()), n)
        x = e.x[alive].double()
        assert bool(((x >= 0) & (x < 1)).all()), label
        assert abs(float(x.mean()) - 0.5) < 1e-3, (label, float(x.mean()))
        ux_abs = float(e.ux[alive].double().abs().mean())
        want = 1000.0 if qed else bench.BENCH_DRIFT_U
        assert abs(ux_abs - want) < 1e-3 * want, (label, ux_abs, want)
        if qed:
            ph = dev["photon"]
            assert ph.alive.shape[0] == cap and not bool(ph.alive.any())
        out[label] = (dev_s, host_s)
        log(30, f"{label}: {n} electrons in {cap} rows drawn on the card "
                f"(species.initialize_device) in {dev_s:.4f} s against "
                f"{host_s:.4f} s for the host draw copied to the card; "
                f"cells, alive masks and weights equal row for row, x mean "
                f"{float(x.mean()):.6f}, |ux| mean {ux_abs:.6g}; on {smi}")
        del sim, dev, e, host
        torch.cuda.empty_cache()
    return out


def misfit_fallback_kernel(smi: str):
    """Phase 31: the misfit fallback kernel (``ops.fused.misfit_fallback``)
    against its plain version at the shape of ``two_stream_128m.column``'s
    step: its field table (nx 16384) and table capacity (2048), after B1
    (lite Vay, block 8192, window 12) on 16,777,216 sorted electrons
    (1024 a cell, so that a block spans 8 or 9 cells as at the cell's
    8192) of which 15 were moved out of their window.  The columns, the slab and
    the losses within the tolerances of
    ``tests/test_torch_misfit_cuda.py``; then the kernel's device time
    (20 calls back to back), the wrapper's call and the plain version's
    (medians of 20), with an empty table and with the 15 rows, and the
    bound: the table and the rows' columns, field taps and slab taps
    once at the HBM rate, against the rows' f32 operations.  Returns
    {"empty" | "15 rows": (ms, call_ms, plain_ms, bound_ms, bound_by)}."""
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.grid import HALO, GridGeometry
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    nx, cap, n_mis = 16384, 2048, 15
    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
    st = sort_state(two_stream_state(geom, 1024, 16_777_216, dt, "cuda"),
                    nx)
    spec = F.FusedSpec(block=8192, window=12, n_rows=nx + 2 * HALO + 2 * F.PAD,
                       dx=dx, dt=dt, charge=const.ELECTRON_CHARGE,
                       mass=const.ELECTRON_MASS, row_off=HALO + F.PAD)
    anchors = F.block_anchors(spec, st.cell)
    g = torch.Generator(device="cpu").manual_seed(31)
    moved = torch.randperm(st.cell.numel(), generator=g)[:n_mis].cuda()
    st.cell[moved] = (st.cell[moved] + 12) % nx
    E = (10.0 * torch.randn(nx + 2 * HALO, 3, generator=g)).cuda()
    B = (1e-8 * torch.randn(nx + 2 * HALO, 3, generator=g)).cuda()
    eb = F.make_eb_rows(E, B)
    cols, miss, out, _ = F.fused_push_deposit(
        spec, anchors, st.cell, st.x, st.y, st.z, st.ux, st.uy, st.uz,
        st.gamma, st.weight, st.work, eb)
    mtab, losses = F.misfit_compact(miss, cap)
    assert int((mtab < st.cell.numel()).sum()) == n_mis

    def args(table):
        rows = {c: v.clone() for c, v in F.column_rows(cols, spec.block)
                .items()}
        return (spec, table, rows, st.weight, eb, E, B, out.clone(),
                losses.clone())

    ka, pa = args(mtab), args(mtab)
    F.misfit_fallback(*ka)
    F.misfit_fallback_reference(*pa[:4], *pa[5:])
    torch.cuda.synchronize()
    err = 0.0
    for c, want in pa[2].items():
        got = ka[2][c]
        if c == "cell":
            assert torch.equal(got, want), c
            continue
        e = (got - want).abs().max().item()
        assert e <= 1e-6 * want.abs().max().item(), (c, e)
        err = max(err, e)
    slab_err = (ka[7] - pa[7]).abs().max().item()
    assert slab_err <= 1e-5 * pa[7].abs().max().item(), slab_err
    assert int(ka[8]) == int(pa[8]) == 0

    empty = torch.full_like(mtab, st.cell.numel())
    out_ = {}
    for label, table, n in (("empty", empty, 0), ("15 rows", mtab, n_mis)):
        a = args(table)
        ms = device_ms(lambda: F.misfit_fallback(*a))
        call_ms = cuda_ms(lambda: F.misfit_fallback(*a))
        plain_ms = cuda_ms(lambda: F.misfit_fallback_reference(*a[:4],
                                                              *a[5:]))
        # the table; a row's 9 columns both ways, its weight, its 4 field
        # rows (8 values) and its 15 slab taps
        nbytes = 8 * cap + n * 4 * (2 * 9 + 1 + 4 * 8 + 15)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * (OPS_PUSH["vay"] + OPS_DEPOSIT) / F32_OPS_PER_S * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                              else (t_ops, "operations"))
        out_[label] = (ms, call_ms, plain_ms, bound_ms, bound_by)
        log(31, f"misfit fallback (lite Vay), table of {cap} with {n} rows, "
                f"field table {spec.n_rows} rows: kernel {ms:.4f} ms of "
                f"device time (20 calls back to back), the wrapper's call "
                f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms (medians of 20), "
                f"bound {bound_ms:.6f} ms ({bound_by}); on {smi}")
    log(31, f"kernel against plain on {n_mis} rows: columns within "
            f"{err:.3e} (max |err|), slab {slab_err:.3e}, losses equal")
    del st, cols, miss, out
    torch.cuda.empty_cache()
    return out_


def misfit_compact_kernel(smi: str):
    """Phase 32: the misfit compaction (``ops.fused.misfit_compact``)
    against its plain version, on the card, at the shapes of its callers:
    the fallback's at ``two_stream_128m.column`` (147,644,416 flags, a
    table of 2048, with no flag and with 15 at random rows), and the
    emitter compactions of ``bench --qed`` (2,621,440 flags) and of the
    colliding_beams crossing (75,776), 1% flagged and a table of every
    flagged row, as ``interactions.emit_radiation`` asks.  Tables and
    overflows must be equal.  Then the kernel's device time (20 calls
    back to back), the wrapper's call and the plain version's (medians
    of 20), the plain version being the PyTorch chain the kernel
    replaced (compare, int64 cast, cub's scan, searchsorted), so it is
    the library time too; the bound, the flags read once and the table
    written once at the HBM rate; and the device time of each of the
    three launches (``torch.profiler``, 20 calls).  Returns {label: (ms,
    call_ms, plain_ms, bound_ms, launches_us)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opal_tpu_torch import _build
    from opal_tpu_torch.ops import fused as F

    lib, _ = _build.build()
    regs = {m[1]: m[2] for m in re.finditer(
        r"Compiling entry function '\S*(misfit_\w+?_kernel)\S*'.*?"
        r"Used (\d+) registers", lib.with_suffix(".log").read_text(),
        re.S)}
    log(32, f"ptxas registers: {regs}")
    g = torch.Generator(device="cuda").manual_seed(32)
    n_cell = 147_644_416
    cell_15 = torch.zeros(n_cell, device="cuda")
    cell_15[torch.randperm(n_cell, generator=g, device="cuda")[:15]] = 1.0
    shapes = [
        ("two_stream_128m cell, no flag", torch.zeros(n_cell, device="cuda"),
         2048),
        ("two_stream_128m cell, 15 flagged", cell_15, 2048),
    ]
    for label, n in (("bench --qed emitters", 2_621_440),
                     ("colliding_beams crossing emitters", 75_776)):
        miss = (torch.rand(n, generator=g, device="cuda") < 0.01).float()
        shapes.append((f"{label}, 1% flagged", miss, int(miss.sum())))
    out = {}
    for label, miss, cap in shapes:
        k = F.misfit_compact(miss, cap)
        p = F.misfit_compact_reference(miss, cap)
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), label
        ms = device_ms(lambda: F.misfit_compact(miss, cap))
        call_ms = cuda_ms(lambda: F.misfit_compact(miss, cap))
        plain_ms = cuda_ms(lambda: F.misfit_compact_reference(miss, cap))
        bound_ms = (4 * miss.numel() + 8 * cap) / HBM_BYTES_PER_S * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                F.misfit_compact(miss, cap)
            torch.cuda.synchronize()
        launches_us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "misfit_" in e.name:
                key = re.search(r"misfit_\w+?_kernel", e.name)[0]
                launches_us[key] = launches_us.get(key, 0.0) + (
                    e.time_range.end - e.time_range.start) / 20
        out[label] = (ms, call_ms, plain_ms, bound_ms, launches_us)
        log(32, f"misfit compaction, {label}: {miss.numel()} flags, table "
                f"of {cap}: kernel {ms:.4f} ms of device time (20 calls "
                f"back to back; {100 * bound_ms / ms:.1f}% of its bound), "
                f"the wrapper's call {call_ms:.4f} ms, plain (the torch "
                f"chain) {plain_ms:.4f} ms (medians of 20), bound "
                f"{bound_ms:.6f} ms (bytes); launches (us): "
                + ", ".join(f"{n} {t:.2f}" for n, t in launches_us.items())
                + f"; tables equal; on {smi}")
    del shapes, cell_15, miss
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", metavar="DIR", type=Path, default=None,
        help="instead of phases 3-12, run the CLI drive of --profile-deck "
             "with the CLI's --profile of its last block into DIR: phase 8 "
             "over 120 output blocks, or phase 11 cut to the crossing")
    parser.add_argument(
        "--profile-deck", choices=("hole_boring", "colliding_beams"),
        default="hole_boring")
    parser.add_argument(
        "--ranks", type=int, default=0, metavar="N",
        help="instead of phases 3-28, run the decks on N cards against "
             "one card (phase 27); exits 1 with fewer than N cards")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.ranks and torch.cuda.device_count() < args.ranks:
        print(f"chip_smoke: --ranks {args.ranks} needs {args.ranks} CUDA "
              f"devices and this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from opal_tpu_torch import _build
    from opal_tpu_torch import constants as const
    from opal_tpu_torch.grid import HALO, GridGeometry
    from opal_tpu_torch.ops import fused as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(1, f"device {name}, torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}, nvidia-smi: {smi}")

    lib, seconds = _build.build()
    report = ptxas_report(lib.with_suffix(".log").read_text())
    forms = (*F.FORMS, *QED_FORMS)
    assert set(report) == set(forms), report
    _build.library()
    log(2, f"built {lib.name} in {seconds:.1f} s; ptxas: " + "; ".join(
        f"{form} {report[form]}" for form in forms))
    atomics = sass_atomics(lib)
    log(2, "atomics in the SASS (cuobjdump -sass): " + (
        "cuobjdump not found" if atomics is None else "; ".join(
            f"{form} {atomics.get(form, {})}" for form in forms)))
    if args.ranks:
        rows = ranks_drive(args.ranks, smi)
        print(json.dumps({"ranks": rows}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.profile is not None:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            if args.profile_deck == "hole_boring":
                hb_cli_drive(tmp, smi, outputs=120, profile=args.profile)
            else:
                cb_cli_drive(tmp, smi, profile=args.profile)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0

    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    shapes = [
        ("bench shape", BENCH["nx"], BENCH["particles"] // BENCH["nx"],
         10_485_760, BENCH["block"], BENCH["window"]),
        ("two_stream CLI shape", 1000, 100, 155_648, 2048, 40),
    ]
    results = {}
    for label, nx, npc, cap, block, window in shapes:
        geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
        st = two_stream_state(geom, npc, cap, dt, "cuda")
        spec = F.FusedSpec(
            block=block, window=window, n_rows=nx + 2 * HALO + 2 * F.PAD,
            dx=dx, dt=dt, charge=const.ELECTRON_CHARGE,
            mass=const.ELECTRON_MASS, row_off=HALO + F.PAD,
        )
        results[label] = kernel_vs_plain(label, st, spec)
        del st
        torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        card_vs_cpu(tmp)
        ts_launches, ts_rate, ts_alive, _ = cli_drive(tmp)
        bench_scale(smi)
        hb = hole_boring_kernels()
        hb_card_vs_cpu(tmp)
        hb_launches = hb_cli_drive(tmp, smi)
        cb = colliding_beams_kernels()
        qed_card_vs_cpu(tmp)
        cb_launches = cb_cli_drive(tmp, smi)
        cb_ledger(smi)
        b2 = packed_kernels()
        card_vs_cpu(tmp, packed=True)
        hb_packed = hb_card_vs_cpu(tmp, packed=True)
        twin, twin_values = bench_twin(smi)
        ts_packed, *_ = cli_drive(tmp, steps=1000, packed=True)
        stress_kernels()
        cross_sections_card_vs_cpu()
        _, captured_19 = absorb_card_vs_cpu()
        full_dep = full_deposit_kernels()
        qtwin, captured_21 = qed_bench_twin(smi)
        cb_abs_launches, _, _, captured_22 = cb_absorption_drive(tmp, smi)
        field_setup_card_vs_cpu()
        resume = hb_resume_drive(tmp, smi)
        qed_resume_on_card(tmp)
        ts_group, twin_group = dist_world_one(tmp, smi, ts_rate, ts_alive,
                                              twin_values["vay"])
        rep_launches, rep_qed = replicated_absorb_on_card(tmp, smi)
        qk = qed_kernels({"bench --qed": captured_21,
                          "colliding_beams crossing": captured_22,
                          "forced-event state": captured_19}, smi)
        del captured_19, captured_21, captured_22
        device_init_on_card(smi)
        fallback = misfit_fallback_kernel(smi)
        compaction = misfit_compact_kernel(smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # each form at the shape of the latest main path that runs it; the
    # lite Vay error covers the earlier shapes too
    err_vay = max(results[k][0] for k in results)
    by_path = {
        "vay": {"two_stream": ts_launches, "hole_boring": hb_launches["vay"],
                "hole_boring resume, with its NCCL world of 1":
                    resume["vay"],
                "two_stream world of 1 under NCCL": ts_group,
                "bench world of 1 under NCCL": twin_group},
        "boris": {"hole_boring": hb_launches["boris"],
                  "hole_boring resume, with its NCCL world of 1":
                      resume["boris"]},
        "vay_full_dep_skip": {
            "colliding_beams": cb_launches["vay_full_dep_skip"],
            "colliding_beams with absorption":
                cb_abs_launches["vay_full_dep_skip"],
            "small absorption deck, replicated over 2 gloo ranks":
                rep_launches},
        "vay_full": {label: qtwin[label][0] for label in (
            "bench --qed", "bench --qed --no-absorption")},
        "vay_packed": {"two_stream packed": ts_packed,
                       "bench --packed": twin["vay_packed"],
                       "small hole_boring packed": hb_packed["vay_packed"]},
        "boris_packed": {
            "small hole_boring packed": hb_packed["boris_packed"]},
        "vay_packed_dep_skip": {
            "bench --packed --no-deposition": twin["vay_packed_dep_skip"]},
    }
    timed = {
        "vay": (hb["vay"], "lite Vay, electrons, deposit on"),
        "boris": (hb["boris"], "lite Boris, ions, deposit on"),
        "vay_full_dep_skip": (cb["vay_full_dep_skip"],
                              "full Vay, QED electrons, deposit off"),
        "vay_full": (full_dep["bench --qed"],
                     "full Vay, deposit on, bench --qed shape"),
        "vay_full (bench --no-lite shape)": (
            full_dep["bench --no-lite"],
            "full Vay, deposit on, bench --no-lite shape"),
        "vay_dep_skip": (cb["vay_dep_skip"], "lite Vay, deposit off"),
        "boris_dep_skip": (cb["boris_dep_skip"], "lite Boris, deposit off"),
        "vay_packed": (b2["bench", "vay_packed"],
                       "packed layout, Vay, deposit on, bench shape"),
        "vay_packed_dep_skip": (b2["bench", "vay_packed_dep_skip"],
                                "packed layout, Vay, deposit off, bench shape"),
        "boris_packed": (b2["hole_boring", "boris_packed"],
                         "packed layout, Boris, ions, deposit on"),
        "boris_packed_dep_skip": (b2["hole_boring", "boris_packed_dep_skip"],
                                  "packed layout, Boris, deposit off"),
    }

    # a form timed at a second shape of its paths, with that path's
    # launches
    other_shapes = {"vay_full (bench --no-lite shape)": {
        "bench --no-lite": qtwin["bench --no-lite"][0]}}

    def row(key):
        (err, ms, plain_ms, bound_ms, bound_by, call_ms), label = timed[key]
        form = key.split()[0]
        if form == "vay":
            err = max(err, err_vay)
        paths = by_path.get(key, other_shapes.get(key, {}))
        kernel = KERNEL_PACKED if "packed" in form else KERNEL
        name = "fused_push_deposit_packed" if "packed" in form else \
            "fused_push_deposit"
        return dict(name=f"{name}[{form}] ({label})", **kernel,
                    launches=sum(paths.values()), launches_by_path=paths,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    call_ms=call_ms)

    # K1-K3 by the paths that launch them; the crossing's kernel at the
    # bench --qed shape, the sampler's at the colliding_beams crossing
    qed_paths = {
        k: {"colliding_beams": cb_launches[k],
            "colliding_beams with absorption": cb_abs_launches[k],
            "bench --qed": qtwin["bench --qed"][2][f"{k}_launches"],
            "bench --qed --no-absorption":
                qtwin["bench --qed --no-absorption"][2][f"{k}_launches"],
            "small absorption deck, replicated over 2 gloo ranks":
                rep_qed[k]}
        for k in QED_KERNELS}
    qed_main = {"absorb_walk": "bench --qed shape, f32",
                "cell_envelopes": "bench --qed shape",
                "invert_many": "colliding_beams crossing shape, f32"}

    shape_paths = {
        "bench --qed": ("bench --qed", "bench --qed --no-absorption"),
        "colliding_beams crossing": ("colliding_beams",
                                     "colliding_beams with absorption")}

    def qed_row(kernel, label):
        paths = {p: n for p, n in qed_paths[kernel].items() if n}
        if label != qed_main[kernel]:
            # a second shape: the launches of its paths; f64 and phase
            # 19's state have none
            shape, _, tag = label.partition(" shape")
            paths = {} if tag.endswith("f64") else {
                p: paths[p] for p in shape_paths.get(shape, ()) if p in paths}
        return dict(name=f"{kernel} ({label})", **QED_KERNELS[kernel],
                    launches=sum(paths.values()), launches_by_path=paths,
                    **qk[kernel, label])

    # the forms no shipped deck's main path reaches are held against their
    # plain versions all the same, and listed apart
    print(json.dumps({
        "kernels": [row(f) for f in by_path]
        + [qed_row(k, label) for k, label in qed_main.items()],
        "other_shapes": [row(f) for f in other_shapes]
        + [qed_row(k, label) for k, label in qk
           if label != qed_main[k]],
        "forms_off_path": [row(f) for f in timed
                           if f not in by_path and f not in other_shapes],
        "misfit_fallback": [
            dict(name=f"misfit_fallback[vay] (table of 2048, {label})",
                 route="cuda", source=KERNEL["source"],
                 replaces="opal_tpu/sim.py:628", ms=ms, call_ms=call_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            for label, (ms, call_ms, plain_ms, bound_ms, bound_by)
            in fallback.items()],
        "misfit_compact": [
            dict(name=f"misfit_compact ({label})", route="cuda",
                 source="opal_tpu_torch/csrc/misfit_compact.cu",
                 replaces=None, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by="bytes", library_ms=plain_ms,
                 launches_us=launches_us)
            for label, (ms, call_ms, plain_ms, bound_ms, launches_us)
            in compaction.items()],
    }))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
