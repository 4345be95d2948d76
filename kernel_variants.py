"""Time variants of the fused kernel, or of the absorption walk's, on one
NVIDIA GPU.

    python3 kernel_variants.py base threads=256 segments=4 nosum cheaptaps
    python3 kernel_variants.py threads=512,segments=16 base
    python3 kernel_variants.py --walk base window=16 threads=128
    python3 kernel_variants.py --envelope base threads=256 mintiles=4 nokeep

Each argument is one variant of ``opal_tpu_torch/csrc/fused_push_deposit.cu``:
``base`` (the source as it is), or edits joined by commas:

* ``threads=N``: N threads a CTA (``kThreads``);
* ``segments=N``: N tile rows summed with shuffles in one row step before
  the remaining lanes add their own taps (``kMaxSegments``);
* ``minblocks=N``: ``__launch_bounds__(kThreads, N)``, which caps the
  registers so that N CTAs fit an SM;
* ``nosum``: the deposit's taps are computed but not summed (a
  diagnostic: the slab stays zero);
* ``noother``: rows in the warp's current tile row are summed, the
  others dropped (a diagnostic: the cost of the other tile rows' sums);
* ``cheaptaps``: the deposit sums as it does, but taps of one product
  each in place of the fluxes and b-spline weights (a diagnostic).

For each variant a copy of the package with the edited source is built
in a temporary directory, and a child process times the kernel forms
there (device time of one call, as ``chip_smoke.py``'s ``device_ms``):
B1 lite Vay with and without the deposit and B2 ``vay_packed`` with and
without it at the bench shape (and lite Vay on two cells alternating
row by row), the same at the two_stream CLI shape (and lite Vay on rows
shuffled within each block), and the hole_boring electrons (lite Vay,
``work_inc``) and carbon ions (lite Boris).  Unless a diagnostic edit is
in it, each timed deposit form is first held against its plain version
(push columns, miss and anchors bitwise, the slab within 1e-5 of its
scale).  One JSON line a variant, with each form's ptxas registers;
compare variants within one call only.  Needs a card: without one it
exits 1.

With ``--walk`` each variant is one of ``opal_tpu_torch/csrc/absorb_walk.cu``
(kernel K1, the whole absorption walk): ``base``, or edits joined by
commas:

* ``threads=N``: N threads (N / 32 warps) a CTA (``kThreads``);
* ``minblocks=N``: N CTAs an SM in ``__launch_bounds__`` (``kMinBlocks``,
  which caps the registers);
* ``window=N``: N candidate slots of each photon screened a round
  before the warp computes their valid ones (``kWindow``: 8, 16 or 32).

The walk's arguments are captured once, before the variants: the largest
walk of ``python -m opal_tpu_torch.bench --qed --particles 2097152
--steps 50``, of ``chip_smoke.py``'s colliding_beams crossing with
absorption (phase 22) and of one ``absorb`` call on its forced-event
state (bracketed, compaction 2048, the per-cell table).  A first line
gives their shape: the photon-passes by their count of valid candidates,
and the valid pairs by the Airy branch of each cross section (the
series below 1, the quadrature branches from 1, 2 and 10, none past 50
or where the plain code zeroes the pair).  Each variant is held against
the plain walk on them (events equal, depths within one ulp at f32
and 1e-14 at f64 of each photon's scale) and timed (device time of one
call), as captured (f32) and at f64, and as captured with each group of
photons a warp (1-32; events equal to the default group's).  With ``--groups`` (on the source
as it is, no variant) the sampler's largest ``invert_many`` call of that
run, and the same cut to 2,370 queries, are timed at each lane group of
kernel K3 (1-32 lanes a query), each bitwise the plain version.

With ``--envelope`` each variant is one of
``opal_tpu_torch/csrc/cell_envelope.cu`` (kernel K2, the bracketed
mode's cell envelopes in one cooperative launch): ``base``, or edits
joined by commas:

* ``threads=N``: N threads a CTA (``kThreads``: 256, 512 or 1024);
* ``ctas=N``: at most N CTAs an SM (``kMaxCtasPerSm``);
* ``mintiles=N``: at least N tiles of 128 cells a CTA while the grid
  could be larger (``kMinTiles``, a tile a warp);
* ``nokeep``: no tile kept in shared memory, every cell read twice from
  global memory (a diagnostic: what the kept chunk saves).

Each variant is held bitwise against the plain version and timed
(device time of one call, and the call's time with its host launch, as
``chip_smoke.py``'s ``device_ms`` and ``cuda_ms``) on the cells of the
``bench --qed`` shape (2,621,440 rows: 2,097,152 electrons sorted over
16,392 cells, then dead rows in cell 4) and of the colliding_beams
crossing (75,776 rows, 50,000 of them alive over 4212 cells), and on
16,777,216 random cells; with each shape's launch plan.  With
``--envelope-parent DIR`` the kernel of the checkout DIR (an earlier
commit, as it is) is timed the same way before the variants and again
after them.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = Path("opal_tpu_torch") / "csrc" / "fused_push_deposit.cu"
WALK_SOURCE = Path("opal_tpu_torch") / "csrc" / "absorb_walk.cu"
ENVELOPE_SOURCE = Path("opal_tpu_torch") / "csrc" / "cell_envelope.cu"
CONSTANTS = {"threads": "kThreads", "segments": "kMaxSegments"}
DIAGNOSTICS = ("nosum", "noother", "cheaptaps")
# the deposit's 15 taps, and its summing from the warp vote to the
# closing braces of the deposit block and the row loop
_TAPS = re.compile(r" +v\[0\] = qf \* flux\(.*?"
                   r" +v\[14\] = qx \* w_q;\n", re.S)
_SUMS = re.compile(r"      if \(!__all_sync\(kFullMask.*?"
                   r"(?=  if constexpr \(kDeposit\) flush\(\);)", re.S)
# taps that stay live (a condition the compiler cannot decide) but are
# never added
_NOSUM = """\
      if (key != kNoKey && k.kx == -1.0f) {
#pragma unroll
        for (int c = 0; c < kCols - 1; ++c)
          atomicAdd(tile + key * kCols + c, v[c]);
      }
    }
  }
"""
_CHEAPTAPS = """\
#pragma unroll
    for (int c = 0; c < kCols - 1; ++c) v[c] = q * (float)(c + 1);
"""


def edit_walk(src: str, variant: str) -> str:
    """The walk kernel's source ``src`` with the edits of ``variant``
    made; raises if an edit is unknown or no longer applies."""
    for e in variant.split(","):
        name, _, value = e.partition("=")
        if name == "base":
            continue
        if name == "threads":
            src, n = re.subn(r"constexpr int kThreads = \d+;",
                             f"constexpr int kThreads = {int(value)};", src)
        elif name == "minblocks":
            src, n = re.subn(r"constexpr int kMinBlocks = \d+;",
                             f"constexpr int kMinBlocks = {int(value)};",
                             src)
        elif name == "window" and int(value) in (8, 16, 32):
            src, n = re.subn(r"constexpr int kWindow = \d+;",
                             f"constexpr int kWindow = {int(value)};", src)
        else:
            raise ValueError(f"unknown edit {e!r}")
        if n != 1:
            raise ValueError(f"edit {e!r} does not apply to {WALK_SOURCE}")
    return src


def edit_envelope(src: str, variant: str) -> str:
    """The envelope kernel's source ``src`` with the edits of ``variant``
    made; raises if an edit is unknown or no longer applies."""
    for e in variant.split(","):
        name, _, value = e.partition("=")
        if name == "base":
            continue
        if name == "threads" and int(value) in (256, 512, 1024):
            src, n = re.subn(r"constexpr int kThreads = \d+;",
                             f"constexpr int kThreads = {int(value)};", src)
        elif name == "mintiles":
            src, n = re.subn(r"constexpr int kMinTiles = [^;]+;",
                             f"constexpr int kMinTiles = {int(value)};", src)
        elif name == "ctas":
            src, n = re.subn(r"constexpr int kMaxCtasPerSm = [^;]+;",
                             f"constexpr int kMaxCtasPerSm = {int(value)};",
                             src)
        elif name == "nokeep":
            old = "    plan[2] = (smem - meta) / (kTile * 4);"
            n = src.count(old)
            src = src.replace(old, "    plan[2] = 0;")
        else:
            raise ValueError(f"unknown edit {e!r}")
        if n != 1:
            raise ValueError(f"edit {e!r} does not apply to "
                             f"{ENVELOPE_SOURCE}")
    return src


def envelope_cells() -> dict:
    """{shape: int32 cells on the card} of the module's docstring."""
    import numpy as np

    rng = np.random.default_rng(29)
    out = {}
    for shape, rows, alive, cells in (("bench --qed", 2_621_440, 2_097_152,
                                       16_392),
                                      ("colliding_beams crossing", 75_776,
                                       50_000, 4212)):
        c = np.full(rows, 4, np.int32)
        c[:alive] = np.sort(rng.integers(4, cells - 4, alive))
        out[shape] = c
    out["16,777,216 random cells"] = rng.integers(
        -5, 4000, 16_777_216).astype(np.int32)
    return {k: torch.from_numpy(v).cuda() for k, v in out.items()}


def time_envelopes() -> dict:
    """The child's work with ``--envelope``: build the envelope kernel of
    this tree, hold it against its plain version and time it."""
    import chip_smoke as C
    from opal_tpu_torch import _build
    from opal_tpu_torch.ops import absorb_walk as AW

    lib, _ = _build.build()
    _build.library()
    regs = C.ptxas_report(lib.with_suffix(".log").read_text())
    # an earlier tree's kernels (--envelope-parent) have other names and
    # no plan
    out = {"registers": {f: r for f, r in regs.items()
                         if f.startswith("cell_envelope")}}
    plan = getattr(AW, "cell_envelope_plan", None)
    for shape, cell in envelope_cells().items():
        got = AW.cell_envelopes(cell)
        ref = AW.cell_envelopes_reference(cell)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
            shape
        if plan is not None:
            out[f"{shape}: plan"] = plan(cell.shape[0])
        out[f"{shape}: ms"] = C.device_ms(lambda: AW.cell_envelopes(cell))
        out[f"{shape}: call ms"] = C.cuda_ms(lambda: AW.cell_envelopes(cell))
    return out


def edit(src: str, variant: str) -> str:
    """The kernel source ``src`` with the edits of ``variant`` made;
    raises if an edit is unknown or no longer applies to the source."""
    for e in variant.split(","):
        name, _, value = e.partition("=")
        if name == "base":
            continue
        if name in CONSTANTS:
            const = CONSTANTS[name]
            src, n = re.subn(rf"constexpr int {const} = \d+;",
                             f"constexpr int {const} = {int(value)};", src)
        elif name == "minblocks":
            src, n = re.subn(r"__launch_bounds__\(kThreads\)",
                             f"__launch_bounds__(kThreads, {int(value)})", src)
        elif name == "nosum":
            src, n = _SUMS.subn(_NOSUM, src)
        elif name == "noother":
            old = "const int other = key == cur ? kNoKey : key;"
            n = src.count(old)
            src = src.replace(old, "const int other = kNoKey;")
        elif name == "cheaptaps":
            src, n = _TAPS.subn(_CHEAPTAPS, src)
        else:
            raise ValueError(f"unknown edit {e!r}")
        if n != 1:
            raise ValueError(f"edit {e!r} does not apply to {SOURCE}")
    return src


def time_forms(check: bool) -> dict:
    """The child's work: build the kernel of this tree and time its forms
    (see the module's docstring)."""
    import chip_smoke as C
    from opal_tpu_torch import _build, constants as const
    from opal_tpu_torch.cli import build
    from opal_tpu_torch.grid import HALO, GridGeometry
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel.migrate import sort_state

    lib, _ = _build.build()
    _build.library()
    regs = C.ptxas_report(lib.with_suffix(".log").read_text())
    out = {"registers": {f: int(r.split()[0]) for f, r in regs.items()}}

    def column(label, spec, st, eb):
        anchors = F.block_anchors(spec, st.cell)
        work = st.work if spec.work_out and not spec.work_inc else None
        args = (spec, anchors, st.cell, st.x, st.y, st.z, st.ux, st.uy,
                st.uz, st.gamma, st.weight, work, eb)
        if check and not spec.dep_skip:
            ck, mk, ok, ak = F.fused_push_deposit(*args)
            cr, mr, orf, ar = F.fused_push_deposit_reference(*args)
            assert torch.equal(mk, mr) and torch.equal(ak, ar), label
            assert all(torch.equal(ck[c], cr[c]) for c in cr), label
            scale = orf.abs().max().item()
            assert (ok - orf).abs().max().item() <= 1e-5 * scale, label
        out[label] = C.device_ms(lambda: F.fused_push_deposit(*args))

    def packed(label, spec, st, eb):
        ps = F.pack_fused(st, spec.block)
        anchors = F.block_anchors(spec, ps.h[:, 0].reshape(-1))
        args = (spec, anchors, ps.h, ps.weight, eb)
        if check and not spec.dep_skip:
            Hk, Ak, ok, ak = F.fused_push_deposit_packed(*args)
            Hr, Ar, orf, ar = F.fused_push_deposit_packed_reference(*args)
            assert torch.equal(Hk, Hr) and torch.equal(Ak, Ar), label
            assert torch.equal(ak, ar), label
            scale = orf.abs().max().item()
            assert (ok - orf).abs().max().item() <= 1e-5 * scale, label
        out[label] = C.device_ms(
            lambda: F.fused_push_deposit_packed(*args))

    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    for shape, nx, npc, cap, block, window, order in (
        ("bench", C.BENCH["nx"], C.BENCH["particles"] // C.BENCH["nx"],
         10_485_760, C.BENCH["block"], C.BENCH["window"],
         C.STRESS_ORDERS[2]),
        ("two_stream", 1000, 100, 155_648, 2048, 40, C.STRESS_ORDERS[0]),
    ):
        geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
        st = sort_state(C.two_stream_state(geom, npc, cap, dt, "cuda"), nx)
        spec = F.FusedSpec(
            block=block, window=window, n_rows=nx + 2 * HALO + 2 * F.PAD,
            dx=dx, dt=dt, charge=const.ELECTRON_CHARGE,
            mass=const.ELECTRON_MASS, row_off=HALO + F.PAD,
        )
        eb = C._random_table(spec, "cuda", 1, 10.0, 1e-8)
        skip = spec._replace(dep_skip=True)
        column(f"{shape} vay", spec, st, eb)
        column(f"{shape} vay_dep_skip", skip, st, eb)
        packed(f"{shape} vay_packed", spec, st, eb)
        packed(f"{shape} vay_packed_dep_skip", skip, st, eb)
        column(f"{shape} vay, {order}", spec,
               C.stress_state(st, block, window, order), eb)
        del st
        torch.cuda.empty_cache()
    sim, states, _ = build(ROOT / "examples" / "hole_boring.yaml",
                           device="cuda")
    for name, st in states.items():
        spec = sim._fused_spec(name)
        st = sort_state(st, sim.geom.n_loc)
        eb = C._random_table(spec, "cuda", 2, 1e13, 3e4)
        column(f"hole_boring {F.form_name(spec)}", spec, st, eb)
    return out


def capture_walks(path: Path):
    """Saves to ``path`` the walk arguments of the module's docstring, as
    ``{state: (args, kwargs)}`` of CUDA tensors; returns the ``bench
    --qed`` run's largest ``invert_many`` problems."""
    import contextlib
    import io
    from types import SimpleNamespace

    import chip_smoke as C
    from opal_tpu_torch import bench
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.grid import GridGeometry

    walks = {}
    store = {}
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()), C.capture_qed(store):
        rc = bench.main(["--qed", "--particles", "2097152", "--steps", "50"])
    assert rc == 0, rc
    walks["bench --qed"] = store["absorb_walk"][1]
    inversions = store["invert_many"][1]
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variants_cb_"))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            *_, store = C.cb_absorption_drive(tmp, C.nvidia_smi())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walks["colliding_beams crossing"] = store["absorb_walk"][1]
    presorted, bracketed = C.ABSORB_MODES["bracketed"]
    e, ph = C.forced_absorb_state("bracketed")
    opt = C._absorb_opts(2048)
    sim = SimpleNamespace(geom=GridGeometry(nx=4096, dx=1e-6, xmin=0.0,
                                            n_devices=1), options=opt)
    sp = {"electron": state_from_numpy(e, device="cuda"),
          "photon": state_from_numpy(ph, device="cuda")}
    store = {}
    with C.capture_qed(store):
        I.absorb(sim, sp, 1e-15,
                 C._absorb_draws(opt, len(e["x"]), len(ph["x"]), 1, 5),
                 presorted=presorted, bracketed=bracketed)
    walks["forced-event state"] = store["absorb_walk"][1]
    torch.save(walks, path)
    return inversions


def walk_shape(a, kw) -> dict:
    """The walk's photon-passes by their valid candidates (0, 1-31, all
    32) and its valid pairs by the Airy branch each cross section takes
    (``series``, ``quad1``, ``quad2``, ``quad10``, ``none``), at f64
    (the per-cell table's walks)."""
    import chip_smoke as C

    k4, chi, cell, r = a[0], a[1], a[4], a[6]
    B, nb, cand = a[8], r.shape[0], kw["cand"]
    by_valid = [0, 0, 0]
    branch = {s: dict.fromkeys(("series", "quad1", "quad2", "quad10",
                                "none"), 0) for s in ("abs", "st")}
    for bi in range(nb):
        rows = cand[cell, bi * B:(bi + 1) * B]
        valid = rows[..., 6] > 0.5
        n = valid.sum(1)
        by_valid[0] += int((n == 0).sum())
        by_valid[1] += int(((n > 0) & (n < B)).sum())
        by_valid[2] += int((n == B).sum())
        for s, (kept, x) in C.airy_arguments(k4, chi, rows, True).items():
            ok, x = (kept & (x >= 0) & (x < 50))[valid], x[valid]
            branch[s]["none"] += int((~ok).sum())
            for name, lo, hi in (("series", -1.0, 1.0), ("quad1", 1.0, 2.0),
                                 ("quad2", 2.0, 10.0), ("quad10", 10.0, 50.0)):
                branch[s][name] += int((ok & (x >= lo) & (x < hi)).sum())
    return dict(photon_passes_by_valid={"0": by_valid[0], f"1-{B - 1}":
                                        by_valid[1], str(B): by_valid[2]},
                pairs_by_airy_branch=branch)


def time_groups(inversions) -> dict:
    """K3's device time (as ``chip_smoke.py``'s ``device_ms``) at each
    lane group on the ``bench --qed`` run's largest ``invert_many``
    problems and on them cut to 2,370 queries, each bitwise the plain
    version."""
    import chip_smoke as C
    from opal_tpu_torch.qed import pwmci

    total = sum(f.shape[0] for _, _, f in inversions)
    keep = 2370 / total
    cut = [(p, t[:max(1, round(keep * len(t)))], f[:max(1, round(keep *
                                                              len(f)))])
           for p, t, f in inversions]
    out = {}
    for label, problems in (("bench --qed", inversions),
                            ("2370 queries", cut)):
        nq = sum(f.shape[0] for _, _, f in problems)
        ref = pwmci.invert_many_reference(problems)
        for g in (1, 2, 4, 8, 16, 32):
            got = pwmci.invert_many(problems, group=g)
            for (x, ok), (xr, okr) in zip(got, ref):
                assert torch.equal(x, xr) and torch.equal(ok, okr), (label, g)
            out[f"{label} ({nq} queries), group {g}"] = C.device_ms(
                lambda: pwmci.invert_many(problems, group=g))
        out[f"{label}: default group"] = pwmci.inversion_group(nq)
    return out


def time_walks(path: Path) -> dict:
    """The child's work with ``--walk``: build the walk kernel of this
    tree, hold it against its plain version on the saved arguments and
    time it."""
    import chip_smoke as C
    from opal_tpu_torch import _build
    from opal_tpu_torch.ops import absorb_walk as AW

    lib, _ = _build.build()
    _build.library()
    regs = C.ptxas_report(lib.with_suffix(".log").read_text())
    out = {"registers": {f: int(r.split()[0]) for f, r in regs.items()
                         if f.startswith("absorb_walk")}}
    for state, (a, kw) in torch.load(path).items():
        for dtype in (torch.float32, torch.float64):
            ac, kwc = C._cast_floats(a, dtype), C._cast_floats(kw, dtype)
            got = AW.absorb_walk(*ac, **kwc)
            ref = AW.absorb_walk_reference(*ac, **kwc)
            for name in ("ev_kind", "ev_idx", "done"):
                assert torch.equal(getattr(got, name), getattr(ref, name)), (
                    state, name)
            rel = max(C._depth_rel(got.tau_abs, ref.tau_abs, ac[2]),
                      C._depth_rel(got.tau_st, ref.tau_st, ac[3]))
            assert rel <= C.DEPTH_BAR[dtype], (state, rel)
            tag = "f64" if dtype == torch.float64 else "f32"
            out[f"{state}, {tag}"] = C.device_ms(
                lambda: AW.absorb_walk(*ac, **kwc))
        want = AW.absorb_walk(*a, **kw)
        for g in (1, 2, 4, 8, 16, 32):
            got = AW.absorb_walk(*a, **kw, group=g)
            assert torch.equal(got.ev_kind, want.ev_kind), (state, g)
            out[f"{state}, group {g}"] = C.device_ms(
                lambda: AW.absorb_walk(*a, **kw, group=g))
        out[f"{state}: default group"] = AW.walk_group(a[0].shape[0])
    return out


def run_variant(variant: str, walks: Path | None = None,
                envelope: bool = False, root: Path = ROOT) -> dict:
    """Build ``variant`` in a temporary copy of the package of ``root``
    (this tree, or the checkout of ``--envelope-parent``) and time it in
    a child process (the walk's, on the arguments saved at ``walks``, if
    given; the envelope kernel's with ``envelope``); returns its JSON
    line as a dict."""
    source, editor = (ENVELOPE_SOURCE, edit_envelope) if envelope else (
        (SOURCE, edit) if walks is None else (WALK_SOURCE, edit_walk))
    src = editor((root / source).read_text(), variant)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variant_"))
    try:
        shutil.copytree(root / "opal_tpu_torch", tmp / "opal_tpu_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copytree(root / "examples", tmp / "examples")
        shutil.copy(root / "chip_smoke.py", tmp / "chip_smoke.py")
        shutil.copy(ROOT / "kernel_variants.py", tmp / "kernel_variants.py")
        (tmp / source).write_text(src)
        check = not any(d in variant.split(",") for d in DIAGNOSTICS)
        mode = ["--time-envelopes"] if envelope else ["--time"] + (
            ["--check"] if check else []) if walks is None else [
            "--time-walks", str(walks)]
        res = subprocess.run(
            [sys.executable, str(tmp / "kernel_variants.py"), *mode],
            capture_output=True, text=True, timeout=900, cwd=tmp)
        if res.returncode != 0:
            raise RuntimeError(f"variant {variant!r} failed:\n"
                               f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        return dict(variant=variant, checked=check,
                    **json.loads(res.stdout.strip().splitlines()[-1]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", default=["base"])
    parser.add_argument("--time", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--check", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--walk", action="store_true",
                        help="variants of the absorption walk's kernel")
    parser.add_argument("--groups", action="store_true",
                        help="with --walk: time kernel K3's lane groups too")
    parser.add_argument("--time-walks", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--envelope", action="store_true",
                        help="variants of the cell envelopes' kernel")
    parser.add_argument("--envelope-parent", type=Path, metavar="DIR",
                        help="with --envelope: time the envelope kernel of "
                             "the checkout DIR (an earlier commit) too, "
                             "before the variants and after them")
    parser.add_argument("--time-envelopes", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.time:
        print(json.dumps(time_forms(args.check)))
        return 0
    if args.time_walks:
        print(json.dumps(time_walks(args.time_walks)))
        return 0
    if args.time_envelopes:
        print(json.dumps(time_envelopes()))
        return 0
    for variant in args.variants:
        # refuse before building
        if args.envelope:
            edit_envelope((ROOT / ENVELOPE_SOURCE).read_text(), variant)
        elif args.walk:
            edit_walk((ROOT / WALK_SOURCE).read_text(), variant)
        else:
            edit((ROOT / SOURCE).read_text(), variant)
    import chip_smoke as C

    print(C.nvidia_smi(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variants_walks_"))
    try:
        walks = None
        if args.walk:
            from opal_tpu_torch import _build

            _build.library()
            walks = tmp / "walks.pt"
            inversions = capture_walks(walks)
            shapes = {state: walk_shape(a, kw)
                      for state, (a, kw) in torch.load(walks).items()}
            print(json.dumps({"walk shapes": shapes}), flush=True)
            if args.groups:
                print(json.dumps({"inversion groups": {
                    k: round(v, 4) if isinstance(v, float) else v
                    for k, v in time_groups(inversions).items()}}),
                    flush=True)
        runs = [(v, ROOT) for v in args.variants]
        if args.envelope and args.envelope_parent:
            parent = ("base", args.envelope_parent.resolve())
            runs = [parent, *runs, parent]
        for variant, root in runs:
            line = run_variant(variant, walks, args.envelope, root)
            if root != ROOT:
                line["tree"] = str(args.envelope_parent)
            print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                              for k, v in line.items()}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
