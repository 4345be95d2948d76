"""Time variants of the fused kernel on one NVIDIA GPU.

    python3 kernel_variants.py base threads=256 segments=4 nosum cheaptaps
    python3 kernel_variants.py threads=512,segments=16 base

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
CONSTANTS = {"threads": "kThreads", "segments": "kMaxSegments"}
DIAGNOSTICS = ("nosum", "noother", "cheaptaps")
# the deposit's 15 taps, and its summing from the warp vote to the
# closing braces of the deposit block and the row loop
_TAPS = re.compile(r"    v\[0\] = qf \* flux\(.*?"
                   r"    v\[14\] = qx \* w_q;\n", re.S)
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


def run_variant(variant: str) -> dict:
    """Build ``variant`` in a temporary copy of the package and time it
    in a child process; returns its JSON line as a dict."""
    src = edit((ROOT / SOURCE).read_text(), variant)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_variant_"))
    try:
        shutil.copytree(ROOT / "opal_tpu_torch", tmp / "opal_tpu_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copytree(ROOT / "examples", tmp / "examples")
        for script in ("chip_smoke.py", "kernel_variants.py"):
            shutil.copy(ROOT / script, tmp / script)
        (tmp / SOURCE).write_text(src)
        check = not any(d in variant.split(",") for d in DIAGNOSTICS)
        res = subprocess.run(
            [sys.executable, str(tmp / "kernel_variants.py"), "--time"]
            + (["--check"] if check else []),
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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.time:
        print(json.dumps(time_forms(args.check)))
        return 0
    for variant in args.variants:
        edit((ROOT / SOURCE).read_text(), variant)  # refuse before building
    import chip_smoke as C

    print(C.nvidia_smi(), flush=True)
    for variant in args.variants:
        line = run_variant(variant)
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in line.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
