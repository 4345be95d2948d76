"""The port's bench twin (``python -m opal_tpu_torch.bench``) on the CPU
at a tiny size, and the port's CUDA defaults of ``convert``.

The twin must print exactly one JSON line with ``bench.py``'s keys,
size its deck by ``bench.py``'s rules, void a run that counts a loss
with ``bench.py``'s error line, refuse the flags it does not port with
exit code 1, and without a card exit 1 unless ``--device cpu`` is
given.
"""

import json

import numpy as np
import pytest
import torch

from opal_tpu_torch import bench
from opal_tpu_torch.convert import fields_from_numpy, state_from_numpy

pytestmark = pytest.mark.unit

TINY = ["--device", "cpu", "--particles", "8192", "--nx", "64",
        "--fused-block", "256", "--steps", "8"]
KEYS = {"metric", "value", "unit", "vs_baseline", "vs_node_proxy"}


@pytest.mark.parametrize("packed", [False, True], ids=["column", "packed"])
def test_bench_prints_one_line(packed, capsys, monkeypatch):
    """Both layouts: one JSON line with bench.py's keys (and the
    device), a positive rate, and every step of the three blocks through
    the kernel's form of that layout."""
    from opal_tpu_torch.ops import fused as F

    calls = {"column": 0, "packed": 0}
    real = {"column": F.fused_push_deposit,
            "packed": F.fused_push_deposit_packed}

    def spy(name):
        def call(*args):
            calls[name] += 1
            return real[name](*args)
        return call

    monkeypatch.setattr(F, "fused_push_deposit", spy("column"))
    monkeypatch.setattr(F, "fused_push_deposit_packed", spy("packed"))
    argv = TINY + (["--packed"] if packed else [])
    assert bench.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert KEYS <= line.keys() and "error" not in line
    assert line["metric"] == "macroparticle-pushes/sec/chip"
    assert line["unit"] == "pushes/s" and line["device"] == "cpu"
    assert line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 3.2e8)
    assert line["vs_node_proxy"] == pytest.approx(line["value"] / 1.1e9)
    want = {"column": 0, "packed": 0}
    want["packed" if packed else "column"] = 3 * 8
    assert calls == want


def test_bench_sizing_follows_bench_py(monkeypatch):
    """The default deck's auto-sizing (``bench.py:296-495``): 8*2**20
    electrons over nx 1024, block 8192, window 12, sort every 320 steps
    and exchange every 160, misfit capacity 256, capacity factor 1.25,
    the migration window and capacity of bench.py's formulas; the state
    itself is not drawn here (``build`` would)."""
    import opal_tpu_torch.sim as S

    args = bench._parser().parse_args([])
    sim_kw = {}

    class Stop(Exception):
        pass

    def fake_sim(geom, opts, specs, **kw):
        sim_kw.update(geom=geom, opts=opts, **kw)
        raise Stop

    monkeypatch.setattr(S, "Simulation", fake_sim)
    with pytest.raises(Stop):
        bench.build(args)
    opts = sim_kw["opts"]
    assert (args.nx, args.steps, args.fused_block, args.fused_resort,
            args.migrate_every, args.misfit_capacity,
            args.capacity_factor) == (1024, 1024, 8192, 320, 160, 256, 1.25)
    assert (opts.fused_window, opts.fused_resort_every, opts.migration_every,
            opts.fused_misfit_capacity) == (12, 320, 160, 256)
    assert opts.migration_window == 49_480 and opts.migration_capacity == 19_064
    assert opts.max_drift_cells_per_step == 0.0095
    assert opts.fused_pusher and not opts.packed_fused
    assert sim_kw["dtype"] == torch.float32 and sim_kw["geom"].nx == 1024


@pytest.mark.parametrize("steps,spp,want", [
    (1024, -1, 1024),   # auto at 8.39M particles: one call a block
    (400, 192, 134),    # bench.py's floor gave 200, above the limit
    (10, 0, 10),
    (10, 3, 3),
])
def test_chunks_never_exceed_steps_per_program(steps, spp, want):
    got = bench.chunk_steps(steps, spp, 8 * 2**20)
    assert got == want
    assert spp <= 0 or got <= spp


def test_bench_loss_voids_the_run(capsys):
    """A window far too narrow for the block (8 cells for a block of 8192
    rows over 64 cells) sends most rows to a misfit fallback of 256:
    the overflow is a counted loss, and the line is bench.py's error
    line with value 0."""
    argv = ["--device", "cpu", "--particles", "8192", "--nx", "64",
            "--fused-block", "8192", "--fused-window", "8", "--steps", "4"]
    assert bench.main(argv) == 0
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert line["error"].startswith("invalid: buffer-overflow particle losses")
    assert "# ERROR buffer-overflow particle losses" in cap.err


@pytest.mark.parametrize("flag", [
    ["--aot"],
    ["--mxu-gather"], ["--dynamic-gather"], ["--sort-rowgather"],
    ["--fused-subblocks", "4"], ["--sorted-pipeline"],
])
def test_bench_refuses_unported_flags(flag, capsys):
    assert bench.main(TINY + flag) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert cap.err.startswith(f"opal_tpu_torch.bench: {flag[0]} is not ported")


@pytest.mark.parametrize("flag,attr,value", [
    (["--qed"], "qed", True), (["--no-absorption"], "absorption", False),
    (["--chi", "0.1"], "chi", 0.1), (["--absorption-block", "16"],
                                     "absorption_block", 16),
    (["--absorption-active", "64"], "absorption_active", 64),
    (["--emission-active", "64"], "emission_active", 64),
    (["--no-lite"], "lite", False),
])
def test_bench_takes_qed_and_lite_flags(flag, attr, value):
    """bench.py's QED flags and ``--no-lite``, refused until the QED
    deck and the full kernel form were ported, parse to bench.py's
    destinations and pass the refusal check."""
    args = bench._parser().parse_args(TINY + flag)
    assert getattr(args, attr) == value
    assert bench._refusal(args) is None


@pytest.mark.parametrize("particles,fused,nx,cap", [
    (2_097_152, True, 16_384, 2_621_440),
    (8_388_608, False, 65_536, 10_485_760),
])
def test_bench_qed_sizing_follows_bench_py(particles, fused, nx, cap,
                                           monkeypatch):
    """The ``--qed`` deck's auto-sizing (``bench.py:326-548``): npc 128
    over nx max(1024, N/128) cells of 10 nm, 50-step blocks, block 2048,
    sort every 64 steps, exchange every 3, the fused kernel only below
    4e6 particles, the emission and absorption working sets at capacity
    / 32 and / 4, 64 candidates in passes of 32, no velocity spread in
    the window, and the photon buffer at the electron capacity; the
    exchange window twice bench.py's 8168 (ROADMAP C12)."""
    import opal_tpu_torch.sim as S

    args = bench._parser().parse_args(
        ["--qed", "--particles", str(particles)])
    sim_kw = {}

    class Stop(Exception):
        pass

    def fake_sim(geom, opts, specs, **kw):
        sim_kw.update(geom=geom, opts=opts, specs=specs, **kw)
        raise Stop

    monkeypatch.setattr(S, "Simulation", fake_sim)
    with pytest.raises(Stop):
        bench.build(args)
    opts, geom = sim_kw["opts"], sim_kw["geom"]
    assert (geom.nx, geom.dx, args.steps, args.fused_block,
            args.fused_resort, args.migrate_every, args.misfit_capacity,
            args.fused) == (nx, 1e-8, 50, 2048, 64, 3, 256, fused)
    assert opts.photon_emission and opts.photon_absorption
    assert (opts.emission_active_capacity, opts.absorption_active_capacity,
            opts.absorption_candidates, opts.absorption_block) == (
        cap // 32, cap // 4, 64, 32)
    assert (opts.fused_window, opts.migration_window,
            opts.migration_capacity, opts.max_drift_cells_per_step) == (
        24, 2 * 8168, 704, 0.95)
    assert opts.fused_pusher == fused and opts.fused_lite == -1
    assert set(sim_kw["specs"]) == {"electron", "photon"}
    assert bench.chunk_steps(args.steps, -1, particles, qed=True) == 50


@pytest.mark.parametrize("argv,form", [
    (["--qed", "--particles", "16384"], "vay_full"),
    (["--qed", "--no-absorption", "--particles", "16384"], "vay_full"),
    (TINY[2:] + ["--no-lite"], "vay_full"),
], ids=["qed", "qed_no_absorption", "no_lite"])
def test_bench_qed_and_no_lite_run(argv, form, capsys, monkeypatch):
    """``--qed`` (emission and absorption), ``--qed --no-absorption`` and
    ``--no-lite`` at tiny sizes: one JSON line with no error, every step
    through the kernel's full Vay form with the deposit, and on the QED
    deck photons emitted and the absorption pass run only when asked."""
    from opal_tpu_torch import interactions
    from opal_tpu_torch import sim as S
    from opal_tpu_torch.ops import fused as F

    forms, passes = [], []
    real_k, real_a = F.fused_push_deposit, S.absorb

    def kernel(*args):
        forms.append(F.form_name(args[0]))
        return real_k(*args)

    def absorb(*args, **kw):
        passes.append(kw)
        return real_a(*args, **kw)

    monkeypatch.setattr(F, "fused_push_deposit", kernel)
    monkeypatch.setattr(S, "absorb", absorb)
    steps = ["--steps", "4"] if "--qed" in argv else []
    assert bench.main(["--device", "cpu", "--verbose"] + argv + steps) == 0
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert "error" not in line and line["value"] > 0
    assert forms and set(forms) == {form} and len(forms) == 3 * (
        4 if "--qed" in argv else 8)
    if "--qed" in argv:
        photons = int(cap.err.split("photons=")[1].split()[0])
        assert photons > 0
        absorbing = "--no-absorption" not in argv
        assert len(passes) == (12 if absorbing else 0)
        # bracketed on the rank's own electrons (one device: no pairing
        # across ranks)
        assert all(p["bracketed"] and p["axis_index"] == 0
                   and not p["replicated"] for p in passes)
    assert interactions.absorb is real_a


@pytest.mark.parametrize("qed", [False, True], ids=["default", "qed"])
def test_bench_draws_on_the_device(qed, monkeypatch):
    """``build`` draws each rank's block with ``species.initialize_device``
    (it never calls the host draw ``species.initialize``): its electrons'
    per-cell counts and weight total equal the host draw's of the same
    deck, and the QED deck's photons are all dead rows."""
    from opal_tpu_torch import species as SP

    real = SP.initialize
    calls = []
    monkeypatch.setattr(SP, "initialize",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    argv = ["--qed", "--particles", "16384"] if qed else TINY
    args = bench._parser().parse_args(argv + ["--device", "cpu"])
    sim, _, species, n = bench.build(args)
    assert calls == []
    e = species["electron"]
    geom, cap = sim.geom, e.alive.shape[0]
    host = real(SP.SpeciesSpec.electron(), geom, n // geom.nx,
                lambda x: np.full_like(x, 20.0), *(lambda x, u, r: 0 * x,) * 3,
                1.0, cap, dtype=np.float32, device="cpu")
    count = lambda st: torch.bincount(st.cell[st.alive].long(),
                                      minlength=geom.n_loc)
    assert int(e.alive.sum()) == n
    assert torch.equal(count(e), count(host))
    assert float(e.weight.double().sum()) == float(host.weight.double().sum())
    assert e.x.dtype == torch.float32 and e.x.device.type == "cpu"
    if qed:
        ph = species["photon"]
        assert ph.alive.shape[0] == cap and not bool(ph.alive.any())


def test_bench_without_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(TINY[2:]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err
    assert "--device cpu" in cap.err


def test_convert_defaults_to_the_card():
    """``state_from_numpy`` and ``fields_from_numpy`` put their tensors
    on the CUDA device unless asked for the CPU: without a card the
    default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cols = {"cell": np.zeros(4, np.int32), "x": np.zeros(4, np.float32)}
    assert state_from_numpy(cols, device="cpu").x.device.type == "cpu"
    with pytest.raises((AssertionError, RuntimeError)):
        state_from_numpy(cols)
    a = np.zeros((4, 3))
    with pytest.raises((AssertionError, RuntimeError)):
        fields_from_numpy(a, a, a, a[:, 0])
