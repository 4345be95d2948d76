"""The CLI: a mini two_stream deck through ``opal_tpu.cli.main`` and
``opal_tpu_torch.cli.main``, in two directories, at the default mixed
precision.  The deck (nx 128, npc 16, 40 steps, 2 outputs) makes both
builds pick the fused kernel at block 1024, capacity 3072 and window
80, with the resort, migration and misfit capacities auto-sized alike.

Both runs differ by f32 rounding of the particle push (see
test_torch_sim.py), so the grid columns agree within 1e-5 of each
column's largest magnitude; the energies, printed to 7 digits, within
rtol 1e-5.  In the x:px histograms a particle sitting on a bin edge
may land in either bin, and a particle at an extreme may fall on either
side of the auto-ranged histogram's edge: the images' L1 distance is at
most two particles moving (4 particle quanta, a quantum being one
particle's share of the total), the image extrema within 2 quanta, and
the other header values within rtol 1e-6.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opal_tpu.cli as jcli
import opal_tpu_torch.cli as tcli
from opal_tpu_torch.diagnostics.fits import read_image

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
N_PARTICLES = 128 * 16


def _mini_deck(path: Path):
    src = (EXAMPLES / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", "nx: 128").replace("npc: 100", "npc: 16")
    src = src.replace("end: 0.1", "end: 6.4e-5")
    src = src.replace("n_outputs: 20", "n_outputs: 2")
    path.mkdir()
    (path / "deck.yaml").write_text(src)
    return path / "deck.yaml"


def _energies(path):
    return {k: float(v) for k, v in
            (line.split() for line in path.read_text().splitlines())}


def test_two_stream_outputs_match(tmp_path, capsys):
    jdeck = _mini_deck(tmp_path / "jax")
    tdeck = _mini_deck(tmp_path / "torch")
    assert jcli.main([str(jdeck), "--devices", "1"]) == 0
    jout = capsys.readouterr()
    assert tcli.main([str(tdeck), "--device", "cpu"]) == 0
    tout = capsys.readouterr()
    for o in (jout, tout):
        assert "[fused pusher: electron]" in o.out
        assert "Output    2 at t =" in o.out
        assert "warning" not in o.err
    jd, td = jdeck.parent, tdeck.parent
    for i in range(3):
        g_j = np.loadtxt(jd / f"{i}_grid.dat")
        g_t = np.loadtxt(td / f"{i}_grid.dat")
        assert g_t.shape == (128, 11)
        for c in range(11):
            np.testing.assert_allclose(
                g_t[:, c], g_j[:, c], rtol=0,
                atol=1e-5 * np.abs(g_j[:, c]).max(),
                err_msg=f"{i}_grid.dat column {c}",
            )
        e_j = _energies(jd / f"{i}_energy.dat")
        e_t = _energies(td / f"{i}_energy.dat")
        assert e_t.keys() == e_j.keys() and e_t["electrons"] > 0
        for k in e_j:
            np.testing.assert_allclose(e_t[k], e_j[k], rtol=1e-5, err_msg=k)
        im_j, h_j = read_image(jd / f"{i}_electron_x-px.fits")
        im_t, h_t = read_image(td / f"{i}_electron_x-px.fits")
        quantum = im_j.sum() / N_PARTICLES
        assert np.abs(im_t - im_j).sum() <= 4 * quantum
        assert h_t.keys() == h_j.keys()
        for k, v in h_j.items():
            if k in ("DATAMIN", "DATAMAX"):
                assert abs(h_t[k] - v) <= 2 * quantum, k
            elif isinstance(v, float):
                np.testing.assert_allclose(h_t[k], v, rtol=1e-6, err_msg=k)
            else:
                assert h_t[k] == v, k


def test_refuses_unported_decks(tmp_path):
    """The replicated-field mode's photon absorption, the last part of
    opal_tpu that the port refused, is built now: an absorption deck that
    opal_tpu's rule runs replicated on several devices
    (``examples/colliding_beams.yaml`` with absorption on, its beam on
    one of the slabs) is built by ``cli.build`` at two ranks in the
    replicated mode with absorption on, as opal_tpu's ``build`` builds
    it at two devices, with the same capacities."""
    from opal_tpu_torch.parallel.dist import Ring

    src = (EXAMPLES / "colliding_beams.yaml").read_text()
    assert src.count("photon_absorption: false") == 1
    deck = tmp_path / "deck.yaml"
    deck.write_text(src.replace("photon_absorption: false",
                                "photon_absorption: true"))
    # rank 0 of a ring of two whose group build never reaches
    sim, species, rp = tcli.build(deck, device="cpu",
                                  ring=Ring(rank=0, world=2, group=object()))
    jsim, _, jrp = jcli.build(deck, n_devices=2)
    assert rp["replicated"] and sim.options.replicate_fields
    assert jsim.options.replicate_fields
    assert sim.options.photon_absorption and jsim.options.photon_absorption
    assert not rp["replicate_blocked_by_absorption"]
    assert sim.geom.n_devices == jsim.geom.n_devices == 1
    assert rp["capacities"] == jrp["capacities"]


def test_no_card_exits_without_running(tmp_path, capsys):
    """Without ``--device cpu`` the CLI runs on the CUDA device; with no
    card it exits 1 and names the missing device, writing no output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    deck = _mini_deck(tmp_path / "run")
    assert tcli.main([str(deck)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("opal_tpu_torch: no CUDA device")
    assert "--device cpu" in err
    assert not list(deck.parent.glob("*_energy.dat"))


def test_profile_writes_table_and_keeps_outputs(tmp_path, capsys):
    """``--profile DIR`` profiles the last output block: it writes the
    operator table and changes no output."""
    plain, prof = _mini_deck(tmp_path / "plain"), _mini_deck(tmp_path / "prof")
    assert tcli.main([str(plain), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert tcli.main([str(prof), "--device", "cpu",
                      "--profile", str(tmp_path / "trace")]) == 0
    err = capsys.readouterr().err
    assert "profile: " in err and "s wall" in err
    table = (tmp_path / "trace" / "profile.txt").read_text()
    assert "aten::" in table
    # the program's spans and counters a step end the table
    assert "opal.step: host" in table and "host_reads: " in table
    assert "misfit_tiles: " in table
    for name in ("2_energy.dat", "2_grid.dat"):
        assert (prof.parent / name).read_text() == \
            (plain.parent / name).read_text(), name


def test_port_imports_no_jax():
    """Every module of the port (the bench twin too), ``chip_smoke.py``
    and ``kernel_variants.py`` import without JAX or opal_tpu."""
    code = (
        "import importlib, pkgutil, sys, opal_tpu_torch, chip_smoke\n"
        "import kernel_variants\n"
        "for m in pkgutil.walk_packages(opal_tpu_torch.__path__,"
        " 'opal_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "assert 'opal_tpu_torch.bench' in sys.modules\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'opal_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('opal_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_colliding_beams_sizing_matches_opal_tpu(precision):
    """``examples/colliding_beams.yaml`` as shipped, built by both CLIs:
    at the default mixed precision the unfused push with f64 arithmetic,
    at ``--f32`` the kernel's full Vay form without the deposit; the same
    block, window, cadences, emission capacity and photon buffer, and
    the same initial beam."""
    import jax.numpy as jnp

    deck = EXAMPLES / "colliding_beams.yaml"
    f32 = precision == "f32"
    jsim, jsp, jrp = jcli.build(
        deck, n_devices=1, dtype=jnp.float32,
        field_dtype=jnp.float32 if f32 else jnp.float64)
    tsim, tsp, trp = tcli.build(
        deck, dtype=torch.float32,
        field_dtype=torch.float32 if f32 else torch.float64, device="cpu")
    names = ("fused_pusher", "push_f64_compute", "fused_block",
             "fused_window", "fused_resort_every", "migration_every",
             "fused_misfit_capacity", "migration_window",
             "emission_active_capacity", "emission_insert_capacity",
             "photon_angle_max", "photon_energy_min", "radiation_reaction",
             "beaming", "current_deposition", "dt")
    got = {k: getattr(tsim.options, k) for k in names}
    assert got == {k: getattr(jsim.options, k) for k in names}
    assert (got["fused_pusher"], got["push_f64_compute"]) == (f32, not f32)
    # without the kernel the cadence is not traded for window width
    assert (got["fused_block"], got["fused_window"], got["fused_resort_every"],
            got["migration_every"], got["emission_active_capacity"]) == (
                (2048, 56, 16, 1, 4096) if f32 else (2048, 144, 64, 1, 4096))
    # only the kernel rounds the capacity up to whole blocks
    cap = 75_776 if f32 else 75_000
    assert trp["capacities"] == jrp["capacities"] == {
        "electron": cap, "photon": 4 * cap}
    assert trp["total_steps"] == jrp["total_steps"] == 3157
    assert tsim._n_rows == 4228
    assert int(tsp["electron"].alive.sum()) == 50_000
    assert not tsp["photon"].alive.any()
    np.testing.assert_array_equal(tsp["electron"].ux.numpy(),
                                  np.asarray(jsp["electron"].ux))
    np.testing.assert_array_equal(tsp["electron"].tau.numpy(),
                                  np.asarray(jsp["electron"].tau))
    spec = tsim._fused_spec("electron")
    assert (spec.lite, spec.dep_skip) == (False, True)
    assert tsim._fused_applicable("electron", tsp["electron"]) == f32
    assert not tsim.electron_chi_is_lazy


def test_photon_outputs_match_writer():
    """The deck's photon outputs (``energy:(log;energy)`` and
    ``longitude:latitude:(energy)``, plus ``x`` and ``energy``) written by
    both packages' writers from one photon state: the same files and
    headers, the images within 1e-6 of their largest bin (opal_tpu bins
    with its native host library, the port with the numpy fallback,
    which add in another order)."""
    import tempfile

    from opal_tpu.diagnostics import output as jout
    from opal_tpu.grid import GridGeometry as JGeom
    from opal_tpu.species import ParticleState as JState
    from opal_tpu.species import SpeciesSpec as JSpec
    from opal_tpu_torch.diagnostics import output as tout
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.species import SpeciesSpec

    rng = np.random.default_rng(9)
    n = 4000
    alive = rng.random(n) < 0.7
    k = np.stack([-10 ** rng.uniform(0, 3, n), rng.normal(0, 5, n),
                  rng.normal(0, 5, n)], axis=1)
    cols = dict(
        cell=rng.integers(0, 400, n).astype(np.int32), x=rng.random(n),
        prev_x=rng.random(n), y=np.zeros(n), z=np.zeros(n),
        weight=np.where(alive, 10 ** rng.uniform(4, 6, n), 0.0),
        ux=k[:, 0], uy=k[:, 1], uz=k[:, 2],
        gamma=np.sqrt((k ** 2).sum(1)), chi=rng.random(n) * 1e-3,
        tau=None, tau_abs=rng.random(n), tau_st=rng.random(n), work=None,
        birth_time=np.zeros(n), alive=alive, pol=np.zeros((n, 4)),
        basis=np.zeros((n, 6)),
    )
    outs = ["x", "energy", "energy:(log;energy)", "longitude:latitude",
            "longitude:latitude:(energy)"]
    gkw = dict(nx=400, dx=1e-8, xmin=-1e-6, n_devices=1)
    with tempfile.TemporaryDirectory() as d:
        jd, td = Path(d) / "j", Path(d) / "t"
        jd.mkdir(), td.mkdir()
        jout.write_particle_outputs(jd, 3, JSpec.photon(outs), JState(**cols),
                                    JGeom(**gkw), n)
        tout.write_particle_outputs(
            td, 3, SpeciesSpec.photon(outs),
            {k: v for k, v in cols.items() if v is not None},
            GridGeometry(**gkw), n)
        names = sorted(p.name for p in jd.iterdir())
        assert names == sorted(p.name for p in td.iterdir())
        assert "3_photon_energy_energy_log.fits" in names
        assert "3_photon_longitude-latitude_energy.fits" in names
        for name in names:
            im_j, h_j = read_image(jd / name)
            im_t, h_t = read_image(td / name)
            assert h_t == pytest.approx(h_j, rel=1e-12), name
            np.testing.assert_allclose(im_t, im_j, rtol=0,
                                       atol=1e-6 * np.abs(im_j).max(),
                                       err_msg=name)


QED_MINI = """\
control:
 dx: 0.01*micro
 nx: 400
 xmin: -1*micro
 start: -1.5e-6/c
 end: -0.55e-6/c
 current_deposition: false
 n_outputs: 2

qed:
 photon_emission: true
 photon_absorption: false
 photon_energy_min: 1.0e-3 * MeV
 max_formation_length: 1.0 * micro

electrons:
 npc: 12
 ne: 1.0e-6 * 20.0 * critical(omega) * step(x,0.2*micro,0.7*micro)
 ux: -1000.0 * (1.0 + 0.01 * nrand)
 uy: 0.0
 uz: 0.0
 output: [x, chi, x:chi, energy, x:energy]

ions:
 npc: 0

photons:
 npc: 0
 output: [x, energy, energy:(log;energy), longitude:latitude,
  longitude:latitude:(energy), chi]

laser:
 Ey: >
  (20.0*m*c*omega/e)
  *sin(omega*(t-x/c))
  *exp(-ln(2.0)*(omega*(t-x/c))^2/(2.0*pi^2*4.0^2))
 Ez: 0.0

constants:
 omega: 2*pi*c/0.8e-6

features:
 no_beaming: true
 immobile_photons: {immobile}

tpu:
 emission_active_capacity: 8
"""


@pytest.mark.parametrize("immobile", ["false", "true"])
def test_qed_cli_writes_photon_outputs(immobile, tmp_path, capsys):
    """A small emission deck (100 steps, 2 outputs) through the port's
    CLI on the CPU at the default mixed precision: the feature banners,
    the QED backlog note (8 emitters a step), no loss warning, the
    photon files of the deck, and energies that balance: what the
    electrons lose, the photons carry, within 5% (the laser's work on the
    beam does not cancel before the pulse has crossed it)."""
    path = tmp_path / "deck.yaml"
    path.write_text(QED_MINI.format(immobile=immobile))
    assert tcli.main([str(path), "--device", "cpu"]) == 0
    o = capsys.readouterr()
    lines = o.out.splitlines()
    assert lines[0] == "Running 1 task on cpu (604 cells/device)..."
    assert "[neglecting angular component of photon spectrum]" in lines
    assert ("[photon push disabled]" in lines) == (immobile == "true")
    assert not any(l.startswith("[fused pusher") for l in lines)
    assert "warning" not in o.err
    assert "note: QED active-set backlog:" in o.err
    stems = ("photon_x", "photon_energy", "photon_energy_energy_log",
             "photon_longitude-latitude", "photon_longitude-latitude_energy",
             "photon_chi", "electron_x-chi", "electron_x-energy")
    for stem in stems:
        img, hdr = read_image(tmp_path / f"2_{stem}.fits")
        assert np.isfinite(img).all() and hdr["TOTAL"] > 0, stem
    e0 = {k: float(v) for k, v in (l.split() for l in
          (tmp_path / "0_energy.dat").read_text().splitlines())}
    e2 = {k: float(v) for k, v in (l.split() for l in
          (tmp_path / "2_energy.dat").read_text().splitlines())}
    assert e0["photons"] == 0.0 and e2["photons"] > 0.0
    loss = e0["electrons"] - e2["electrons"]
    assert abs(loss - e2["photons"]) < 0.05 * e2["photons"]


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_absorption_cli_runs(precision, tmp_path, capsys):
    """The mini colliding-beams crossing with absorption (the deck of
    tests/test_torch_absorption.py, 120 steps over 2 outputs) through
    the port's CLI on the CPU: at the default mixed precision the
    unfused push with the per-step sort of the absorption pass, at
    ``--f32`` (blocks of 128 rows) the kernel's full Vay form without the
    deposit with the bracketed pairing.  Both print the absorption and
    stimulated-emission events on standard error in the reference's
    format, count no loss, and end with photons alive."""
    from opal_tpu_torch import sim as S
    from test_torch_absorption import MINI

    tpu = " fused_block: 128\n" if precision == "f32" else ""
    (tmp_path / "deck.yaml").write_text(
        MINI.format(steps=120, outputs=2, tpu=tpu))
    modes = []
    real = S.absorb

    def absorb(*a, **kw):
        modes.append(kw["bracketed"])
        return real(*a, **kw)

    S.absorb = absorb
    try:
        argv = [str(tmp_path / "deck.yaml"), "--device", "cpu"]
        assert tcli.main(argv + (["--f32"] if precision == "f32" else [])) == 0
    finally:
        S.absorb = real
    o = capsys.readouterr()
    assert ("[fused pusher: electron]" in o.out) == (precision == "f32")
    assert set(modes) == {precision == "f32"} and len(modes) == 120
    assert "warning" not in o.err
    ev = [l.split() for l in o.err.splitlines()
          if l.endswith((" abs", " stim"))]
    assert len(ev) > 20 and {l[-1] for l in ev} == {"abs", "stim"}
    assert all(len(l) == 14 for l in ev)
    e2 = _energies(tmp_path / "2_energy.dat")
    assert e2["photons"] > 0 and np.isfinite(list(e2.values())).all()


@pytest.mark.parametrize("emission,absorption,fused_lite", [
    (False, False, -1), (False, False, 0), (True, False, -1),
    (False, True, -1)], ids=["plain", "no_lite", "emission", "absorption"])
def test_lite_rule_matches_opal_tpu(emission, absorption, fused_lite):
    """The kernel's lite form (no prev_x, gh, chi) serves electrons only
    without QED and with ``fused_lite`` not 0, and only then is electron
    chi left stale between outputs, as in opal_tpu (sim.py:520-523,
    1572-1583): an absorption-only deck takes the full form."""
    import opal_tpu.sim as JS
    import opal_tpu_torch.sim as TS
    from opal_tpu.grid import GridGeometry as JGeom
    from opal_tpu.species import SpeciesSpec as JSpec
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.species import SpeciesSpec

    kw = dict(dt=1e-17, photon_emission=emission,
              photon_absorption=absorption, fused_pusher=True,
              fused_block=128, fused_lite=fused_lite)
    specs = lambda S: {"electron": S.electron(), "photon": S.photon()}
    jsim = JS.Simulation(JGeom(nx=64, dx=1e-8, xmin=0.0, n_devices=1),
                         JS.SimOptions(**kw), specs(JSpec),
                         dtype=np.float32)
    tsim = TS.Simulation(GridGeometry(nx=64, dx=1e-8, xmin=0.0, n_devices=1),
                         TS.SimOptions(**kw), specs(SpeciesSpec),
                         device="cpu", dtype=torch.float32)
    lite = jsim._fused_spec("electron").lite
    assert tsim._fused_spec("electron").lite == lite
    assert lite == (not (emission or absorption) and fused_lite != 0)
    assert tsim.electron_chi_is_lazy == jsim.electron_chi_is_lazy == lite
