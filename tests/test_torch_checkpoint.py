"""Checkpoint/resume in opal_tpu's format (``opal_tpu_torch.checkpoint``),
held against the continuous run and against ``opal_tpu.checkpoint``.

* A save, load and run continues bitwise on the CPU where the
  continuous run is made of the same ``run()`` calls (the sort and
  migration schedule restarts at each call, as in
  ``tests/test_checkpoint.py``): fused mixed precision in the column and
  the packed layout, and an emission deck whose generator is restored;
  and through the CLI, ``--resume`` of a run cut after its first output
  writes the same files as the whole run.
* The port's file of a state and opal_tpu's file of the same state have
  the same arrays (apart from the random state: opal_tpu's threefry
  key, the port's generator), shapes, dtypes, manifest and ``[hi, lo]``
  counter pairs.
* The port resumes opal_tpu's 1-device and 8-device snapshots and
  continues them at f64 within 1e-12 of opal_tpu's own 1-device load
  of the same file.
* Resharding onto one device (4, 8 and 4 replicated devices) keeps each
  particle's global cell and gives opal_tpu's 1-device load exactly; the
  fused kernel's first steps after it count no loss.
* Each refusal: another format version, other species, another grid, a
  missing device layout, opal_tpu's key for a QED deck, a generator of
  the other device type, and ``--resume`` with no file (exit 1).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opal_tpu_torch.cli as tcli
from opal_tpu import checkpoint as jckpt
from opal_tpu import constants as const
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.sim import Simulation as JSim
from opal_tpu.sim import counter_total
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu.species import initialize as jinit
from opal_tpu.species import shard_even
from opal_tpu_torch import checkpoint
from opal_tpu_torch.convert import fields_from_numpy, to_numpy
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize
from test_torch_cli import QED_MINI, _mini_deck

pytestmark = pytest.mark.unit

NX, NPC, DX = 64, 16, 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
#: the fused schedule of tests/test_torch_sim.py: a window tight enough
#: that rows miss it, so sorts, migrations and the fallback all run
FUSED = dict(dt=DT, fused_pusher=True, fused_block=128, fused_window=12,
             fused_resort_every=8, migration_every=4,
             max_drift_cells_per_step=0.45, migration_window=256,
             migration_capacity=64, fused_misfit_capacity=256)


def _beams(x, u, nr):
    return 0.25 * np.sign(u - 0.5) * (1.0 + 0.2 * nr)


def _electrons(mod_init, geom, dtype, cap, **kw):
    """The two-stream electrons of ``tests/test_torch_sim.py`` through
    ``opal_tpu.species.initialize`` or the port's (they draw alike)."""
    spec = (SpeciesSpec if mod_init is initialize else JSpec).electron()
    return mod_init(
        spec, geom, NPC,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=_beams, uy=lambda x, u, nr: 0.05 * nr,
        uz=lambda x, u, nr: np.zeros_like(x),
        dt=DT, capacity_per_device=cap, seed=3, dtype=dtype,
        work_dtype=np.float64, **kw,
    )


def _fields(n_ext, seed=4):
    """Host fields of a state in flight: small random E, a B_z that
    turns every orbit, and J/rho of the last step."""
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((n_ext, 3)) * 1e-3
    B = np.zeros((n_ext, 3))
    B[:, 2] = 1e-7
    return E, B, rng.standard_normal((n_ext, 3)), rng.standard_normal(n_ext)


def _equal(a, b, name=""):
    """Bitwise equality of (nested) run outputs."""
    a, b = to_numpy(a), to_numpy(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _equal(a[k], b[k], f"{name}/{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{name}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def _qed_sim(tmp_path):
    (tmp_path / "qed").mkdir()
    deck = tmp_path / "qed" / "deck.yaml"
    deck.write_text(QED_MINI.format(immobile="false"))
    sim, species, rp = tcli.build(deck, device="cpu")
    return sim, species, rp["tstart"]


@pytest.mark.parametrize("case", ["column", "packed", "qed"])
def test_roundtrip_continues_bitwise(case, tmp_path):
    if case == "qed":
        sim, species, t0 = _qed_sim(tmp_path)
        n1, n2 = 50, 50
        E, B, J, rho = sim.init_fields()
    else:
        geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
        sim = Simulation(geom, SimOptions(**FUSED, packed_fused=case == "packed"),
                         {"electron": SpeciesSpec.electron()}, device="cpu",
                         dtype=torch.float32, field_dtype=torch.float64)
        species = {"electron": _electrons(initialize, geom, np.float32,
                                          1536, device="cpu")}
        n1, n2, t0 = 12, 12, 0.0
        E, B, J, rho = fields_from_numpy(*_fields(geom.n_ext), device="cpu")
    rng = torch.Generator(device="cpu").manual_seed(sim.options.seed)
    E, B, J, rho, species, t, counters = sim.run(
        E, B, J, rho, species, t0, sim.zero_counters(), n1, rng=rng)
    checkpoint.save(tmp_path, 1, t, E, B, J, rho, species, rng, counters,
                    sim.geom.n_loc)
    ref = sim.run(E, B, J, rho, species, t, counters, n2, rng=rng)

    step, t2, *state, rng2, counters2 = checkpoint.load(tmp_path, sim)
    assert step == 1 and t2 == t
    _equal(state, (E, B, J, rho, species), "state")
    _equal(counters2, counters, "counters")
    got = sim.run(*state, t2, counters2, n2, rng=rng2)
    _equal(got, ref, "run")
    assert all(int(v) == 0 for k, v in got[6].items() if k != "qed_deferred")
    if case == "qed":
        # photons are emitted in the second half: the draws matter
        assert int(ref[4]["photon"].alive.sum()) > 100


def test_cli_resume_writes_the_continuous_runs_files(tmp_path, capsys):
    """The mini two_stream deck (2 outputs of 20 steps, the fused kernel
    with its lazy electron chi) with ``checkpoint: true``: a run cut to
    its first output, resumed with the whole deck, writes output 2's
    grid, energies and histograms exactly as the whole run does."""
    whole = _mini_deck(tmp_path / "whole")
    src = whole.read_text().replace("control:\n", "control:\n checkpoint: true\n", 1)
    whole.write_text(src)
    cut = _mini_deck(tmp_path / "cut")
    cut.write_text(src.replace("end: 6.4e-5", "end: 3.2e-5").replace(
        "n_outputs: 2", "n_outputs: 1"))
    assert tcli.main([str(whole), "--device", "cpu"]) == 0
    assert tcli.main([str(cut), "--device", "cpu"]) == 0
    cut.write_text(src)
    assert tcli.main([str(cut), "--device", "cpu", "--resume"]) == 0
    o = capsys.readouterr()
    assert "Resuming from output 1 (t =" in o.out and "warning" not in o.err
    for name in ("2_grid.dat", "2_energy.dat", "2_electron_x-px.fits",
                 "checkpoint.npz"):
        a, b = (whole.parent / name).read_bytes(), (cut.parent / name).read_bytes()
        assert a == b, name


def test_file_matches_opal_tpus(tmp_path):
    """One emission deck's state saved by both packages (opal_tpu from
    host arrays with its key, the port from tensors with its generator):
    the same arrays, shapes, dtypes and manifest, and counters above
    2**30 as the same [hi, lo] pairs."""
    geom_kw = dict(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    host = {"electron": _electrons(jinit, JGeom(**geom_kw), np.float32, 1536),
            "photon": jinit(JSpec.photon(), JGeom(**geom_kw), 0,
                            lambda x: x * 0, None, None, None, DT, 256,
                            seed=1, dtype=np.float32)}
    tsp = {"electron": _electrons(initialize, GridGeometry(**geom_kw),
                                  np.float32, 1536, device="cpu"),
           "photon": initialize(SpeciesSpec.photon(), GridGeometry(**geom_kw),
                                0, lambda x: x * 0, None, None, None, DT, 256,
                                seed=1, dtype=np.float32, device="cpu")}
    fields = _fields(NX)
    pairs = {"electron": [2, 5], "photon": [0, 9], "qed_deferred": [1, 3]}
    (tmp_path / "jax").mkdir(), (tmp_path / "torch").mkdir()
    jckpt.save(tmp_path / "jax", 3, 1.5e-6, *fields, host,
               jax.random.key(0), {k: np.array(v, np.int32)
                                   for k, v in pairs.items()},
               n_devices=1, n_loc=NX)
    checkpoint.save(tmp_path / "torch", 3, 1.5e-6,
                    *fields_from_numpy(*fields, device="cpu"), tsp,
                    torch.Generator().manual_seed(0),
                    {k: torch.tensor((v[0] << 30) + v[1]) for k, v in
                     pairs.items()}, NX)
    with np.load(tmp_path / "jax" / checkpoint.FILENAME) as z:
        j = {k: z[k] for k in z.files}
    with np.load(tmp_path / "torch" / checkpoint.FILENAME) as z:
        t = {k: z[k] for k in z.files}
    assert set(j) - set(t) == set()
    assert set(t) - set(j) == {checkpoint.RNG_STATE, checkpoint.RNG_DEVICE}
    assert str(t[checkpoint.RNG_DEVICE]) == "cpu"
    for k in set(j) & set(t):
        if k == "manifest":
            assert json.loads(t[k].tobytes()) == json.loads(j[k].tobytes())
        else:
            assert (t[k].shape, t[k].dtype) == (j[k].shape, j[k].dtype), k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert "photon/pol" in t and "electron/tau_abs" not in t
    for k, v in pairs.items():
        np.testing.assert_array_equal(t[f"counter/{k}"], v)


def _snapshot(path, n_devices, dtype, replicated=False, counters=None):
    """opal_tpu's snapshot of a two-stream state (tagged weights) on
    ``n_devices`` devices, or on ``n_devices`` devices in replicated
    mode; returns the host electron state it saved."""
    if replicated:
        e = _electrons(jinit, JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                       dtype, NX * NPC)
        e = shard_even(e, n_devices, NX * NPC // n_devices + 64)
        n_loc = NX
    else:
        geom = JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=n_devices)
        e = _electrons(jinit, geom, dtype, NX * NPC // n_devices + 64)
        n_loc = geom.n_loc
    alive = np.asarray(e.alive)
    tags = np.arange(1, alive.size + 1, dtype=dtype)
    e = dataclasses.replace(e, weight=np.where(alive, tags, 0.0).astype(dtype))
    jckpt.save(path, 2, 3.0e-6, *_fields(NX), {"electron": e},
               jax.random.key(0),
               counters or {"electron": np.zeros(2, np.int32)},
               n_devices=n_devices, n_loc=n_loc, replicated=replicated)
    return e


def _global_cells(cols, n_devices, n_loc, replicated=False):
    """weight tag -> global extended cell of every alive row."""
    alive = np.asarray(cols["alive"])
    cell = np.asarray(cols["cell"])
    dev = np.arange(alive.size) // (alive.size // n_devices)
    g = cell if replicated else dev * n_loc + cell
    w = np.asarray(cols["weight"])
    return {int(w[i]): int(g[i]) for i in np.flatnonzero(alive)}


@pytest.mark.parametrize("layout", ["4", "8", "4 replicated"])
def test_reshard_onto_one_device(layout, tmp_path):
    n_devices, replicated = int(layout.split()[0]), "replicated" in layout
    e = _snapshot(tmp_path, n_devices, np.float32, replicated)
    n_loc = NX if replicated else NX // n_devices
    before = _global_cells(
        {"alive": e.alive, "cell": e.cell, "weight": e.weight}, n_devices,
        n_loc, replicated)
    assert len(before) == NX * NPC

    tsim = Simulation(GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                      SimOptions(**FUSED), {"electron": SpeciesSpec.electron()},
                      device="cpu", dtype=torch.float32,
                      field_dtype=torch.float64)
    jsim = JSim(JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1), JOptions(**FUSED),
                {"electron": JSpec.electron()}, dtype=jnp.float32,
                field_dtype=jnp.float64)
    *_, tsp, _, _ = checkpoint.load(tmp_path, tsim)
    *_, jsp, _, _ = jckpt.load(tmp_path, jsim)
    got = to_numpy(tsp["electron"])
    # 1.25 x 1024 alive, + 128 and rounded to 128, in whole blocks
    assert got["alive"].shape == (1408,)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jsp["electron"], k)),
                                      err_msg=k)
    assert _global_cells(got, 1, NX) == before

    # the rows come in unsorted: the run sorts them before its first
    # fused step, and counts no loss
    res = checkpoint.load(tmp_path, tsim)
    out = tsim.run(*res[2:7], res[1], res[8], 8)
    assert int(out[6]["electron"]) == 0
    assert int(out[4]["electron"].alive.sum()) == NX * NPC


@pytest.mark.parametrize("n_devices", [1, 8])
def test_resumes_opal_tpus_snapshot(n_devices, tmp_path):
    """opal_tpu's f64 snapshot on ``n_devices`` devices, its counter a
    legacy scalar or a [hi, lo] pair, continued 10 steps by the port and
    by opal_tpu's own 1-device load: fields and particle columns within
    1e-12 of their scale, the same counters."""
    total = 7 if n_devices == 1 else (1 << 30) + 7
    counter = (np.asarray(total, np.int64) if n_devices == 1
               else np.array([1, 7], np.int32))
    _snapshot(tmp_path, n_devices, np.float64,
              counters={"electron": counter})
    geom_kw = dict(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    tsim = Simulation(GridGeometry(**geom_kw), SimOptions(dt=DT),
                      {"electron": SpeciesSpec.electron()}, device="cpu")
    jsim = JSim(JGeom(**geom_kw), JOptions(dt=DT),
                {"electron": JSpec.electron()})
    step, t, *tstate, rng, tc = checkpoint.load(tmp_path, tsim)
    assert (step, t) == (2, 3.0e-6) and int(tc["electron"]) == total
    assert rng.initial_seed() == tsim.options.seed
    jstep, jt, *jstate, key, jc = jckpt.load(tmp_path, jsim)
    tout = tsim.run(*tstate, t, tc, 10)
    jout = jsim.run(*jstate, jt, key, jc, 10)
    assert int(tout[6]["electron"]) == counter_total(jout[6]["electron"]) == total
    for i, name in enumerate(("E", "B", "J", "rho")):
        a, b = tout[i].numpy(), np.asarray(jout[i])
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-12 * np.abs(b).max(), err_msg=name)
    tcols, jst = to_numpy(tout[4]["electron"]), jout[4]["electron"]
    np.testing.assert_array_equal(tcols["cell"], np.asarray(jst.cell))
    for k in ("x", "ux", "uy", "uz", "gamma", "work"):
        b = np.asarray(getattr(jst, k))
        np.testing.assert_allclose(tcols[k], b, rtol=0,
                                   atol=1e-12 * np.abs(b).max(), err_msg=k)


def _rewrite(path, **changes):
    """Rewrite a checkpoint with some arrays (or manifest fields) changed."""
    f = path / checkpoint.FILENAME
    with np.load(f) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(arrays["manifest"].tobytes())
    for k, v in changes.items():
        if k in manifest:
            manifest[k] = v
        else:
            arrays[k] = v
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    np.savez(f, **arrays)


REFUSALS = {
    "version": "checkpoint format v2 != v1",
    "species": "checkpoint species ['electron'] do not match",
    "grid": "checkpoint grid has 64 cells; configuration expects 128",
    "layout": "checkpoint lacks the recorded device layout",
    "qed key": "the draw streams differ",
    "generator": "generator state is of a cuda generator",
}


@pytest.mark.parametrize("case", list(REFUSALS) + ["no file"])
def test_refusals(case, tmp_path, capsys):
    geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    specs = {"electron": SpeciesSpec.electron()}
    opts = SimOptions(dt=DT)
    if case == "no file":
        deck = _mini_deck(tmp_path / "run")
        assert tcli.main([str(deck), "--device", "cpu", "--resume"]) == 1
        err = capsys.readouterr().err
        assert err == f"opal_tpu_torch: no checkpoint.npz in {deck.parent}\n"
        return
    if case in ("layout", "qed key"):
        # opal_tpu's file: a 4-device one without n_loc, or any for QED
        _snapshot(tmp_path, 4 if case == "layout" else 1, np.float64)
        if case == "layout":
            _rewrite(tmp_path, n_loc=None)
        else:
            # the species are checked before the key: list a photon
            # species, as an emission deck's file would
            specs["photon"] = SpeciesSpec.photon()
            opts = SimOptions(dt=DT, photon_emission=True)
            _rewrite(tmp_path, species=["electron", "photon"])
    else:
        sim = Simulation(geom, opts, specs, device="cpu")
        st = _electrons(initialize, geom, np.float64, 1536, device="cpu")
        checkpoint.save(tmp_path, 0, 0.0, *sim.init_fields(),
                        {"electron": st}, torch.Generator(),
                        sim.zero_counters(), geom.n_loc)
        if case == "version":
            _rewrite(tmp_path, version=2)
        elif case == "species":
            specs["ion"] = SpeciesSpec.ion("carbon", 6.0, 12.0)
        elif case == "grid":
            geom = GridGeometry(nx=2 * NX, dx=DX, xmin=0.0, n_devices=1)
        else:
            # the 16 bytes of a card's generator (seed and offset)
            _rewrite(tmp_path, **{checkpoint.RNG_DEVICE: np.array("cuda"),
                                  checkpoint.RNG_STATE: np.zeros(16, np.uint8)})
    sim = Simulation(geom, opts, specs, device="cpu")
    with pytest.raises(ValueError, match=REFUSALS[case].replace("[", r"\[")):
        checkpoint.load(tmp_path, sim)
