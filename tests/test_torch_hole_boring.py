"""The hole_boring slice: ions with the Boris push, the laser and
absorbing boundaries and particle deletion at the domain edges, held
against opal_tpu on the same seeded inputs.

* ``boris_push``: f64 to 1e-13 relative (1e-14 of each array's largest
  magnitude for entries that cancel toward zero), f32 within 1e-6 of
  each array's largest magnitude (a few f32 ulps: XLA contracts
  multiply-adds on the CPU, PyTorch does not).
* ``apply_boundaries`` (laser, absorbing, conducting), ``sm_mask``, the
  non-periodic halo exchange and fold, the non-periodic edge migration
  and the deletion of unfused species, ion ``initialize``: equal, or to
  1e-15 where a float formula is evaluated (the laser term: XLA's and
  numpy's sin, cos and exp may differ by an ulp).
* ``examples/hole_boring.yaml`` as shipped through both CLIs' ``build``:
  the same auto-sized kernel block, window, cadences and capacities.
* A mini hole_boring deck through ``Simulation`` at f64: the field,
  electron and ion energy curves within 1e-12 relative over 200 steps.
* The same deck through both CLIs at the default mixed precision,
  opal_tpu's Pallas kernel in interpret mode: the outputs within the
  tolerances of ``tests/test_torch_cli.py``, except that the edges of
  the auto-ranged histogram axes, set by the extreme particles, may move
  by 1e-3 of a bin.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import opal_tpu.cli as jcli
import opal_tpu_torch.cli as tcli
from opal_tpu import constants as const
from opal_tpu import grid as jgrid
from opal_tpu.config import Config as JConfig
from opal_tpu.fields import sm_mask as j_sm_mask
from opal_tpu.grid import em_field_energy_local
from opal_tpu.ops import pusher as jpush
from opal_tpu.parallel import halo as jhalo
from opal_tpu.parallel import migrate as JM
from opal_tpu.sim import counter_total
from opal_tpu.species import ParticleState as JState
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu.species import initialize as jinit
from opal_tpu_torch import grid as tgrid
from opal_tpu_torch.config import Config as TConfig
from opal_tpu_torch.convert import state_from_numpy, to_numpy
from opal_tpu_torch.diagnostics.fits import read_image
from opal_tpu_torch.fields import sm_mask as t_sm_mask
from opal_tpu_torch.ops import pusher as tpush
from opal_tpu_torch.parallel import halo as thalo
from opal_tpu_torch.parallel import migrate as TM
from opal_tpu_torch.species import SpeciesSpec, initialize

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
NX = 64
DX = 1e-8
DT = 0.95 * DX / const.SPEED_OF_LIGHT
CARBON = dict(charge_state=6.0, mass_number=12.0)

#: a hole_boring deck cut to nx 800, npc 10 and 200 steps: the slab
#: (-0.5 .. 1.5 um) meets the pulse's peak near step 150.  The fused
#: block, window and subblocks are pinned small, so that opal_tpu's
#: interpret-mode kernel compiles quickly (the port reads no
#: ``fused_subblocks``); the resort cadence of 8 keeps every block
#: inside its window.
MINI = """\
control:
 dx: micro / 100
 nx: 800
 xmin: -2*micro
 start: -2.0e-6/c
 end: -0.1e-6/c
 current_deposition: true
 n_outputs: 2

qed:
 photon_emission: false
 photon_absorption: false

electrons:
 npc: 10
 ne: density * critical(omega) * step(x,xmin,xmax)
 ux: sqrt(kT/(m*c^2)) * nrand
 uy: sqrt(kT/(m*c^2)) * nrand
 uz: sqrt(kT/(m*c^2)) * nrand
 output: [x:px, x:p_perp]

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

tpu:
 fused_block: 128
 fused_window: 40
 fused_resort_every: 8
 fused_subblocks: 1
"""
MINI_STEPS = 200
MINI_PARTICLES = 2000  # per species: 200 slab cells x npc 10


def close(got, want, rtol, atol_rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale,
                               err_msg=name)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _one_device(fn, *args):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(),) * len(args), out_specs=P(),
        check_vma=False,
    ))(*args)


def _geoms(right="absorbing", nx=NX):
    kw = dict(nx=nx, dx=DX, xmin=0.0, n_devices=1, left_boundary="laser",
              right_boundary=right)
    return jgrid.GridGeometry(**kw), tgrid.GridGeometry(**kw)


def _jax_state(cols):
    fields = {f.name: None for f in dataclasses.fields(JState)}
    fields.update({k: jnp.asarray(v) for k, v in cols.items()})
    return JState(**fields)


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_boris_push(dtype):
    """Carbon ions in fields strong enough to turn them within a step
    (E ~ 1e12 V/m, B ~ 1e3 T, momenta up to u ~ 0.05), some rows
    crossing cells; gamma - 1 stays accurate for the cold rows."""
    rng = np.random.default_rng(11)
    n = 4096
    f = lambda a: np.asarray(a, dtype)
    cell = rng.integers(0, NX, n).astype(np.int32)
    x, y, z = f(rng.random(n)), f(rng.normal(0, 1e-6, n)), f(rng.normal(0, 1e-6, n))
    u = f(rng.normal(0.0, 0.02, (n, 3)) * (rng.random((n, 1)) < 0.9))
    E = f(rng.normal(0.0, 1e12, (n, 3)))
    B = f(rng.normal(0.0, 1e3, (n, 3)))
    spec = JSpec.ion("carbon", **CARBON)
    q, m = f(np.full(n, spec.charge)), f(np.full(n, spec.mass))
    rj = jpush.boris_push(*map(jnp.asarray, (cell, x, y, z, u, q, m, E, B)),
                          DX, DT)
    rt = tpush.boris_push(*map(t, (cell, x, y, z, u, q, m, E, B)), DX, DT)
    np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
    assert (np.asarray(rj[0]) != cell).any()  # some rows cross
    rtol, atol = (1e-13, 1e-14) if dtype == np.float64 else (0.0, 1e-6)
    for i, name in enumerate(("x", "prev_x", "y", "z", "u", "gamma_m1"), 1):
        assert rt[i].dtype == torch.from_numpy(x).dtype, name
        close(rt[i], rj[i], rtol, atol, name)
    # gamma - 1 of the cold (u = 0 before the kick) rows is resolved
    assert (np.asarray(rt[6])[u[:, 0] == 0] > 0).all()


def _laser_fns():
    """The hole_boring deck's laser fields through each package's
    expression evaluator."""
    deck = (ROOT / "examples" / "hole_boring.yaml").read_text()
    out = []
    for C in (JConfig, TConfig):
        cfg = C.from_string(deck)
        cfg.with_context("constants")
        out.append((cfg.func2("laser", "Ey", ("t", "x")),
                    cfg.func2("laser", "Ez", ("t", "x"))))
    return out


@pytest.mark.parametrize("right", ["laser", "absorbing", "conducting"])
def test_apply_boundaries(right):
    """One case each: the laser injection (with an absorbing right
    edge, at a time near the pulse's peak), the absorbing ramp and its
    hard zero, and the conducting mirror (each without the laser)."""
    jg, tg = _geoms("absorbing" if right == "laser" else right)
    rng = np.random.default_rng(5)
    E = rng.normal(0.0, 1e10, (tg.n_loc, 3))
    B = rng.normal(0.0, 30.0, (tg.n_loc, 3))
    (jy, jz), (ty, tz) = _laser_fns() if right == "laser" else ((None,) * 2,) * 2
    t0 = (jg.xmin - 2.0 * DX) / const.SPEED_OF_LIGHT + 2e-15
    Ej, Bj = jgrid.apply_boundaries(
        jnp.asarray(E), jnp.asarray(B), jg, 0, t0, DT,
        jy or (lambda t_, x_: 0.0), jz or (lambda t_, x_: 0.0),
    )
    Et, Bt = tgrid.apply_boundaries(t(E), t(B), tg, 0, t0, DT, ty, tz)
    Ej, Bj = np.asarray(Ej), np.asarray(Bj)
    changed = (Ej != E).any(axis=1) | (Bj != B).any(axis=1)
    assert changed.any()
    if right == "laser":
        assert abs(Ej[2, 1] - E[2, 1]) > 1e12  # a strong injection
    for got, want, name in ((Et, Ej, "E"), (Bt, Bj, "B")):
        close(got.numpy(), want, 1e-15, 1e-15, name)


def test_sm_mask_laser():
    jg, tg = _geoms()
    np.testing.assert_array_equal(t_sm_mask(tg, "cpu").numpy(),
                                  np.asarray(j_sm_mask(jg, 0)))
    assert int(t_sm_mask(tg, "cpu").sum()) == 2


def test_halo_non_periodic():
    """At one non-periodic device the halo is zero and the spill is
    dropped: equal bit for bit."""
    jg, tg = _geoms()
    rng = np.random.default_rng(9)
    n_slab = tg.n_loc + 2 * tgrid.HALO
    E, B = rng.normal(size=(2, tg.n_loc, 3))
    J, rho = rng.normal(size=(n_slab, 3)), rng.normal(size=n_slab)

    def dev(E, B, J, rho):
        ai = jax.lax.axis_index("x")
        Es, Bs = jhalo.exchange_fields(E, B, jg, "x", ai)
        Jf, rf = jhalo.fold_currents(J, rho, jg, "x", ai)
        return Es, Bs, Jf, rf

    out = _one_device(dev, *map(jnp.asarray, (E, B, J, rho)))
    got = (*thalo.exchange_fields(t(E), t(B), tg),
           *thalo.fold_currents(t(J), t(rho), tg))
    for g, w, name in zip(got, out, "EBJr"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert not got[0][:tgrid.HALO].any() and not got[0][-tgrid.HALO:].any()


# ---------------------------------------------------------------------
# species and migration
# ---------------------------------------------------------------------


def _ion_init(mod_init, geom, dtype, **kw):
    spec_cls = JSpec if mod_init is jinit else SpeciesSpec
    return mod_init(
        spec_cls.ion("carbon", **CARBON), geom, 8,
        density=lambda x: np.where((x > 8 * DX) & (x < 40 * DX), 1e28, 0.0),
        ux=lambda x, u, nr: 0.01 * nr, uy=lambda x, u, nr: 0.002 * nr,
        uz=lambda x, u, nr: 0.003 * (u - 0.5),
        dt=DT, capacity_per_device=512, seed=4, dtype=dtype, **kw,
    )


def test_ion_initialize_draws_identically():
    jg, tg = _geoms()
    jst = _ion_init(jinit, jg, np.float32)
    tst = _ion_init(initialize, tg, np.float32, device="cpu")
    assert tst.tau is None and tst.work is None
    cols = to_numpy(tst)
    assert cols.keys() == {f.name for f in dataclasses.fields(JState)
                           if getattr(jst, f.name) is not None}
    for k, v in cols.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jst, k)),
                                      err_msg=k)
    assert cols["alive"].sum() == 32 * 8


def _lexsorted(cols):
    a = cols["alive"]
    order = np.lexsort((cols["ux"][a], cols["x"][a], cols["cell"][a]))
    return {k: v[a][order] for k, v in cols.items()}


def _edge_state(sort):
    """A cell-sorted (or not) f64 ion state on a laser/absorbing grid
    with rows moved into the laser zone, the absorbing zone and out of
    the slab on both sides, as pushes leave them."""
    jg, tg = _geoms()
    cols = to_numpy(_ion_init(initialize, tg, np.float64, device="cpu"))
    if sort:
        cols = to_numpy(TM.sort_state(state_from_numpy(cols, device="cpu"), tg.n_loc))
    live = np.flatnonzero(cols["alive"])
    moves = {live[0]: -1, live[1]: 2, live[2]: 3, live[-1]: tg.n_loc,
             live[-2]: tg.interior_end, live[-3]: tg.interior_end + 5}
    for row, cell in moves.items():
        cols["cell"][row] = cell
    return jg, tg, cols, len(moves)


def test_migrate_edges_non_periodic():
    """Every row that left the interior is deleted (alive False, weight
    0, gamma 1); nothing is sent, nothing overflows."""
    jg, tg, cols, n_out = _edge_state(sort=True)

    def dev(st):
        return JM.migrate_edges(st, jg, "x", jax.lax.axis_index("x"), 64,
                                128)

    js, jovf = _one_device(dev, _jax_state(cols))
    ts, tovf = TM.migrate_edges(state_from_numpy(cols, device="cpu"), tg,
                                64, 128)
    tc = to_numpy(ts)
    assert int(tovf) == int(jovf) == 0
    jc = {k: np.asarray(getattr(js, k)) for k in cols}
    for a, b in ((_lexsorted(tc), _lexsorted(jc)), (tc, jc)):
        for k in cols:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tc["alive"].sum() == cols["alive"].sum() - n_out
    inside = (tc["cell"] >= tg.interior_start) & (tc["cell"] < tg.interior_end)
    assert inside[tc["alive"]].all()
    np.testing.assert_array_equal(tc["gamma"][~tc["alive"]], 1.0)


def test_wrap_kill_non_periodic():
    """Deletion for unfused species, against opal_tpu's full-state
    ``migrate`` (``parallel/migrate.py:100-113``) at one device, which
    moves rows: alive rows compared as multisets."""
    jg, tg, cols, n_out = _edge_state(sort=False)

    def dev(st):
        return JM.migrate(st, jg, "x", jax.lax.axis_index("x"), 64)

    js, jovf = _one_device(dev, _jax_state(cols))
    ts, tovf = TM.wrap_kill(state_from_numpy(cols, device="cpu"), tg)
    assert int(tovf) == int(jovf) == 0
    jc = _lexsorted({k: np.asarray(getattr(js, k)) for k in cols})
    tc = _lexsorted(to_numpy(ts))
    assert len(tc["x"]) == cols["alive"].sum() - n_out
    for k in cols:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)


# ---------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------


def _mini(tmp_path: Path, name: str):
    path = tmp_path / name
    path.mkdir()
    (path / "deck.yaml").write_text(MINI)
    return path / "deck.yaml"


def test_full_deck_sizing_matches_opal_tpu():
    """``examples/hole_boring.yaml`` as shipped, built by both CLIs at
    mixed precision on one device: the same auto-sized fused block,
    window, cadences and capacities (the laser-deck rules), and the
    same initial populations."""
    deck = ROOT / "examples" / "hole_boring.yaml"
    jsim, jsp, jrp = jcli.build(deck, n_devices=1, dtype=jnp.float32,
                                field_dtype=jnp.float64)
    tsim, tsp, trp = tcli.build(deck, device="cpu")
    names = ("fused_pusher", "fused_block", "fused_window",
             "fused_resort_every", "migration_every", "fused_misfit_capacity",
             "migration_window", "migration_capacity",
             "max_drift_cells_per_step", "dt")
    got = {k: getattr(tsim.options, k) for k in names}
    assert got == {k: getattr(jsim.options, k) for k in names}
    assert (got["fused_block"], got["fused_window"], got["fused_resort_every"],
            got["migration_every"], got["fused_misfit_capacity"],
            got["migration_window"]) == (2048, 56, 16, 1, 94_208, 4096)
    assert trp["capacities"] == jrp["capacities"] == {
        "electron": 753_664, "ion": 753_664}
    assert tsim.geom.n_loc == jsim.geom.n_loc == 4 + 20_000 + 200
    assert trp["total_steps"] == jrp["total_steps"] == 31_578
    for name in ("electron", "ion"):
        assert tsim._fused_applicable(name, tsp[name])
        assert jsim._fused_applicable(name, jsp[name])
        assert int(tsp[name].alive.sum()) == 500_000
        np.testing.assert_array_equal(tsp[name].ux.numpy(),
                                      np.asarray(jsp[name].ux), err_msg=name)


def test_f64_energy_curves_match(tmp_path):
    """Both species unfused at f64, the laser entering the slab: the
    energy curves agree to round-off."""
    deck = _mini(tmp_path, "f64")
    every = 20
    jsim, jsp, rp = jcli.build(deck, n_devices=1, dtype=jnp.float64,
                               field_dtype=jnp.float64)
    tsim, tsp, _ = tcli.build(deck, dtype=torch.float64,
                              field_dtype=torch.float64, device="cpu")
    assert not jsim.options.fused_pusher and not tsim.options.fused_pusher
    for name in ("electron", "ion"):
        for k, v in to_numpy(tsp[name]).items():
            np.testing.assert_array_equal(
                v, np.asarray(getattr(jsp[name], k)), err_msg=f"{name} {k}")
    jst = (*jsim.init_fields(), jsp, rp["tstart"])
    tst = (*tsim.init_fields(), tsp, rp["tstart"])
    jc, tc = jsim.zero_counters(), tsim.zero_counters()
    curves = []
    for _ in range(MINI_STEPS // every):
        out = jsim.run(*jst, jax.random.key(0), jc, every)
        jst, jc = out[:6], out[6]
        out = tsim.run(*tst, tc, every)
        tst, tc = out[:6], out[6]
        curves.append((
            float(em_field_energy_local(jst[0], jst[1], jsim.geom, 0)),
            jsim.total_kinetic_energy("electron", jst[4]["electron"]),
            jsim.total_kinetic_energy("ion", jst[4]["ion"]),
            tsim.em_field_energy(tst[0], tst[1]),
            tsim.total_kinetic_energy("electron", tst[4]["electron"]),
            tsim.total_kinetic_energy("ion", tst[4]["ion"]),
        ))
    c = np.asarray(curves).T
    for name in ("electron", "ion"):
        assert counter_total(jc[name]) == 0 and int(tc[name]) == 0
    assert c[0, -1] > 0 and c[1, -1] > 1.01 * c[1, 0]  # the laser heats
    for j, name in enumerate(("em_field", "electrons", "ions")):
        err = np.abs(c[3 + j] - c[j]) / np.abs(c[j]).max()
        assert err.max() < 1e-12, (name, err.max())


def _energies(path):
    return {k: float(v) for k, v in
            (line.split() for line in path.read_text().splitlines())}


def test_hole_boring_outputs_match(tmp_path, capsys):
    """The mini deck through ``opal_tpu.cli.main`` (one device, the
    Pallas kernel in interpret mode) and ``opal_tpu_torch.cli.main
    --device cpu`` at mixed precision, with the tolerances of
    ``tests/test_torch_cli.py``."""
    jdeck, tdeck = _mini(tmp_path, "jax"), _mini(tmp_path, "torch")
    assert jcli.main([str(jdeck), "--devices", "1"]) == 0
    jout = capsys.readouterr()
    assert tcli.main([str(tdeck), "--device", "cpu"]) == 0
    tout = capsys.readouterr()
    for o in (jout, tout):
        assert "[fused pusher: electron, ion]" in o.out
        assert "Output    2 at t =" in o.out
        assert "warning" not in o.err
    jd, td = jdeck.parent, tdeck.parent
    for i in range(3):
        g_j = np.loadtxt(jd / f"{i}_grid.dat")
        g_t = np.loadtxt(td / f"{i}_grid.dat")
        assert g_t.shape == (800, 11)
        for c in range(11):
            np.testing.assert_allclose(
                g_t[:, c], g_j[:, c], rtol=0,
                atol=1e-5 * np.abs(g_j[:, c]).max(),
                err_msg=f"{i}_grid.dat column {c}",
            )
        e_j = _energies(jd / f"{i}_energy.dat")
        e_t = _energies(td / f"{i}_energy.dat")
        assert e_t.keys() == e_j.keys() and e_t["ions"] > 0
        for k in e_j:
            np.testing.assert_allclose(e_t[k], e_j[k], rtol=1e-5, err_msg=k)
        for stem in ("electron_x-px", "electron_x-p_perp", "carbon_x-px"):
            im_j, h_j = read_image(jd / f"{i}_{stem}.fits")
            im_t, h_t = read_image(td / f"{i}_{stem}.fits")
            quantum = im_j.sum() / MINI_PARTICLES
            assert np.abs(im_t - im_j).sum() <= 4 * quantum, stem
            assert h_t.keys() == h_j.keys()
            for k, v in h_j.items():
                if k in ("DATAMIN", "DATAMAX"):
                    assert abs(h_t[k] - v) <= 2 * quantum, (stem, k)
                elif k[:5] in ("CRVAL", "CDELT"):
                    # auto-ranged axes end at the extreme particles,
                    # whose laser-driven orbits part by f32 rounding:
                    # the bins may move by 1e-3 of a bin
                    bin_sz = abs(h_j["CDELT" + k[5:]])
                    assert abs(h_t[k] - v) <= 1e-3 * bin_sz, (stem, k)
                elif isinstance(v, float):
                    np.testing.assert_allclose(h_t[k], v, rtol=1e-6,
                                               err_msg=f"{stem} {k}")
                else:
                    assert h_t[k] == v, (stem, k)
