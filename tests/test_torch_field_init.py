"""The electrostatic field set-up: ``opal_tpu_torch.fields.
electrostatic_init`` and ``Simulation.initialize_fields`` against
opal_tpu's on the same seeded inputs.

* ``electrostatic_init`` on the same global rho and J as opal_tpu's on
  1 and on 8 devices (a global cumsum of per-device prefixes there, one
  ``torch.cumsum`` here), laser/absorbing and periodic grids: f64
  within 1e-12 of each field's largest magnitude; against a serial
  numpy sweep with the same bar.
* A uniform neutral plasma (electrons and protons at rest in the same
  places) deposits no charge and no current: the fields stay zero.
* ``initialize_fields`` on a small two-species state and on its
  electrons alone: at f64 within 1e-12 of each field's scale, at mixed
  precision (f32 particles, f64 fields) within 1e-5 (the deposit's
  macrocharges and velocities round to f32 in another order).
* Both CLIs on one small deck with ``initialise_fields: true`` at
  ``--f64``: ``0_grid.dat`` within 1e-10 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import opal_tpu.cli as jcli
import opal_tpu_torch.cli as tcli
from opal_tpu import constants as const
from opal_tpu import fields as jfields
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu_torch.fields import electrostatic_init
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize
from test_torch_hole_boring import MINI

pytestmark = pytest.mark.unit

#: grids whose extended size is a multiple of 8 (4 + 60 + 200 cells with
#: the laser and absorbing zones), so that 1 and 8 devices hold the same
#: global grid
GRIDS = {
    "laser": dict(nx=60, left_boundary="laser", right_boundary="absorbing"),
    "periodic": dict(nx=64),
}


def _geom(mod_geom, boundary, n_devices=1):
    return mod_geom(dx=1.0e-6, xmin=0.0, n_devices=n_devices,
                    **GRIDS[boundary])


def _sources(n_ext, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n_ext) * 1e-6, rng.standard_normal((n_ext, 3)) * 1e2


def _port(geom, rho, J):
    E = torch.zeros((geom.n_ext, 3), dtype=torch.float64)
    B = torch.zeros_like(E)
    E, B = electrostatic_init(E, B, torch.from_numpy(J), torch.from_numpy(rho),
                              geom)
    return E.numpy(), B.numpy()


def _opal_tpu(geom, rho, J):
    mesh = jfields.make_mesh(geom.n_devices)
    E, B, Jz, rz = jfields.zero_fields(geom, mesh)
    J = jax.device_put(jnp.asarray(J), Jz.sharding)
    rho = jax.device_put(jnp.asarray(rho), rz.sharding)

    def device_fn(E, B, J, rho):
        return jfields.electrostatic_init(E, B, J, rho, geom, "x",
                                          lax.axis_index("x"))

    E, B = jax.jit(jax.shard_map(
        device_fn, mesh=mesh, check_vma=False,
        in_specs=(P("x", None),) * 3 + (P("x"),),
        out_specs=(P("x", None), P("x", None)),
    ))(E, B, J, rho)
    return np.asarray(E), np.asarray(B)


def close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


@pytest.mark.parametrize("n_devices", [1, 8])
@pytest.mark.parametrize("boundary", list(GRIDS))
def test_electrostatic_init_matches_opal_tpu(boundary, n_devices):
    geom = _geom(GridGeometry, boundary)
    jgeom = _geom(JGeom, boundary, n_devices)
    assert geom.n_ext == jgeom.n_ext
    rho, J = _sources(geom.n_ext)
    E, B = _port(geom, rho, J)
    jE, jB = _opal_tpu(jgeom, rho, J)
    for name, got, want in (("Ex", E[:, 0], jE[:, 0]), ("By", B[:, 1], jB[:, 1]),
                            ("Bz", B[:, 2], jB[:, 2])):
        close(got, want, 1e-12, name)
    np.testing.assert_array_equal(E[:, 1:], 0.0)
    np.testing.assert_array_equal(B[:, 0], 0.0)


@pytest.mark.parametrize("boundary", list(GRIDS))
def test_gauss_law_prefix_sweep(boundary):
    """dEx/dx = rho/eps0, dBy/dx = mu0 jz and dBz/dx = -mu0 jy from the
    infinite-sheet boundary values, against a serial sweep (the port of
    ``tests/test_field_init.py::test_gauss_law_prefix_sweep_multidevice``);
    the left laser zone holds the boundary values."""
    geom = _geom(GridGeometry, boundary)
    rho, J = _sources(geom.n_ext, seed=1)
    E, B = _port(geom, rho, J)

    s, e, dx = geom.interior_start, geom.interior_end, geom.dx
    eps0, mu0 = const.VACUUM_PERMITTIVITY, const.VACUUM_PERMEABILITY
    acc = np.array([-rho[s:e].sum() * dx / (2 * eps0),
                    -mu0 * J[s:e, 2].sum() * dx / 2,
                    mu0 * J[s:e, 1].sum() * dx / 2])
    ref = np.zeros((geom.n_ext, 3))
    ref[: geom.left_pad] = acc
    for i in range(geom.left_pad, geom.n_ext):
        acc = acc + (dx * rho[i] / eps0, mu0 * dx * J[i, 2],
                     -mu0 * dx * J[i, 1])
        ref[i] = acc
    for k, (name, got) in enumerate((("Ex", E[:, 0]), ("By", B[:, 1]),
                                     ("Bz", B[:, 2]))):
        close(got, ref[:, k], 1e-12, name)


def test_uniform_neutral_plasma_gives_zero_field():
    """Electrons and protons at rest in the same places: their deposits
    cancel exactly, so every field stays zero."""
    geom = _geom(GridGeometry, "laser")
    dt = 0.95 * geom.dx / const.SPEED_OF_LIGHT
    specs = {"electron": SpeciesSpec.electron(),
             "ion": SpeciesSpec.ion("proton", 1.0, 1.0)}
    sim = Simulation(geom, SimOptions(dt=dt), specs, device="cpu")
    zero = lambda x, u, n: np.zeros_like(x)
    e = initialize(specs["electron"], geom, 8,
                   lambda x: np.full_like(x, 1e20), zero, zero, zero, dt,
                   capacity_per_device=512, seed=2, device="cpu")
    ions = dataclasses.replace(e, tau=None, work=None)
    assert int(e.alive.sum()) == 480
    E, B, J, rho = sim.initialize_fields(*sim.init_fields(),
                                         {"electron": e, "ion": ions})
    for name, a in (("E", E), ("B", B), ("J", J), ("rho", rho)):
        assert not a.any(), name


def _mini_deck(electrons_only=False):
    deck = MINI
    if electrons_only:
        deck = deck.replace(" name: carbon\n npc: 10\n", " name: carbon\n npc: 0\n")
    return deck.replace("control:\n", "control:\n initialise_fields: true\n", 1)


@pytest.mark.parametrize("electrons_only", [False, True],
                         ids=["both", "electrons"])
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_initialize_fields_matches_opal_tpu(precision, electrons_only,
                                            tmp_path):
    """The mini hole_boring deck's initial state (both species, whose
    fields are the noise of a neutral slab, or its electrons alone,
    whose fields have a real scale) through both packages'
    ``initialize_fields``."""
    deck = tmp_path / "deck.yaml"
    deck.write_text(_mini_deck(electrons_only))
    f64 = precision == "f64"
    jsim, jsp, jrp = jcli.build(
        deck, n_devices=1, dtype=jnp.float64 if f64 else jnp.float32,
        field_dtype=jnp.float64)
    tsim, tsp, trp = tcli.build(
        deck, dtype=torch.float64 if f64 else torch.float32,
        field_dtype=torch.float64, device="cpu")
    assert jrp["initialise_fields"] and trp["initialise_fields"]
    assert sorted(tsp) == sorted(jsp) == (
        ["electron"] if electrons_only else ["electron", "ion"])
    got = tsim.initialize_fields(*tsim.init_fields(), tsp)
    want = jsim.initialize_fields(*jsim.init_fields(), jsp)
    rel = 1e-12 if f64 else 1e-5
    for name, g, w in zip(("E", "B", "J", "rho"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and np.abs(w).max() > 0, name
        close(g.numpy(), w, rel, name)
    Ex = got[0][:, 0].numpy()
    if electrons_only:
        # the slab's charge: Ex falls across it by rho_tot dx / eps0
        assert Ex.max() - Ex.min() > 1e11


def test_cli_grid_matches_opal_tpu(tmp_path, capsys):
    """``0_grid.dat`` of both CLIs at ``--f64`` on the mini deck with
    ``initialise_fields: true``, cut to 2 steps and one output."""
    deck = _mini_deck().replace("end: -0.1e-6/c", "end: -1.99e-6/c")
    deck = deck.replace("n_outputs: 2", "n_outputs: 1")
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "deck.yaml").write_text(deck)
    assert jcli.main([str(tmp_path / "jax" / "deck.yaml"), "--devices", "1",
                      "--f64"]) == 0
    assert tcli.main([str(tmp_path / "torch" / "deck.yaml"), "--device", "cpu",
                      "--f64"]) == 0
    assert "warning" not in capsys.readouterr().err
    g_j = np.loadtxt(tmp_path / "jax" / "0_grid.dat")
    g_t = np.loadtxt(tmp_path / "torch" / "0_grid.dat")
    assert g_t.shape == (800, 11) and np.abs(g_j[:, 1]).max() > 0
    for c in range(11):
        np.testing.assert_allclose(
            g_t[:, c], g_j[:, c], rtol=1e-10,
            atol=1e-10 * np.abs(g_j[:, c]).max(), err_msg=f"column {c}")
