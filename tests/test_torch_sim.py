"""The slice as a whole: opal_tpu's ``Simulation`` against the port's on
a one-device periodic two-stream state, from the same initial state
(``species.initialize`` draws identically in both packages).

* Mixed precision (f32 particles, f64 fields), fused: opal_tpu's Pallas
  kernel in interpret mode against the port's plain version, with a
  window tight enough that rows miss it, so the maintenance sorts, the
  migration phases and the misfit fallback all run.  The two differ by
  f32 rounding (XLA contracts multiply-adds on the CPU, and the sorts
  order equal keys differently, which moves rows between kernel and
  fallback): fields, currents and particle columns agree within 1e-5
  of each array's largest magnitude, energies within rtol 1e-5.
* f64, unfused, 300 steps at the size of ``tests/test_ref_compare.py``:
  field and kinetic energy curves within 1e-12 relative, the round-off
  bar against opal_tpu at f64 (the field energy, which starts at zero
  from noise, is scaled by max(|E_field|, 1e-9 E_kinetic) as
  ``tools/ref_compare.py`` does).

Neither package may count a loss.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import constants as const
from opal_tpu.cli import build as jbuild
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.grid import em_field_energy_local
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.sim import Simulation as JSim
from opal_tpu.sim import counter_total
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu.species import initialize as jinit
from opal_tpu_torch.cli import build as tbuild
from opal_tpu_torch.convert import fields_from_numpy, state_from_numpy, to_numpy
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize

pytestmark = pytest.mark.unit

NX, NPC, CAP = 64, 16, 1536
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
DECK = Path(__file__).resolve().parents[1] / "examples" / "two_stream.yaml"


def _beams(x, u, nr):
    return 0.25 * np.sign(u - 0.5) * (1.0 + 0.2 * nr)


def _init(mod_init, spec, geom, dtype, **kw):
    return mod_init(
        spec, geom, NPC,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=_beams, uy=lambda x, u, nr: 0.05 * nr,
        uz=lambda x, u, nr: np.zeros_like(x),
        dt=DT, capacity_per_device=CAP, seed=3, dtype=dtype,
        work_dtype=np.float64, **kw,
    )


def test_initialize_draws_identically():
    jst = _init(jinit, JSpec.electron(), JGeom(nx=NX, dx=DX, xmin=0.0,
                                                n_devices=1), np.float32)
    tst = to_numpy(_init(initialize, SpeciesSpec.electron(),
                         GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                         np.float32, device="cpu"))
    for k, v in tst.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jst, k)),
                                      err_msg=k)


def _match_by_tau(cols):
    """Alive rows ordered by tau: the non-QED step never changes tau,
    so it names each particle in both packages."""
    a = cols["alive"]
    order = np.argsort(cols["tau"][a])
    return {k: v[a][order] for k, v in cols.items()}


def close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


def test_fused_mixed_precision_matches_opal_tpu():
    nsteps = 24
    kw = dict(dt=DT, fused_pusher=True, fused_block=128, fused_window=12,
              fused_resort_every=8, migration_every=4,
              max_drift_cells_per_step=0.45, migration_window=256,
              migration_capacity=64, fused_misfit_capacity=256)
    jgeom = JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    jsim = JSim(jgeom, JOptions(**kw), {"electron": JSpec.electron()},
                dtype=jnp.float32, field_dtype=jnp.float64)
    host = _init(jinit, JSpec.electron(), jgeom, np.float32)
    E, B, J, rho = (np.array(a) for a in jsim.init_fields())
    B[:, 2] = 1e-7  # a gyrating orbit: every push term is non-zero
    assert jsim._cadences({"electron": host}) == (4, 8)
    jout = jsim.run(
        *(jnp.asarray(a) for a in (E, B, J, rho)),
        {"electron": jsim.shard_particles(host)}, 0.0, jax.random.key(0),
        jsim.zero_counters(), nsteps,
    )

    tsim = Simulation(GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                      SimOptions(**kw), {"electron": SpeciesSpec.electron()},
                      device="cpu", dtype=torch.float32,
                      field_dtype=torch.float64)
    tout = tsim.run(*fields_from_numpy(E, B, J, rho, device="cpu"),
                    {"electron": state_from_numpy(host, device="cpu")}, 0.0,
                    tsim.zero_counters(), nsteps)

    assert counter_total(jout[6]["electron"]) == 0
    assert int(tout[6]["electron"]) == 0
    assert tout[5] == pytest.approx(float(jout[5]), rel=1e-15)
    for i, name in enumerate(("E", "B", "J", "rho")):
        close(to_numpy(tout[i]), jout[i], 1e-5, name)
    np.testing.assert_allclose(
        tsim.em_field_energy(tout[0], tout[1]),
        jsim.em_field_energy(jout[0], jout[1]), rtol=1e-5)
    np.testing.assert_allclose(
        tsim.total_kinetic_energy("electron", tout[4]["electron"]),
        jsim.total_kinetic_energy("electron", jout[4]["electron"]),
        rtol=1e-5)

    jp = _match_by_tau({k: np.asarray(getattr(jout[4]["electron"], k))
                        for k in ("alive", "tau", "cell", "x", "ux", "uy",
                                  "uz", "gamma", "work", "y")})
    tp = _match_by_tau(to_numpy(tout[4]["electron"]))
    np.testing.assert_array_equal(tp["tau"], jp["tau"])
    # positions as cell + offset, periodic: a row at a cell edge may sit
    # on either side of it after f32 rounding
    dpos = (tp["cell"] + tp["x"].astype(np.float64)) \
        - (jp["cell"] + jp["x"].astype(np.float64))
    dpos = (dpos + NX / 2) % NX - NX / 2
    assert np.abs(dpos).max() < 1e-5
    moved = (jp["cell"] + jp["x"]) - (host.cell + host.x)[host.alive][
        np.argsort(host.tau[host.alive])]
    assert np.abs(moved).max() > NX / 2  # rows crossed the periodic edge
    for k in ("ux", "uy", "uz", "gamma", "y", "work"):
        close(tp[k], jp[k], 1e-5, k)


def _deck(tmp_path):
    src = DECK.read_text().replace("nx: 1000", "nx: 96")
    src = src.replace("npc: 100", "npc: 10")
    path = tmp_path / "deck.yaml"
    path.write_text(src)
    return path


def test_f64_unfused_energy_curves_match(tmp_path):
    deck = _deck(tmp_path)
    steps, every = 300, 10
    jsim, jsp, _ = jbuild(deck, n_devices=1, dtype=jnp.float64,
                          field_dtype=jnp.float64)
    tsim, tsp, _ = tbuild(deck, dtype=torch.float64,
                          field_dtype=torch.float64, device="cpu")
    assert not jsim.options.fused_pusher and not tsim.options.fused_pusher
    tst = to_numpy(tsp["electron"])
    for k, v in tst.items():
        np.testing.assert_array_equal(
            v, np.asarray(getattr(jsp["electron"], k)), err_msg=k)

    jst = (*jsim.init_fields(), jsp, 0.0)
    jc = jsim.zero_counters()
    tst = (*tsim.init_fields(), tsp, 0.0)
    tc = tsim.zero_counters()
    curves = []
    for _ in range(steps // every):
        out = jsim.run(*jst, jax.random.key(0), jc, every)
        jst, jc = out[:6], out[6]
        out = tsim.run(*tst, tc, every)
        tst, tc = out[:6], out[6]
        curves.append((
            # opal_tpu's per-device energy, outside its shard_map (one
            # device holds the whole grid)
            float(em_field_energy_local(jst[0], jst[1], jsim.geom, 0)),
            jsim.total_kinetic_energy("electron", jst[4]["electron"]),
            tsim.em_field_energy(tst[0], tst[1]),
            tsim.total_kinetic_energy("electron", tst[4]["electron"]),
        ))
    fe_j, ke_j, fe_t, ke_t = np.asarray(curves).T
    assert counter_total(jc["electron"]) == 0 and int(tc["electron"]) == 0
    assert fe_j[-1] > 100 * fe_j[0]  # the instability grows
    scale = np.maximum(np.abs(fe_j), 1e-9 * ke_j[0])
    assert np.max(np.abs(fe_t - fe_j) / scale) < 1e-12
    assert np.max(np.abs(ke_t - ke_j) / np.abs(ke_j)) < 1e-12
