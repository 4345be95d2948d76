"""``opal_tpu_torch.species.initialize_device`` against opal_tpu's
``species.initialize_device`` on the CPU.

The same deck (a laser-left, absorbing-right grid, so that the left
zone shifts the cell centres and the zones' cells hold dead rows; a
density that is zero over the first tenth of the interior; a capacity
with spare rows) goes through opal_tpu on the conftest's CPU mesh of
``world`` devices and through the port once a rank, the ranks' blocks
concatenated.  The two draw from different generators (threefry keys
folded by device against a ``torch.Generator`` seeded by rank), so:

* every column that no draw reaches (``cell``, ``alive``, ``weight``,
  ``y``, ``z``, ``chi``, ``work``, ``pol``) and every dead row's values
  equal opal_tpu's row for row, the weights bitwise (one host f64 table
  cast to the dtype), with the shapes and dtypes (but for photons'
  ``birth_time``, which opal_tpu's device draw promotes to JAX's
  default float: the port keeps it in the state's dtype);
* each alive row is consistent with itself, recomputed in f64 from the
  row's own columns: ``gamma`` is sqrt(1 + u^2) (photons |k|) within
  1e-12 at f64 and 2**-23 relative at f32 (the rounding of three f32
  operations); ``prev_x`` is x less the step's drift within 1e-12 at
  f64 and 2**-21 at f32 (up to eight f32 roundings of numbers below 2:
  a photon's drift is 0.95 cells a step); ``uy``, a
  function of the position, matches the row's own position within
  1e-12 of its largest value at f64 and 4 * 2**-23 at f32 (the
  position's f32 sum of cell index and offset rounds at the ulp of a
  cell index of up to 272, ~2 * 2**-23 of the column's scale);
* the random columns hold at the distribution level, as
  ``tests/test_device_init.py`` holds opal_tpu's device draw against
  its host draw: x's mean 0.5 within 0.02 (~4 standard errors at
  these counts), |ux|'s mean the drift's within 1%, each optical
  depth's mean 1 within 4 standard errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import species as JS
from opal_tpu.fields import make_mesh
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu_torch import constants as const
from opal_tpu_torch import species as S
from opal_tpu_torch.grid import GridGeometry

pytestmark = pytest.mark.unit

NX, DX, NPC, SPARE, DRIFT = 64, 500.0, 64, 40, 3.0e-2
DT = 0.95 * DX / const.SPEED_OF_LIGHT
GEOM = dict(nx=NX, dx=DX, xmin=-1000.0, left_boundary="laser",
            right_boundary="absorbing")


def density(x):
    x = np.asarray(x)
    return np.where(x < GEOM["xmin"] + 0.1 * NX * DX, 0.0,
                    20.0 * (1.0 + 0.5 * np.sin(2 * np.pi * x / (NX * DX))))


def momenta(lib):
    """(ux, uy, uz) with ``lib`` (jnp or torch): the two-stream drift,
    a transverse momentum that grows with x, none along z."""
    return (lambda x, u, n: DRIFT * (1.0 + 0.001 * n) * lib.sign(u - 0.5),
            lambda x, u, n: 1e-3 * x / (NX * DX),
            lambda x, u, n: lib.zeros_like(x))


def draw_port(kind, geom, cap, dtype, seed=3, rank=None, npc=NPC):
    spec = getattr(S.SpeciesSpec, kind)()
    ranks = range(geom.n_devices) if rank is None else [rank]
    blocks = [S.initialize_device(spec, geom, npc, density, *momenta(torch),
                                  DT, cap, seed=seed, dtype=dtype, rank=r,
                                  device="cpu")
              for r in ranks]
    return {k: torch.cat([getattr(b, k) for b in blocks]).numpy()
            for k, v in blocks[0].columns().items()}


def draw_jax(kind, world, cap, dtype):
    geom = JGeom(n_devices=world, **GEOM)
    st = JS.initialize_device(
        getattr(JS.SpeciesSpec, kind)(), geom, make_mesh(world), NPC,
        density, *momenta(jnp), DT, cap, seed=3, dtype=dtype)
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st) if getattr(st, f.name) is not None}


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["electron", "photon"])
def test_initialize_device_matches_opal_tpu(kind, dtype, world):
    geom = GridGeometry(n_devices=world, **GEOM)
    cap = geom.n_loc * NPC + SPARE
    got = draw_port(kind, geom, cap, dtype)
    want = draw_jax(kind, world, cap,
                    jnp.float64 if dtype == torch.float64 else jnp.float32)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        # opal_tpu's birth_time, jnp.where(alive, 0.0, -inf), takes JAX's
        # default float (f64 under x64); the port keeps the state's dtype,
        # as both packages' host draws do
        assert got[k].dtype == (np.dtype(str(dtype)[6:])
                                if k == "birth_time" else want[k].dtype), k
    for k in ("cell", "alive", "weight", "y", "z", "chi", "work", "pol"):
        if k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    alive = got["alive"]
    assert 0 < alive.sum() < alive.size
    for k in got:
        np.testing.assert_array_equal(got[k][~alive], want[k][~alive],
                                      err_msg=k)
    # the per-cell counts of the extended grid
    glob = lambda st: (np.flatnonzero(st["alive"]) // cap * geom.n_loc
                       + st["cell"][st["alive"]])
    np.testing.assert_array_equal(np.bincount(glob(got), minlength=geom.n_ext),
                                  np.bincount(glob(want), minlength=geom.n_ext))

    # each alive row against itself, in f64
    f64 = dtype == torch.float64
    tol = 1e-12 if f64 else 2.0**-23
    col = lambda k: got[k][alive].astype(np.float64)
    u = np.stack([col("ux"), col("uy"), col("uz")], -1)
    k0 = np.sqrt(np.sum(u * u, -1))
    gamma = k0 if kind == "photon" else np.sqrt(1.0 + k0 * k0)
    np.testing.assert_allclose(col("gamma"), gamma, rtol=tol, atol=0)
    x = col("x")
    prev = x - const.SPEED_OF_LIGHT * u[:, 0] / gamma * DT / DX
    np.testing.assert_allclose(col("prev_x"), prev, rtol=0,
                               atol=1e-12 if f64 else 2.0**-21)
    g = np.flatnonzero(alive) // cap * geom.n_loc + got["cell"][alive]
    real_x = (g - geom.left_pad + x) * DX + GEOM["xmin"]
    uy = 1e-3 * real_x / (NX * DX)
    np.testing.assert_allclose(u[:, 1], uy, rtol=0,
                               atol=(1 if f64 else 4) * tol * np.abs(uy).max())

    # the random columns' distributions
    assert abs(x.mean() - 0.5) < 0.02 and ((x >= 0) & (x < 1)).all()
    assert abs(np.abs(u[:, 0]).mean() - DRIFT) < 0.01 * DRIFT
    depths = ("tau_abs", "tau_st") if kind == "photon" else ("tau",)
    for k in depths:
        t = col(k)
        assert (t > 0).all() and abs(t.mean() - 1.0) < 4.0 / np.sqrt(t.size), k
    if kind == "photon":
        np.testing.assert_array_equal(got["basis"][alive],
                                      np.concatenate([u, u], 1).astype(
                                          got["basis"].dtype))
        assert (got["birth_time"][alive] == 0).all()


def test_initialize_device_seed_and_rank():
    """A seed and rank reproduce the same block; the ranks draw different
    streams (rank 0 from the seed itself); too small a capacity raises."""
    geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=4)
    cap = geom.n_loc * NPC
    a = draw_port("electron", geom, cap, torch.float64, seed=5, rank=2)
    b = draw_port("electron", geom, cap, torch.float64, seed=5, rank=2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    c = draw_port("electron", geom, cap, torch.float64, seed=5, rank=3)
    assert not np.isin(a["x"][a["alive"]], c["x"][c["alive"]]).any()
    assert S.rank_seed(5, 0) == 5 and S.rank_seed(5, 2) != S.rank_seed(5, 3)
    first = torch.Generator().manual_seed(5)
    r0 = draw_port("electron", geom, cap, torch.float64, seed=5, rank=0)
    np.testing.assert_array_equal(
        r0["x"][r0["alive"]],
        torch.rand(cap, generator=first, dtype=torch.float64).numpy()[
            r0["alive"]])
    with pytest.raises(ValueError, match="capacity >= n_loc"):
        draw_port("electron", geom, cap - 1, torch.float64, rank=0)


def test_initialize_device_defaults_to_the_card():
    """Without a card the default device raises before anything is
    drawn."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    with pytest.raises((RuntimeError, AssertionError)):
        S.initialize_device(S.SpeciesSpec.electron(), geom, NPC, density,
                            *momenta(torch), DT, geom.n_loc * NPC)
