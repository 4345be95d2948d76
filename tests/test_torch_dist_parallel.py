"""The port's layer of collectives on several ranks against opal_tpu on
as many virtual devices (``tests/conftest.py`` gives JAX 8 of them).

The port's ranks are ``gloo`` processes (``tests/test_torch_dist_ranks.py``);
opal_tpu runs the same function under ``shard_map`` in the test process,
on the same inputs made from a seed with numpy:

* the halo exchange and current fold (``exchange_fields``,
  ``fold_currents``) at N = 1, 2, 4, periodic and not: bitwise;
* the edge migration of a cell-sorted state (``migrate_edges``), its
  packed form (``migrate_edges_packed``, windowed and whole-array) and
  the compact migration of an unsorted species (``migrate_compact``), at
  N = 2 and 4, with leavers on both sides of every slab and rows deleted
  at the non-periodic global edges: every rank's state bitwise, the
  same overflow count;
* the electrostatic field set-up (``electrostatic_init``, a global
  cumulative sum over the ranks) at N = 4: within 1e-12 of each field's
  scale;
* the replicated mode's migration of a packed species
  (``wrap_kill_packed``) against opal_tpu's ``_wrap_kill``: bitwise;
* the density-balanced split (``balanced_counts``, ``load_imbalance``):
  equal.

A world of 1 runs twice: as a group of one rank (the shift a local
copy) and in the test process without a group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from opal_tpu import constants as const
from opal_tpu import fields as jfields
from opal_tpu import grid as jgrid
from opal_tpu.ops import fused as JF
from opal_tpu.parallel import halo as jhalo
from opal_tpu.parallel import migrate as JM
from opal_tpu.species import ParticleState as JState
from opal_tpu_torch import grid as tgrid
from opal_tpu_torch.convert import state_from_numpy, to_numpy
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.parallel import halo as thalo
from opal_tpu_torch.parallel import migrate as TM
from opal_tpu_torch.species import SpeciesSpec, initialize
from tests.test_torch_dist_ranks import run_ranks

pytestmark = pytest.mark.unit

DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
PERIODIC = dict(nx=64, dx=DX, xmin=0.0)
LASER = dict(nx=300, dx=DX, xmin=0.0, left_boundary="laser",
             right_boundary="absorbing")
H = jgrid.HALO


def _geom(kw, n):
    return dict(kw, n_devices=n)


def _sharded(fn, n, *args):
    """``fn`` on n virtual devices, every argument and result split on
    its leading axis."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("x"),
                                 out_specs=P("x"), check_vma=False))(*args)


# ----------------------------------------------------------------------
# halo
# ----------------------------------------------------------------------


def _halo_inputs(kw, n, seed):
    geom = GridGeometry(**_geom(kw, n))
    rng = np.random.default_rng(seed)
    E, B = rng.standard_normal((2, geom.n_ext, 3))
    J = rng.standard_normal((n, geom.n_loc + 2 * H, 3))
    rho = rng.standard_normal((n, geom.n_loc + 2 * H))
    return E, B, J, rho


def _halo_jax(kw, n, E, B, J, rho):
    jg = jgrid.GridGeometry(**_geom(kw, n))

    def dev(E, B, J, rho):
        ai = jax.lax.axis_index("x")
        Es, Bs = jhalo.exchange_fields(E, B, jg, "x", ai)
        Jf, rf = jhalo.fold_currents(J[0], rho[0], jg, "x", ai)
        return Es, Bs, Jf, rf

    return [np.asarray(a) for a in _sharded(dev, n, E, B, J, rho)]


_HALO = {}


@pytest.mark.parametrize("kind", ["periodic", "laser"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_matches_opal_tpu(n, kind, tmp_path):
    cases = {"periodic": PERIODIC, "laser": LASER}
    if n not in _HALO:
        inputs = [_halo_inputs(kw, n, seed) for seed, kw in
                  enumerate(cases.values())]
        _HALO[n] = inputs, run_ranks(
            tmp_path, n, "halo",
            geoms=[_geom(kw, n) for kw in cases.values()],
            E=[i[0] for i in inputs], B=[i[1] for i in inputs],
            J_slab=[i[2] for i in inputs], rho_slab=[i[3] for i in inputs])
    inputs, ranks = _HALO[n]
    c = list(cases).index(kind)
    want = _halo_jax(cases[kind], n, *inputs[c])
    for r, got in enumerate(ranks):
        for g, w, name in zip(got[c], want, ("E", "B", "J", "rho")):
            k = g.shape[0]
            np.testing.assert_array_equal(g, w[r * k:(r + 1) * k],
                                          err_msg=f"{name} rank {r}")
    if n == 1:
        # and without a group, in this process
        geom = GridGeometry(**_geom(cases[kind], 1))
        E, B, J, rho = (torch.from_numpy(a) for a in inputs[c])
        got = [*thalo.exchange_fields(E, B, geom),
               *thalo.fold_currents(J[0], rho[0], geom)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


# ----------------------------------------------------------------------
# migration
# ----------------------------------------------------------------------


def _jstate(cols):
    fields = {f.name: None for f in dataclasses.fields(JState)}
    fields.update({k: jnp.asarray(v) for k, v in cols.items()})
    return JState(**fields)


def _blocks(kw, n, cap, dtype, sort=True, seed=0):
    """Electrons of a uniform plasma in opal_tpu's per-device layout,
    each rank's block sorted (or not), with leavers at both ends of
    every block: six rows of cell 0 sent to cell -1, five of the last
    cell to n_loc, and on the laser grid the first interior rows of
    rank 0 sent into the laser zone and the last interior rows past the
    interior (both deleted)."""
    geom = GridGeometry(**_geom(kw, n))
    st = initialize(
        SpeciesSpec.electron(), geom, 8,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.2 * np.sign(u - 0.5) + 0.05 * nr,
        uy=lambda x, u, nr: 0.05 * nr, uz=lambda x, u, nr: 0.01 * nr,
        dt=DT, capacity_per_device=cap, seed=seed, dtype=dtype,
        device="cpu")
    cols = to_numpy(st)
    out = []
    for r in range(n):
        blk = {k: v[r * cap:(r + 1) * cap] for k, v in cols.items()}
        if sort:
            blk = to_numpy(TM.sort_state(state_from_numpy(blk, device="cpu"),
                                         geom.n_loc))
        alive, cell = blk["alive"], blk["cell"]
        g = cell + r * geom.n_loc
        left = np.flatnonzero(alive & (cell == 0)
                              & (g > geom.interior_start))[:6]
        right = np.flatnonzero(alive & (cell == geom.n_loc - 1))[-5:]
        cell[left], cell[right] = -1, geom.n_loc
        if kw is LASER:
            first = np.flatnonzero(alive & (g == geom.interior_start))[:3]
            last = np.flatnonzero(alive & (g == geom.interior_end - 1))[-3:]
            cell[first] -= 1
            cell[last] += 1
        out.append(blk)
    return {k: np.concatenate([b[k] for b in out]) for k in cols}


def _flat_packed(ps):
    h, aux, w = (np.asarray(a) for a in ps)
    n = w.size
    cols = {c: h[:, i].reshape(n) for i, c in enumerate(JF.H_COLS)}
    cols.update({c: aux[:, i].reshape(n) for i, c in enumerate(JF.A_COLS)})
    cols["weight"] = w.reshape(n)
    return cols


MIGRATE = [  # (name, kind, grid, dtype, cap, capacity, window, block)
    ("edges periodic", "edges", PERIODIC, np.float64, 512, 64, 128, 0),
    ("edges laser", "edges", LASER, np.float64, 2560, 64, 128, 0),
    ("packed windowed", "packed", LASER, np.float32, 2560, 64, 256, 128),
    ("packed whole-array", "packed", PERIODIC, np.float32, 512, 64, 2048,
     128),
    ("compact periodic", "compact", PERIODIC, np.float64, 512, 64, 0, 0),
    ("compact laser", "compact", LASER, np.float64, 2560, 4, 0, 0),
]
_MIGRATE = {}


def _migrate_jax(kind, kw, n, cols, capacity, window, block):
    jg = jgrid.GridGeometry(**_geom(kw, n))

    def dev(st):
        ai = jax.lax.axis_index("x")
        if kind == "edges":
            st, ovf = JM.migrate_edges(st, jg, "x", ai, capacity, window)
        elif kind == "compact":
            st, ovf = JM.migrate_compact(st, jg, "x", ai, capacity)
        else:
            ps, ovf = JM.migrate_edges_packed(
                JF.pack_fused(st, block), jg, "x", ai, capacity, window)
            return (ps.h, ps.aux, ps.weight), ovf[None]
        return st, ovf[None]

    st, ovf = _sharded(dev, n, _jstate(cols))
    if kind == "packed":
        return st, np.asarray(ovf)
    return {k: np.asarray(getattr(st, k)) for k in cols}, np.asarray(ovf)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", [c[0] for c in MIGRATE])
def test_migration_matches_opal_tpu(case, n, tmp_path):
    name, kind, kw, dtype, cap, capacity, window, block = next(
        c for c in MIGRATE if c[0] == case)
    if n not in _MIGRATE:
        inputs = [_blocks(c[2], n, c[4], c[3], sort=c[1] != "compact",
                          seed=i) for i, c in enumerate(MIGRATE)]
        _MIGRATE[n] = inputs, run_ranks(tmp_path, n, "migrate", cases=[
            (c[1], _geom(c[2], n), cols, c[5], c[6], c[7])
            for c, cols in zip(MIGRATE, inputs)])
    inputs, ranks = _MIGRATE[n]
    i = [c[0] for c in MIGRATE].index(case)
    cols = inputs[i]
    want, wovf = _migrate_jax(kind, kw, n, cols, capacity, window, block)
    if kind == "packed":
        want = _flat_packed(want)
    moved = 0
    for r, res in enumerate(ranks):
        got, ovf = res[i]
        assert ovf == int(wovf[r]), (r, ovf, wovf)
        if kind == "packed":
            got = _flat_packed((got["h"], got["aux"], got["weight"]))
        k = next(iter(got.values())).shape[0]
        for c in want:
            np.testing.assert_array_equal(got[c], want[c][r * k:(r + 1) * k],
                                          err_msg=f"{c} rank {r}")
        alive = got["weight"] > 0 if kind == "packed" else got["alive"]
        moved += int(alive.sum())
    before = int(cols["alive"].sum())
    if case == "compact laser":
        assert sum(int(w) for w in wovf) > 0  # a send capacity of 4
    else:
        assert not wovf.any()
        deleted = 6 if kw is LASER else 0
        assert moved == before - deleted


def test_deletion_tests_the_global_cell():
    """At rank 1 of a laser grid a row of local cell 2 lies well inside
    the interior: the migration's deletion keeps it (testing the local
    cell against the laser zone would delete it), and deletes a row
    whose global cell reached the absorbing zone."""
    geom = GridGeometry(**_geom(LASER, 2))
    alive = torch.tensor([True, True, True])
    cell = torch.tensor([2, geom.interior_end - geom.n_loc - 1,
                         geom.interior_end - geom.n_loc])
    np.testing.assert_array_equal(TM._deleted(alive, cell, geom, 1).numpy(),
                                  [False, False, True])
    np.testing.assert_array_equal(TM._deleted(alive, cell, geom, 0).numpy(),
                                  [True, False, False])


@pytest.mark.parametrize("kw", [PERIODIC, LASER], ids=["periodic", "laser"])
def test_wrap_kill_packed_matches_opal_tpu(kw):
    """The replicated mode's migration of a packed species
    (``wrap_kill_packed``) against opal_tpu's ``Simulation._wrap_kill``
    on a ``PackedState`` (``opal_tpu/sim.py:843-865``), with rows that
    left the grid on both sides, rows on the edge cells, and dead rows:
    every array bitwise (on a periodic grid the f32 cell wraps in place,
    on a laser grid a leaver's weight becomes 0, the layout's dead
    mark), the same alive count and overflow 0."""
    from types import SimpleNamespace

    from opal_tpu.sim import Simulation as JSim
    from opal_tpu_torch.ops.fused import PackedState as TPacked

    geom = GridGeometry(**_geom(kw, 1))
    rng = np.random.default_rng(11)
    nblk, RB = 3, 2
    h = rng.standard_normal((nblk, len(JF.H_COLS), RB, 128)).astype(
        np.float32)
    aux = rng.standard_normal((nblk, len(JF.A_COLS), RB, 128)).astype(
        np.float32)
    lo, hi = geom.interior_start, geom.interior_end
    edges = np.array([lo - 3, lo - 1, lo, lo + 1, hi - 1, hi, hi + 2, -2,
                      -1, 0, geom.n_loc - 1, geom.n_loc, geom.n_loc + 1])
    cell = rng.integers(lo - 4, hi + 4, size=(nblk, RB, 128))
    cell.reshape(-1)[:len(edges)] = edges
    h[:, 0] = cell.astype(np.float32)
    weight = np.abs(rng.standard_normal((nblk, RB, 128))).astype(np.float32)
    weight.reshape(-1)[::7] = 0.0
    tau = rng.standard_normal(nblk * RB * 128).astype(np.float32)

    want, jovf = JSim._wrap_kill(
        SimpleNamespace(geom=jgrid.GridGeometry(**_geom(kw, 1))),
        JF.PackedState(h=jnp.asarray(h), aux=jnp.asarray(aux),
                       weight=jnp.asarray(weight), tau=jnp.asarray(tau)))
    t = lambda a: torch.from_numpy(a.copy())
    got, tovf = TM.wrap_kill_packed(
        TPacked(h=t(h), aux=t(aux), weight=t(weight), tau=t(tau)), geom)
    assert int(tovf) == int(jovf) == 0
    for k in ("h", "aux", "weight", "tau"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    killed = int((weight > 0).sum() - (got.weight > 0).sum())
    assert killed == int((weight > 0).sum()
                         - (np.asarray(want.weight) > 0).sum())
    if kw is LASER:
        assert killed > 0
    else:
        assert killed == 0 and got.h[:, 0].min() >= 0


# ----------------------------------------------------------------------
# field set-up and balanced split
# ----------------------------------------------------------------------


def test_electrostatic_init_matches_opal_tpu(tmp_path):
    n = 4
    kw = _geom(LASER, n)
    geom = GridGeometry(**kw)
    rng = np.random.default_rng(7)
    E, B = rng.standard_normal((2, geom.n_ext, 3))
    J = rng.standard_normal((geom.n_ext, 3)) * 1e3
    rho = rng.standard_normal(geom.n_ext) * 1e-3
    jg = jgrid.GridGeometry(**kw)

    def dev(E, B, J, rho):
        return jfields.electrostatic_init(E, B, J, rho, jg, "x",
                                          jax.lax.axis_index("x"))

    want = [np.asarray(a) for a in _sharded(dev, n, E, B, J, rho)]
    ranks = run_ranks(tmp_path, n, "es_init", geom_kw=kw, E=E, B=B, J=J,
                      rho=rho)
    for i, name in enumerate(("E", "B")):
        got = np.concatenate([r[i] for r in ranks])
        np.testing.assert_allclose(got, want[i], rtol=0,
                                   atol=1e-12 * np.abs(want[i]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_balanced_split_matches_opal_tpu(n):
    ne = lambda x: np.where((x > 2e3) & (x < 2e4), 1e25, 1e23)
    counts = tgrid.balanced_counts(300, 0.0, DX, n, ne)
    np.testing.assert_array_equal(
        counts, jgrid.balanced_counts(300, 0.0, DX, n, ne))
    assert counts.sum() == 300
    kw = _geom(LASER, n)
    assert tgrid.load_imbalance(GridGeometry(**kw), ne) == \
        jgrid.load_imbalance(jgrid.GridGeometry(**kw), ne)
