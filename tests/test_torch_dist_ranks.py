"""Ranks of the port on ``gloo`` process groups, for the multi-rank tests.

The tests of ``opal_tpu_torch`` on several ranks start the ranks as
processes (``opal_tpu_torch.parallel.dist.launch``) that join a
``gloo`` group through a ``file://`` rendezvous in a temporary
directory of their own, so that concurrent test workers never share a
port.  Each rank runs one of the jobs below and writes what it returns
to a pickle in the test's ``tmp_path``; :func:`run_ranks` starts them, waits
with a timeout of its own (a hang fails the test instead of eating the
suite's limit) and returns the results by rank.

This module imports torch and the port only, so that the ranks start
without JAX.  Its own tests hold the ring's collectives themselves.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from opal_tpu_torch.parallel import dist

pytestmark = pytest.mark.unit


def run_ranks(tmp_path: Path, world: int, job: str, timeout=240, **kwargs):
    """Run ``JOBS[job](ring, **kwargs)`` on ``world`` gloo ranks; returns
    the list of their results by rank.  Fails when a rank fails or the
    ranks outlast ``timeout`` seconds."""
    tmp_path = Path(tmp_path)
    run = tmp_path / f"ranks_{job}_{world}_{len(list(tmp_path.iterdir()))}"
    run.mkdir()
    # one thread a rank: the test workers already share the cores
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        codes = dist.launch(_rank_job, world, (str(run), job, kwargs),
                            timeout=timeout)
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    errors = sorted(run.glob("error_*.txt"))
    assert codes == [0] * world, (codes, [e.read_text() for e in errors])
    return [pickle.loads((run / f"result_{r}.pkl").read_bytes())
            for r in range(world)]


def _rank_job(rank: int, world: int, init_method: str, run: str, job: str,
              kwargs):
    run = Path(run)
    ring = dist.init(rank, world, init_method, "cpu")
    try:
        result = JOBS[job](ring, **kwargs)
        (run / f"result_{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (run / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        dist.close(ring)


def _np(obj):
    """Host numpy copies of tensors, states and containers of them."""
    from opal_tpu_torch.convert import to_numpy

    return to_numpy(obj)


# ----------------------------------------------------------------------
# jobs: each takes the rank's ring and returns picklable results
# ----------------------------------------------------------------------


def job_ring(ring):
    """The collectives themselves: the shift of tagged rows both ways,
    the sum and the gather, with distinct shapes each way."""
    r = ring.rank
    to_right = torch.full((3, 2), 10.0 * r + 1.0, dtype=torch.float64)
    to_left = torch.full((3, 2), 10.0 * r + 2.0, dtype=torch.float64)
    from_left, from_right = ring.shift(to_right, to_left)
    return dict(
        from_left=_np(from_left), from_right=_np(from_right),
        psum=_np(ring.psum(torch.tensor([r, 1], dtype=torch.int64))),
        gather=_np(ring.all_gather(torch.tensor([r, 2 * r]))),
        gather_bool=_np(ring.all_gather(torch.tensor([r % 2 == 0]))),
    )


def job_halo(ring, geoms, E, B, J_slab, rho_slab):
    """``exchange_fields`` and ``fold_currents`` on the rank's slab of
    global arrays, for each geometry of ``geoms`` (GridGeometry
    keyword dicts)."""
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.parallel import halo

    out = []
    for kw, e, b, j, rho in zip(geoms, E, B, J_slab, rho_slab):
        geom = GridGeometry(**kw)
        n, r = geom.n_loc, ring.rank
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        Es, Bs = halo.exchange_fields(t(e[r * n:(r + 1) * n]),
                                      t(b[r * n:(r + 1) * n]), geom, ring)
        Jf, rf = halo.fold_currents(t(j[r]), t(rho[r]), geom, ring)
        out.append(_np((Es, Bs, Jf, rf)))
    return out


def job_migrate(ring, cases):
    """One migration call a case on the rank's block of a global state:
    ``(kind, geometry keywords, columns, capacity, window, block)``,
    kind ``edges``, ``packed`` or ``compact``.  Returns (columns,
    overflow) a case."""
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.ops import fused as F
    from opal_tpu_torch.parallel import migrate as M
    from opal_tpu_torch.species import rank_rows

    out = []
    for kind, kw, cols, cap, window, block in cases:
        geom = GridGeometry(**kw)
        n = cols["alive"].shape[0] // ring.world
        st = rank_rows(state_from_numpy(cols, device="cpu"), ring.rank, n)
        if kind == "edges":
            st, ovf = M.migrate_edges(st, geom, cap, window, ring)
        elif kind == "compact":
            st, ovf = M.migrate_compact(st, geom, cap, ring)
        else:
            ps, ovf = M.migrate_edges_packed(F.pack_fused(st, block), geom,
                                             cap, window, ring)
            out.append((_np(dataclasses.asdict(ps)), int(ovf)))
            continue
        out.append((_np(st), int(ovf)))
    return out


def job_es_init(ring, geom_kw, E, B, J, rho):
    """``fields.electrostatic_init`` on the rank's slab."""
    from opal_tpu_torch.fields import electrostatic_init
    from opal_tpu_torch.grid import GridGeometry

    geom = GridGeometry(**geom_kw)
    sl = slice(ring.rank * geom.n_loc, (ring.rank + 1) * geom.n_loc)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[sl]))
    return _np(electrostatic_init(t(E), t(B), t(J), t(rho), geom, ring))


def job_absorb(ring, cases):
    """One ``interactions.absorb`` call a case in the replicated mode, on
    the rank's block of global electron and photon columns: each case a
    dict of ``opts`` (SimOptions keywords), ``geom`` (GridGeometry
    keywords), ``e`` and ``ph`` (numpy columns), ``draws`` (one replay
    dict a rank, or None for a generator seeded by the rank), ``t`` and
    the pairing flags ``presorted`` and ``bracketed``.  Returns a case's
    (electron columns, photon columns, lost, deferred, events or None,
    the events applied by kind)."""
    from types import SimpleNamespace

    from opal_tpu_torch import interactions as I
    from opal_tpu_torch.convert import state_from_numpy
    from opal_tpu_torch.grid import GridGeometry
    from opal_tpu_torch.sim import SimOptions
    from opal_tpu_torch.species import rank_rows

    out = []
    for case in cases:
        sim = SimpleNamespace(geom=GridGeometry(**case["geom"]),
                              options=SimOptions(**case["opts"]))
        species = {
            name: rank_rows(state_from_numpy(cols, device="cpu"), ring.rank,
                            cols["alive"].shape[0] // ring.world)
            for name, cols in (("electron", case["e"]),
                               ("photon", case["ph"]))}
        rng = (case["draws"][ring.rank] if case["draws"] is not None else
               torch.Generator().manual_seed(100 + ring.rank))
        I.absorb.events.update(absorbed=0, stimulated=0)
        res = I.absorb(sim, species, case["t"], rng,
                       presorted=case.get("presorted", False),
                       bracketed=case.get("bracketed", False),
                       ring=ring, replicated=True)
        sp = res[0]
        out.append((_np(sp["electron"]), _np(sp["photon"]), int(res[1]),
                    int(res[2]), _np(res[3]) if len(res) > 3 else None,
                    dict(I.absorb.events)))
    return out


_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def job_run(ring, deck, steps, every, dtype="f64", field_dtype="f64",
            draws=None, save_at=None, resume=False, fields=False):
    """``cli.build`` of ``deck`` on the rank, then ``steps`` steps in
    ``Simulation.run`` calls of ``every``: the energies (summed over the
    ranks) after each call, the counters, the alive rows of each
    species at the end and at the start (``alive0``), the mode and the
    capacities.  ``draws`` replays QED draws: a path with a ``{rank}``
    field, of a pickle of the rank's list of per-step draw dicts.
    ``save_at`` writes a checkpoint beside the deck after that many
    calls; ``resume`` starts from the deck's checkpoint instead of the
    initial state; ``fields`` adds the final fields of the whole grid.
    With the event log on, the rank's event ring and the events applied
    by kind come back too."""
    from opal_tpu_torch import interactions as I
    from opal_tpu_torch import checkpoint, cli

    sim, species, rp = cli.build(
        Path(deck), dtype=_DTYPES[dtype], field_dtype=_DTYPES[field_dtype],
        ring=ring)
    alive0 = {n: int(ring.psum(st.alive.sum())) for n, st in species.items()}
    E, B, J, rho = sim.init_fields()
    if rp["initialise_fields"]:
        E, B, J, rho = sim.initialize_fields(E, B, J, rho, species)
    t, counters = rp["tstart"], sim.zero_counters()
    rng = None
    if sim._qed_on:
        rng = torch.Generator().manual_seed(
            checkpoint.rank_seed(sim.options.seed, ring.rank))
    if resume:
        _, t, E, B, J, rho, species, rng, counters = checkpoint.load(
            Path(deck).parent, sim)
    if draws is not None:
        draws = pickle.loads(Path(draws.format(rank=ring.rank)).read_bytes())
    curve = []
    events = sim.zero_events() if sim._event_log else None
    I.absorb.events.update(absorbed=0, stimulated=0)
    for call in range(steps // every):
        if draws is not None:
            rng = draws[call * every:(call + 1) * every].__getitem__
        E, B, J, rho, species, t, counters, *ev = sim.run(
            E, B, J, rho, species, t, counters, every, rng=rng,
            events=events)
        if ev:
            events = ev[0]
        curve.append([sim.em_field_energy(E, B)] + [
            sim.total_kinetic_energy(n, species[n]) for n in sim.specs])
        if save_at is not None and call + 1 == save_at:
            gathered = cli._gather(ring, (E, B, J, rho), species,
                                   sim.options.replicate_fields)
            gen = rng if isinstance(rng, torch.Generator) else (
                torch.Generator())
            rng_h = (checkpoint.gather_rng(gen, ring)
                     if ring.group is not None else gen)
            if ring.rank == 0:
                (E_h, B_h, J_h, rho_h), species_h = gathered
                checkpoint.save(Path(deck).parent, call + 1, t, E_h, B_h,
                                J_h, rho_h, species_h, rng_h, counters,
                                sim.geom.n_loc, ring.world,
                                sim.options.replicate_fields)
    alive = {n: int(ring.psum(st.alive.sum())) for n, st in species.items()}
    extra = {}
    if events is not None:
        extra["events"] = _np(events)
    if sim.options.photon_absorption:
        extra["applied"] = dict(I.absorb.events)
    if fields:
        gathered = cli._gather(ring, (E, B, J, rho), {},
                               sim.options.replicate_fields)
        if gathered is not None:
            extra["fields"] = gathered[0]
    return dict(**extra,
        curve=np.asarray(curve), counters={k: int(v) for k, v in
                                           counters.items()},
        alive=alive, alive0=alive0, replicated=sim.options.replicate_fields,
        capacities=rp["capacities"], t=t, n_loc=sim.geom.n_loc,
        fused=[n for n in sim.specs if sim._fused_applicable(n, species[n])],
    )


JOBS = dict(ring=job_ring, halo=job_halo, migrate=job_migrate,
            es_init=job_es_init, absorb=job_absorb, run=job_run)


# ----------------------------------------------------------------------
# the ring's own tests
# ----------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
def test_ring_collectives(world, tmp_path):
    """Each rank gets its left neighbour's right-going rows and its right
    neighbour's left-going rows (at a world of 2 both from the one other
    rank, never swapped), the sum and the gather of every rank."""
    res = run_ranks(tmp_path, world, "ring", timeout=120)
    for r, got in enumerate(res):
        left, right = (r - 1) % world, (r + 1) % world
        np.testing.assert_array_equal(got["from_left"], 10.0 * left + 1.0)
        np.testing.assert_array_equal(got["from_right"], 10.0 * right + 2.0)
        np.testing.assert_array_equal(got["psum"],
                                      [sum(range(world)), world])
        np.testing.assert_array_equal(
            got["gather"], [[q, 2 * q] for q in range(world)])
        np.testing.assert_array_equal(
            got["gather_bool"][:, 0], [q % 2 == 0 for q in range(world)])


def test_world_of_one_shifts_to_itself():
    """Without a group the ring is a world of 1: the shift hands the rows
    back (the self-send shortcut), the sum and gather are local, and a
    ring of several ranks without a group is refused."""
    ring = dist.Ring()
    a, b = torch.ones(2), torch.zeros(2)
    fl, fr = ring.shift(a, b)
    assert fl is a and fr is b
    assert ring.psum(a) is a
    assert ring.all_gather(a).shape == (1, 2)
    with pytest.raises(ValueError):
        dist.Ring(rank=1, world=2)
