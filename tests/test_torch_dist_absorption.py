"""Photon absorption in the replicated-field mode on two ``gloo`` ranks
against opal_tpu's ``absorb(..., replicated=True)`` on two virtual
devices: every rank holds the whole grid and a shard of the particles,
so a photon pairs with the electrons of both ranks through a gathered
per-cell candidate table, and each kick goes back to the rank that holds
its electron.

One ``absorb`` call a case, at f64, the port's ranks replaying the
draws of opal_tpu's device of the same index (its key folded with the
index, ``opal_tpu/sim.py:1143``; the walk's passes counted over both
ranks):

* a photon whose only cell-mate sits on the other rank, with stimulated
  emission on and off and the event log on and off: the event fires,
  the kick lands on the other rank's row and nowhere else, and every
  column, count and record matches opal_tpu's within 1e-12 of its scale;
* the forced-event state of ``tests/test_torch_absorption.py`` split
  over the ranks, in the three pairing modes with the active-set
  compaction on and off: the same, with events of both kinds, cells
  truncated at the candidate bound and events past the capacity;
* momentum across the ranks (``tests/test_replicated_absorption.py``):
  the electrons of both ranks gain what the absorbed photons carried,
  within 1e-9;
* at a world of 1 (no process group) the replicated branch is bitwise
  the branch without it, in every pairing mode;
* the gathered table's memory guard raises opal_tpu's ``ValueError``,
  and an ``--f64`` colliding_beams deck that both CLIs admit to the
  replicated mode trips it in both packages (ROADMAP C14).

The whole-run slice (a mini colliding-beams deck at N = 2) is in
``tests/test_torch_dist_absorption_run.py``.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from opal_tpu import cli as jcli
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.interactions import absorb as j_absorb
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu.species import _empty_fields
from opal_tpu_torch import cli as tcli
from opal_tpu_torch import interactions as I
from opal_tpu_torch.convert import state_from_numpy, to_numpy
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.parallel.dist import Ring
from opal_tpu_torch.sim import SimOptions
from opal_tpu_torch.species import rank_rows
from tests.test_torch_absorption import (
    DT, DX, NX, _absorb_draws, _assert_close, _forced_state, _jstate)
from tests.test_torch_dist_ranks import run_ranks

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
N = 2
T0 = 2.5e-15
LOG = dict(extra_absorption_output=True,
           extra_stimulated_emission_output=True)


# ----------------------------------------------------------------------
# the cases
# ----------------------------------------------------------------------


def _cross_rank_state(stim):
    """16 rows a species, 8 a rank: one electron at row 12 (rank 1,
    its row 4) in cell 5, one photon at row 1 (rank 0) in cell 5 whose
    depth crosses on its first candidate, of the kind asked for."""
    n = 16
    e = _empty_fields(JSpec.electron(), n, np.float64)
    e["cell"][12], e["alive"][12], e["weight"][12] = 5, True, 2.0e10
    e["x"][12], e["gamma"][:], e["chi"][:] = 0.3, 1.0, 1.0
    ph = _empty_fields(JSpec.photon(), n, np.float64)
    ph["cell"][1], ph["alive"][1], ph["weight"][1] = 5, True, 1.0e10
    ph["x"][1], ph["prev_x"][1] = 0.02, 0.02
    ph["ux"][1], ph["gamma"][:], ph["chi"][:] = 0.1, 0.1, 2.0
    ph["pol"][1], ph["basis"][1] = [1.0, 0.5, 0.0, 0.0], np.arange(6.0)
    ph["tau_abs"][:] = 1e30 if stim else -0.5
    ph["tau_st"][:] = -0.5 if stim else 1e30
    return e, ph


def _opts(**kw):
    return dict(dict(dt=DT, photon_absorption=True, replicate_fields=True,
                     current_deposition=False), **kw)


def _case(e, ph, opts, key, mode="sort"):
    """A case of the ``absorb`` rank job, with each rank's replay of
    opal_tpu's draws (device r's key is ``fold_in(key, r)``)."""
    to = SimOptions(**opts)
    nb, nw, evc = I.absorb_widths(to, len(e["x"]) // N, len(ph["x"]) // N,
                                  world=N)
    draws = [_absorb_draws(jax.random.fold_in(key, r), nb, nw, evc,
                           len(ph["x"]) // N) for r in range(N)]
    return dict(opts=opts, geom=dict(nx=NX if mode != "cross" else 32,
                                     dx=DX, xmin=0.0, n_devices=1),
                e=e, ph=ph, draws=draws, t=T0,
                presorted=mode == "presorted", bracketed=mode == "bracketed")


def _jax_absorb(case, key):
    """opal_tpu's replicated ``absorb`` of the case on N virtual
    devices: the species, and each device's lost and deferred counts,
    records and mask."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("x",))
    sim = SimpleNamespace(geom=JGeom(**case["geom"]),
                          options=JOptions(**case["opts"]), mesh=mesh)

    def dev(e, ph):
        ai = jax.lax.axis_index("x")
        res = j_absorb(sim, {"electron": e, "photon": ph}, case["t"],
                       jax.random.fold_in(key, ai),
                       presorted=case["presorted"],
                       bracketed=case["bracketed"], replicated=True)
        sp, lost, dfr = res[:3]
        ev = res[3] if len(res) > 3 else (jax.numpy.zeros((1, 14)),
                                          jax.numpy.zeros(1, bool))
        return sp["electron"], sp["photon"], lost[None], dfr[None], *ev

    f = jax.jit(jax.shard_map(dev, mesh=mesh, in_specs=P("x"),
                              out_specs=P("x"), check_vma=False))
    return f(_jstate(case["e"]), _jstate(case["ph"]))


def _assert_rank_matches(jres, ranks, log):
    """Each rank's columns, counts and records against opal_tpu's device
    of the same index.  Returns the event kinds of every rank."""
    je, jph, jlost, jdfr, jrec, jwant = jres
    kinds = []
    for r, (te, tph, lost, dfr, ev, _) in enumerate(ranks):
        assert lost == int(jlost[r]) and dfr == int(jdfr[r]), r
        for name, jst, tst in (("electron", je, te), ("photon", jph, tph)):
            n = len(tst["x"])
            for col, v in tst.items():
                j = np.asarray(getattr(jst, col))[r * n:(r + 1) * n]
                if v.dtype.kind in "bi":
                    np.testing.assert_array_equal(v, j, err_msg=f"{name}.{col}")
                else:
                    _assert_close(v, j, f"rank {r} {name}.{col}")
        if log:
            # the logged records in working order (the port's working set
            # holds the photons that can pair alone)
            n = len(jwant) // N
            rec = np.asarray(jrec)[r * n:(r + 1) * n][
                np.asarray(jwant)[r * n:(r + 1) * n]]
            np.testing.assert_array_equal(ev[0][ev[1]][:, 13], rec[:, 13])
            _assert_close(ev[0][ev[1]], rec, f"rank {r} event records")
            kinds.append(rec[:, 13])
    return np.concatenate(kinds) if kinds else None


CROSS = [(stim, log) for stim in (True, False) for log in (True, False)]
FORCED = [(mode, compact) for mode in ("sort", "presorted", "bracketed")
          for compact in (True, False)]
_RUN = {}


def _ranks():
    """The port's two ranks on every case, in one launch: the cross-rank
    cases, the forced-state cases and the momentum case."""
    if "ranks" not in _RUN:
        cases, keys = [], []
        for i, (stim, log) in enumerate(CROSS):
            e, ph = _cross_rank_state(stim)
            key = jax.random.key(10 + i)
            cases.append(_case(e, ph, _opts(stimulated_emission=stim,
                                            **(LOG if log else {})),
                               key, mode="cross"))
            keys.append(key)
        for i, (mode, compact) in enumerate(FORCED):
            e, ph = _forced_state(mode)
            key = jax.random.key(20 + i)
            opts = _opts(absorption_candidates=8, absorption_block=3,
                         absorption_event_capacity=5,
                         absorption_active_capacity=8 if compact else 0,
                         **LOG)
            cases.append(_case(e, ph, opts, key, mode=mode))
            keys.append(key)
        e, ph = _momentum_state()
        cases.append(dict(opts=_opts(stimulated_emission=False),
                          geom=dict(nx=32, dx=DX, xmin=0.0, n_devices=1),
                          e=e, ph=ph, draws=None, t=0.0))
        keys.append(None)
        _RUN["ranks"] = (cases, keys, run_ranks(
            _RUN["tmp"], N, "absorb", timeout=180, cases=cases))
    return _RUN["ranks"]


@pytest.fixture(autouse=True)
def _tmp(tmp_path_factory):
    _RUN.setdefault("tmp", tmp_path_factory.mktemp("dist_absorption"))


def _momentum_state():
    """``tests/test_replicated_absorption.py:132-``'s random pairs: 256
    electrons and photons over 32 cells, half the photons forced to be
    absorbed on their first candidate."""
    rng = np.random.default_rng(12)
    n = 256
    e = _empty_fields(JSpec.electron(), n, np.float64)
    e["cell"][:] = rng.integers(0, 32, n)
    e["weight"][:], e["gamma"][:], e["chi"][:] = 2.0e10, 1.0, 1.0
    e["alive"][:] = True
    ph = _empty_fields(JSpec.photon(), n, np.float64)
    ph["cell"][:] = rng.integers(0, 32, n)
    ph["weight"][:], ph["ux"][:], ph["gamma"][:] = 1.0e10, 0.05, 0.05
    ph["chi"][:] = 2.0
    ph["tau_abs"][:] = np.where(rng.random(n) < 0.5, -0.5, 1e30)
    ph["tau_st"][:] = 1e30
    ph["alive"][:] = True
    return e, ph


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------


@pytest.mark.parametrize("stim,log", CROSS,
                         ids=[f"{'stim' if s else 'absorbed'}-"
                              f"{'log' if l else 'no_log'}" for s, l in CROSS])
def test_forced_cross_rank_pairing(stim, log):
    """The photon on rank 0 pairs with the one electron of its cell, on
    rank 1: the event fires, the electron of rank 1 takes the kick (by
    (w_ph / w_e) k absorbed, by -k stimulated, where a copy of the photon
    with the electron's weight appears on rank 0), no other row moves,
    and both ranks match opal_tpu's devices."""
    cases, keys, ranks = _ranks()
    i = CROSS.index((stim, log))
    got = [r[i] for r in ranks]
    kinds = _assert_rank_matches(_jax_absorb(cases[i], keys[i]), got, log)
    e0 = cases[i]["e"]
    du = np.concatenate([g[0]["ux"] for g in got]) - e0["ux"]
    want = -0.1 if stim else 0.5 * 0.1
    assert du[12] == pytest.approx(want, rel=1e-12)
    assert not np.delete(du, 12).any()
    for c in ("uy", "uz"):
        assert not (np.concatenate([g[0][c] for g in got]) - e0[c]).any()
    applied = got[0][5]
    assert applied == {"absorbed": int(not stim), "stimulated": int(stim)}
    assert got[1][5] == {"absorbed": 0, "stimulated": 0}
    alive = [int(g[1]["alive"].sum()) for g in got]
    assert alive == ([2, 0] if stim else [0, 0])
    if stim:
        w = np.sort(got[0][1]["weight"][got[0][1]["alive"]])
        np.testing.assert_array_equal(w, [1.0e10, 2.0e10])
    if log:
        assert list(kinds) == [2.0 if stim else 1.0]
        # the record carries the partner's p4 and chi from rank 1
        rec = got[0][4][0][got[0][4][1]][0]
        assert rec[8] == e0["chi"][12] and rec[9] == e0["gamma"][12]


@pytest.mark.parametrize("mode,compact", FORCED,
                         ids=[f"{m}-{'compact' if c else 'whole_buffer'}"
                              for m, c in FORCED])
def test_forced_state_matches_opal_tpu(mode, compact):
    """The forced-event state split over the two ranks: equal events,
    counts, columns and records on each rank.  The compaction takes 8
    photons a rank (so some defer), the event capacity 5, and a cell of
    14 electrons passes the candidate bound of 8 over both ranks."""
    cases, keys, ranks = _ranks()
    i = len(CROSS) + FORCED.index((mode, compact))
    got = [r[i] for r in ranks]
    kinds = _assert_rank_matches(_jax_absorb(cases[i], keys[i]), got, True)
    assert (kinds == 1).sum() >= 3 and (kinds == 2).sum() >= 1
    assert sum(g[3] for g in got) > 0  # truncated, past the capacities


def test_momentum_across_ranks():
    """Random pairs over 32 cells: the electrons of both ranks gain the
    momentum that the absorbed photons of both ranks carried, and no
    photon without a cell-mate on either rank dies."""
    cases, _, ranks = _ranks()
    case, got = cases[-1], [r[-1] for r in ranks]
    e0, ph0 = case["e"], case["ph"]
    absorbed = ph0["alive"] & ~np.concatenate([g[1]["alive"] for g in got])
    assert absorbed.sum() > 10
    assert not (absorbed & ~np.isin(ph0["cell"], e0["cell"])).any()
    du = np.stack([np.concatenate([g[0][c] for g in got]) - e0[c]
                   for c in ("ux", "uy", "uz")], 1)
    dp_e = (e0["weight"][:, None] * du).sum(0)
    dp_ph = (ph0["weight"][absorbed, None] * np.stack(
        [ph0["ux"], ph0["uy"], ph0["uz"]], 1)[absorbed]).sum(0)
    np.testing.assert_allclose(dp_e, dp_ph, rtol=1e-9)
    assert sum(g[5]["absorbed"] for g in got) == absorbed.sum()


@pytest.mark.parametrize("mode", ["sort", "presorted", "bracketed"])
def test_world_of_one_is_the_plain_branch(mode):
    """At a world of 1 the replicated branch (its table of 8 columns, the
    partner's row from the table, the kicks through the routing records)
    gives bitwise the result of the branch without it, with the
    compaction on and off."""
    e, ph = _forced_state(mode)
    for compact in (8, 0):
        opt = SimOptions(dt=DT, photon_absorption=True,
                         absorption_candidates=8, absorption_block=3,
                         absorption_event_capacity=10,
                         absorption_active_capacity=compact, **LOG)
        sim = SimpleNamespace(geom=GridGeometry(nx=NX, dx=DX, xmin=0.0,
                                                n_devices=1), options=opt)
        nb, nw, evc = I.absorb_widths(opt, len(e["x"]), len(ph["x"]))
        rng = np.random.default_rng(5)
        draws = dict(abs_rot=int(rng.integers(len(ph["x"]))),
                     abs_r=rng.random((nb, nw)),
                     abs_exp=rng.exponential(size=(nb, 2, nw)),
                     abs_tau_abs=rng.exponential(size=evc),
                     abs_tau_st=rng.exponential(size=evc))
        res = []
        for replicated in (False, True):
            I.absorb.events.update(absorbed=0, stimulated=0)
            sp = {"electron": state_from_numpy(e, device="cpu"),
                  "photon": state_from_numpy(ph, device="cpu")}
            r = I.absorb(sim, sp, T0, draws, presorted=mode == "presorted",
                         bracketed=mode == "bracketed", ring=Ring(),
                         replicated=replicated)
            res.append((r, dict(I.absorb.events)))
        (plain, ev_p), (rep, ev_r) = res
        assert ev_p == ev_r and ev_p["absorbed"] >= 3, (ev_p, ev_r)
        assert int(plain[1]) == int(rep[1]) and int(plain[2]) == int(rep[2])
        (rec_p, want_p), (rec_r, want_r) = plain[3], rep[3]
        assert torch.equal(want_p, want_r)
        assert torch.equal(rec_p[want_p], rec_r[want_r])
        for name in ("electron", "photon"):
            for col, v in to_numpy(plain[0][name]).items():
                np.testing.assert_array_equal(
                    to_numpy(rep[0][name])[col], v, err_msg=f"{name}.{col}")


def test_table_guard_raises_like_opal_tpu(monkeypatch):
    """Past ``CAND_TABLE_MAX_BYTES`` the gathered table is refused with
    opal_tpu's ValueError, before any collective (so every rank raises
    alike): a guard of 1 KiB on the cross-rank state, in both packages."""
    import opal_tpu.interactions as JI

    monkeypatch.setattr(JI, "CAND_TABLE_MAX_BYTES", 1024)
    monkeypatch.setattr(I, "CAND_TABLE_MAX_BYTES", 1024)
    e, ph = _cross_rank_state(False)
    case = _case(e, ph, _opts(), jax.random.key(0), mode="cross")
    with pytest.raises(ValueError, match="lower tpu: absorption_candidates"
                       ) as jexc:
        _jax_absorb(case, jax.random.key(0))
    # a ring of two ranks whose group is never reached
    ring = Ring(rank=0, world=N, group=object())
    sim = SimpleNamespace(geom=GridGeometry(**case["geom"]),
                          options=SimOptions(**case["opts"]))
    sp = {name: rank_rows(state_from_numpy(cols, device="cpu"), 0,
                          len(cols["x"]) // N)
          for name, cols in (("electron", e), ("photon", ph))}
    with pytest.raises(ValueError) as texc:
        I.absorb(sim, sp, T0, torch.Generator(), ring=ring, replicated=True)
    assert str(texc.value) == str(jexc.value)


def test_f64_deck_admitted_by_the_cli_trips_the_guard(tmp_path):
    """ROADMAP C14, a fault of opal_tpu that the port keeps: the CLIs'
    rule counts the gathered table over the deck's nx cells in 4-byte
    entries, ``absorb`` over the grid's padded cells (a laser deck's 4
    and an absorbing edge's 200 more) in the particles' bytes.
    ``examples/colliding_beams.yaml`` with absorption and 2048
    candidates at ``--devices 2 --f64``: both CLIs build it in the
    replicated mode (the rule's 4004 cells make 262 MB, under the 268 MB
    guard), and both packages' ``absorb`` then refuse the table of 4212
    cells of f64 entries (552 MB) with the same message."""
    src = (ROOT / "examples" / "colliding_beams.yaml").read_text()
    src = src.replace("photon_absorption: false", "photon_absorption: true")
    src += "\ntpu:\n absorption_candidates: 2048\n"
    deck = tmp_path / "deck.yaml"
    deck.write_text(src)
    jsim, jsp, _ = jcli.build(deck, n_devices=N, dtype=jax.numpy.float64,
                              field_dtype=jax.numpy.float64)
    ring = Ring(rank=0, world=N, group=object())
    tsim, tsp, rp = tcli.build(deck, dtype=torch.float64,
                               field_dtype=torch.float64, ring=ring)
    assert jsim.options.replicate_fields and rp["replicated"]
    assert tsim.options.replicate_fields

    def dev(sp):
        return j_absorb(jsim, sp, 0.0, jax.random.key(0),
                        replicated=True)[1][None]

    with pytest.raises(ValueError) as jexc:
        jax.shard_map(dev, mesh=jsim.mesh, in_specs=P("x"),
                      out_specs=P("x"), check_vma=False)(jsp)
    with pytest.raises(ValueError) as texc:
        I.absorb(tsim, tsp, 0.0, torch.Generator(), ring=ring,
                 replicated=True)
    assert str(texc.value) == str(jexc.value)
    assert "n_cells=4212, K/device=1024, devices=2" in str(texc.value)
