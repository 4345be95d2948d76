"""QED photon absorption and stimulated emission: opal_tpu's functions
against the port's on the same seeded numpy inputs.

Tolerances, and why:

* ``airy_ai``, the three cross sections and the polarization functions
  at f64: rtol 1e-12.  The same operations in the same order; ``pow``
  and ``exp`` of the two libraries may differ in the last bit.
* one ``absorb`` call with opal_tpu's draws replayed, at f64, in every
  pairing mode (per-step sort, presorted, bracketed), with the active-set
  compaction on and off, stimulated emission on and off, and the
  per-cell candidate table or its transient fallback: equal event kinds,
  equal counts (lost, deferred, photons alive), the event records and
  every f64 column within 1e-12 of its scale.  The optical depths are
  differences of cumulative sums, whose order of summation may differ in
  the last bit between XLA and PyTorch.
* the walk's first-crossing cases (opal_tpu's
  ``tests/test_absorption_walk.py``): the kick's row exact, its size
  within 1e-12.
* the event ring and ``write_event_log``: byte for byte.
"""

import dataclasses
import io
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from opal_tpu import constants as jconst
from opal_tpu import polarization as jpol
from opal_tpu.diagnostics.output import write_event_log as j_write_event_log
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.interactions import absorb as j_absorb
from opal_tpu.qed import airy as jairy
from opal_tpu.qed import cross_sections as jcs
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.species import ParticleState as JState
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu.species import _empty_fields
from opal_tpu_torch import interactions as I
from opal_tpu_torch import polarization as tpol
from opal_tpu_torch.convert import state_from_numpy, to_numpy
from opal_tpu_torch.diagnostics.output import write_event_log
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.qed import airy as tairy
from opal_tpu_torch.qed import cross_sections as tcs
from opal_tpu_torch.sim import SimOptions, Simulation

pytestmark = pytest.mark.unit

T = lambda a: torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------

def _pairs(n=400, seed=3):
    """(k, p, chi_g, chi_e) over every Airy branch: photons and electrons
    at angles from co- to counter-propagating, chi from 1e-3 to 5, some
    pairs forbidden for stimulated emission (k0 >= p0 or chi_g >= chi_e)
    and some with a non-positive chi."""
    rng = np.random.default_rng(seed)
    g = 10 ** rng.uniform(0.2, 2.5, n)
    th = rng.uniform(0, math.pi, n)
    pm = np.sqrt(g**2 - 1)
    p = np.stack([g, -pm, 0 * g, 0 * g], axis=1)
    k0 = 10 ** rng.uniform(-2, 2.5, n)
    k = np.stack([k0, -k0 * np.cos(th), k0 * np.sin(th), 0 * k0], axis=1)
    chi_g = 10 ** rng.uniform(-3, 0.7, n)
    chi_e = 10 ** rng.uniform(-3, 0.7, n)
    chi_g[:8] = 0.0
    chi_e[8:12] = -0.5
    return k, p, chi_g, chi_e


def _photons_np(n=24, seed=5):
    rng = np.random.default_rng(seed)
    f = _empty_fields(JSpec.photon(), n, np.float64)
    k = rng.normal(size=(n, 3))
    f["ux"], f["uy"], f["uz"] = k.T.copy()
    f["gamma"] = np.linalg.norm(k, axis=1)
    f["pol"] = rng.normal(size=(n, 4))
    f["basis"] = rng.normal(size=(n, 6))
    f["alive"][:] = True
    return f


FUNCTIONS = ["airy_ai", "photon_absorption", "stimulated_emission",
             "pair_cross_sections", "with_polarization_along",
             "linear_polarization_along", "helicity"]


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_functions_match_opal_tpu(fn):
    """Each function at f64 on the same inputs, within rtol 1e-12; Airy
    over [-1, 60] (every branch and both invalid ends), also against
    scipy."""
    if fn == "airy_ai":
        x = np.concatenate([np.linspace(-1, 0.999, 50),
                            np.linspace(1, 60, 300)])
        jv, jok = jairy.airy_ai(jnp.asarray(x))
        tv, tok = tairy.airy_ai(T(x))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12,
                                   atol=0)
        ok = (x >= 0) & (x < 50)
        np.testing.assert_allclose(tv.numpy()[ok],
                                   scipy.special.airy(x[ok])[0], rtol=1e-11)
        return
    if fn in ("photon_absorption", "stimulated_emission",
              "pair_cross_sections"):
        args = _pairs()
        j = getattr(jcs, fn)(*(jnp.asarray(a) for a in args))
        t = getattr(tcs, fn)(*(T(a) for a in args))
        if fn == "pair_cross_sections":
            assert all(float(np.max(v)) > 0 for v in j)
        else:
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-12, atol=0)
        return
    f = _photons_np()
    js = JState(**{k: v for k, v in f.items()})
    ts = state_from_numpy(f, device="cpu")
    d = np.array([0.3, -1.0, 2.0])
    if fn == "with_polarization_along":
        jo, to = jpol.with_polarization_along(js, d), \
            tpol.with_polarization_along(ts, d)
        for c in ("pol", "basis"):
            np.testing.assert_allclose(getattr(to, c).numpy(),
                                       np.asarray(getattr(jo, c)),
                                       rtol=1e-12, atol=1e-15)
        return
    if fn == "linear_polarization_along":
        jo, to = jpol.linear_polarization_along(js, d), \
            tpol.linear_polarization_along(ts, d)
    else:
        jo, to = jpol.helicity(js), tpol.helicity(ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-12)


# ---------------------------------------------------------------------
# one absorb call
# ---------------------------------------------------------------------

NX, DX = 16, 1e-6
DT = 0.95 * DX / jconst.SPEED_OF_LIGHT


def _jstate(f):
    return JState(**{k: (None if v is None else jnp.asarray(v))
                     for k, v in f.items()})


def _forced_state(mode, seed=11):
    """Electrons and photons in a few cells of a 16-cell grid whose
    optical depths are set from the pairs' own probabilities, so that
    events of both kinds fire in every pass and many photons fire none:
    80 alive electrons of 96 rows (one cell holds 14, past the candidate
    bound of 8; two roam in the halo cells -2 and 17), 46 alive photons
    of 64 rows (some in cells without electrons, some with chi 0, which
    never pair).  ``mode`` arranges the electron rows: cell-sorted with
    the dead tail (``presorted``), sorted with neighbouring rows of
    adjacent cells swapped (``bracketed``), or shuffled (``sort``).
    Returns numpy column dicts (electrons, photons)."""
    rng = np.random.default_rng(seed)
    n_e, n_ph = 96, 64
    e = _empty_fields(JSpec.electron(), n_e, np.float64)
    cells = np.concatenate([np.full(6, 2), np.full(10, 3), np.full(8, 4),
                            np.full(14, 5), np.full(12, 6), np.full(9, 7),
                            np.full(11, 8), np.full(8, 9), [-2, 17]])
    n_a = cells.size
    g = rng.uniform(5.0, 50.0, n_a)
    ang = rng.normal(0, 0.3, (2, n_a))
    pm = np.sqrt(g**2 - 1)
    e["cell"][:n_a] = cells
    e["cell"][n_a:] = NX - 1
    e["x"][:n_a] = rng.uniform(0, 1, n_a)
    e["ux"][:n_a] = -pm * np.cos(ang[0])
    e["uy"][:n_a] = pm * np.sin(ang[0]) * np.cos(ang[1])
    e["uz"][:n_a] = pm * np.sin(ang[0]) * np.sin(ang[1])
    e["gamma"][:n_a] = g
    e["chi"][:n_a] = rng.uniform(0.5, 3.0, n_a)
    e["weight"][:n_a] = rng.uniform(1e10, 2e10, n_a)
    e["alive"][:n_a] = True

    ph = _empty_fields(JSpec.photon(), n_ph, np.float64)
    n_p = 46
    pc = rng.integers(1, 11, n_p)
    pc[:2] = [-2, 17]
    k0 = 10 ** rng.uniform(-1.3, 0.5, n_p)
    th = rng.normal(0, 0.3, n_p)
    ph["cell"][:n_p] = pc
    ph["x"][:n_p] = rng.uniform(0, 1, n_p)
    ph["prev_x"][:n_p] = ph["x"][:n_p]
    ph["y"][:n_p] = rng.normal(0, 1e-7, n_p)
    ph["ux"][:n_p] = -k0 * np.cos(th)
    ph["uy"][:n_p] = k0 * np.sin(th)
    ph["gamma"][:n_p] = k0
    chi_g = rng.uniform(0.1, 1.5, n_p)
    chi_g[5:8] = 0.0
    ph["chi"][:n_p] = chi_g
    ph["weight"][:n_p] = rng.uniform(1e10, 2e10, n_p)
    ph["birth_time"][:n_p] = -rng.uniform(0, 1e-15, n_p)
    ph["pol"][:n_p] = rng.normal(size=(n_p, 4))
    ph["basis"][:n_p] = rng.normal(size=(n_p, 6))
    ph["alive"][:n_p] = True
    # the depths: a random share of the photon's summed pair
    # probabilities over its cell (1e-30: fires on its first candidate)
    k4 = np.stack([ph["gamma"], ph["ux"], ph["uy"], ph["uz"]], 1)[:n_p]
    p4 = np.stack([e["gamma"], e["ux"], e["uy"], e["uz"]], 1)[:n_a]
    sa, ss = (np.asarray(v) for v in jcs.pair_cross_sections(
        jnp.asarray(k4[:, None]), jnp.asarray(p4[None]),
        jnp.asarray(chi_g[:, None]), jnp.asarray(e["chi"][None, :n_a])))
    same = pc[:, None] == cells[None, :]
    w = e["weight"][None, :n_a] * 0.95
    tot_a = (same * w * sa).sum(1)
    tot_s = (same * w * ss).sum(1)
    ph["tau_abs"][:n_p] = rng.uniform(0.0, 1.6, n_p) * tot_a
    ph["tau_st"][:n_p] = rng.uniform(0.0, 1.6, n_p) * tot_s
    ph["tau_abs"][8:12] = 1e-30
    ph["tau_st"][:n_p][tot_s == 0] = 1e30
    assert (tot_s > 0).sum() > 10 and (tot_a > 0).sum() > 20

    order = np.arange(n_e)
    if mode == "presorted":
        order = np.concatenate([np.argsort(cells, kind="stable"),
                                np.arange(n_a, n_e)])
    elif mode == "bracketed":
        order = np.concatenate([np.argsort(cells, kind="stable"),
                                np.arange(n_a, n_e)])
        c = cells[order[:n_a]]
        for i in np.nonzero(c[1:] != c[:-1])[0][::2]:
            order[i], order[i + 1] = order[i + 1], order[i]
    elif mode == "sort":
        order = rng.permutation(n_e)
    e = {k: (None if v is None else v[order]) for k, v in e.items()}
    return e, ph


def _absorb_draws(key, nb, nw, evc, n_ph, dtype=np.float64):
    """opal_tpu's draws of one absorb call (interactions.py:598-600, 788,
    809-811, 1054-1076) as the port's dict."""
    jd = jnp.dtype(dtype)
    ks = jax.random.split(jax.random.fold_in(key, 2_000_003), 2)
    d = dict(
        abs_rot=jax.random.randint(jax.random.fold_in(key, 3_000_017), (),
                                   0, n_ph),
        abs_r=jnp.stack([jax.random.uniform(jax.random.fold_in(key, bi),
                                            (nw,), jd) for bi in range(nb)]),
        abs_exp=jnp.stack([jax.random.exponential(
            jax.random.fold_in(key, 1000 + bi), (2, nw), jd)
            for bi in range(nb)]),
        abs_tau_abs=jax.random.exponential(ks[0], (evc,), jd),
        abs_tau_st=jax.random.exponential(ks[1], (evc,), jd),
    )
    return {k: np.asarray(v) for k, v in d.items()}


def _opts(**kw):
    base = dict(dt=DT, photon_absorption=True, absorption_candidates=8,
                absorption_block=3, absorption_event_capacity=10,
                extra_absorption_output=True,
                extra_stimulated_emission_output=True)
    base.update(kw)
    return JOptions(**base), SimOptions(**base)


def _both_absorb(mode, opts_kw, seed=0, t=2.5e-15, state=None):
    """One absorb call in both packages on the forced state: (opal_tpu's
    species, lost, deferred, (rec, want)), the port's, the port's
    options."""
    e, ph = state or _forced_state(mode)
    jo, to = _opts(**opts_kw)
    kw = dict(presorted=mode == "presorted", bracketed=mode == "bracketed")
    key = jax.random.key(seed)
    jres = j_absorb(
        SimpleNamespace(geom=JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                        options=jo),
        {"electron": _jstate(e), "photon": _jstate(ph)}, t, key, **kw)
    nb, nw, evc = I.absorb_widths(to, len(e["x"]), len(ph["x"]))
    tres = I.absorb(
        SimpleNamespace(geom=GridGeometry(nx=NX, dx=DX, xmin=0.0,
                                          n_devices=1), options=to),
        {"electron": state_from_numpy(e, device="cpu"),
         "photon": state_from_numpy(ph, device="cpu")}, t,
        _absorb_draws(key, nb, nw, evc, len(ph["x"])), **kw)
    return jres, tres


def _assert_close(a, b, what, rtol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=what)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=what)
    scale = max(np.abs(b[fin]).max(initial=0.0), 1e-300)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= rtol * scale, what


def _assert_same_result(jres, tres):
    """The counts equal, the event kinds and records, and every column of
    both species within 1e-12 of its scale."""
    (js, jl, jd, (jrec, jwant)), (ts, tl, td, (trec, twant)) = jres, tres
    assert int(tl) == int(jl) and int(td) == int(jd)
    jrec, trec = np.asarray(jrec)[np.asarray(jwant)], trec[twant].numpy()
    np.testing.assert_array_equal(trec[:, 13], jrec[:, 13])
    _assert_close(trec, jrec, "event records")
    for name in ("electron", "photon"):
        jc, tc = js[name], to_numpy(ts[name])
        for col, v in tc.items():
            j = np.asarray(getattr(jc, col))
            if v.dtype.kind in "bi":
                np.testing.assert_array_equal(v, j, err_msg=f"{name}.{col}")
            else:
                _assert_close(v, j, f"{name}.{col}")
    return jrec[:, 13]


@pytest.mark.parametrize("table", ["cell_table", "transient"])
@pytest.mark.parametrize("stim", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "whole_buffer"])
@pytest.mark.parametrize("mode", ["sort", "presorted", "bracketed"])
def test_absorb_matches_opal_tpu(mode, compact, stim, table, monkeypatch):
    """One pass on the forced state in both packages with opal_tpu's
    draws: equal events, counts and columns.  The compaction takes 16 of
    the photons that can pair (so some defer), the event capacity 10 (so
    some events defer)."""
    import opal_tpu.interactions as JI

    if table == "transient":
        monkeypatch.setattr(JI, "CAND_TABLE_MAX_BYTES", 0)
        monkeypatch.setattr(I, "CAND_TABLE_MAX_BYTES", 0)
    jres, tres = _both_absorb(mode, dict(
        absorption_active_capacity=16 if compact else 0,
        stimulated_emission=stim))
    kinds = _assert_same_result(jres, tres)
    assert (kinds == 1).sum() >= 3
    assert (kinds == 2).sum() >= (1 if stim else 0)
    assert int(tres[2]) > 0  # truncated cells, and past the capacities


# ---------------------------------------------------------------------
# the walk's semantics (opal_tpu's tests/test_absorption_walk.py and
# tests/test_interactions.py:408-520, on the port)
# ---------------------------------------------------------------------

CHI_G, CHI_E = 2.0, 1.0  # chi_g >= chi_e: stimulated emission forbidden
K0, GAMMA = 0.1, 10.0
W = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) * 1e10
W_PH = 7.0e10


def _tstate(spec, n, **over):
    f = _empty_fields(spec, n, np.float64)
    u = over.pop("u", None)
    if u is not None:
        f["ux"], f["uy"], f["uz"] = np.asarray(u, np.float64).T.copy()
    f.update(over)
    return state_from_numpy(f, device="cpu")


def _tsim(**kw):
    return SimpleNamespace(
        geom=GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1),
        options=SimOptions(dt=1.0e-15, photon_absorption=True, **kw))


def _walk_setup(tau_abs, block):
    """Six alive electrons of one cell with distinct weights, one photon
    in it: every pair has the same cross section, so the cumulative
    probability is a weight cumsum."""
    u_e = -math.sqrt(GAMMA**2 - 1)
    e = _tstate(JSpec.electron(), 8,
                cell=np.array([3] * 6 + [0, 0], np.int32),
                weight=np.concatenate([W, [0.0, 0.0]]),
                u=[[u_e, 0, 0]] * 8, gamma=np.full(8, GAMMA),
                chi=np.full(8, CHI_E), alive=np.arange(8) < 6)
    ph = _tstate(JSpec.photon(), 8,
                 cell=np.array([3] + [0] * 7, np.int32),
                 weight=np.array([W_PH] + [0] * 7), u=[[K0, 0, 0]] * 8,
                 gamma=np.full(8, K0), chi=np.full(8, CHI_G),
                 alive=np.arange(8) < 1, tau_abs=np.full(8, tau_abs),
                 tau_st=np.full(8, 1e30))
    return _tsim(absorption_block=block), e, ph


def _per_weight_prob():
    k4 = torch.tensor([K0, K0, 0.0, 0.0], dtype=torch.float64)
    p4 = torch.tensor([GAMMA, -math.sqrt(GAMMA**2 - 1), 0.0, 0.0],
                      dtype=torch.float64)
    sigma, valid = tcs.photon_absorption(k4, p4, CHI_G, CHI_E)
    assert bool(valid) and float(sigma) > 0.0
    return float(sigma) * jconst.SPEED_OF_LIGHT * 1.0e-15 / DX


@pytest.mark.parametrize("table", ["cell_table", "transient"])
@pytest.mark.parametrize("case,block", [
    ("event", 2), ("event", 3), ("event", 8), ("no_event", 2),
    ("no_event", 8)])
def test_first_crossing_wins(case, block, table, monkeypatch):
    """The event lands on the first candidate whose cumulative
    probability crosses the depth (the 4th electron, whether inside the
    first pass, across a pass boundary or in a partial tail pass) and
    only it takes the kick (w_ph / w_e) k; without an event the depth
    falls by exactly the segment's summed probability.  The transient
    gathers of the cell table's fallback give the same."""
    if table == "transient":
        monkeypatch.setattr(I, "CAND_TABLE_MAX_BYTES", 0)
    s = _per_weight_prob()
    cum = np.cumsum(W) * s
    tau0 = 0.5 * (cum[2] + cum[3]) if case == "event" else 1.5 * cum[-1]
    sim, e, ph = _walk_setup(tau0, block)
    species, lost, deferred = I.absorb(
        sim, {"electron": e, "photon": ph}, 0.0,
        torch.Generator().manual_seed(0))
    e2, ph2 = species["electron"], species["photon"]
    assert int(lost) == int(deferred) == 0
    du = (e2.ux - e.ux).numpy()
    if case == "event":
        assert int(ph2.alive.sum()) == 0
        assert list(np.nonzero(du)[0]) == [3]
        assert du[3] == pytest.approx(W_PH / W[3] * K0, rel=1e-12)
        assert float(ph2.weight[0]) == 0.0
    else:
        assert int(ph2.alive.sum()) == 1 and not du.any()
        assert float(ph2.tau_abs[0]) == pytest.approx(tau0 - cum[-1],
                                                      rel=1e-10)
    assert torch.equal(e2.uy, e.uy)


def _uniform_pairs(n_ph, cells, alive, tau_abs, tau_st, n_e=4,
                   w_e=2.0e25):
    u_e = -math.sqrt(GAMMA**2 - 1)
    e = _tstate(JSpec.electron(), n_e,
                cell=np.array([3] + [0] * (n_e - 1), np.int32),
                weight=np.array([w_e] + [0.0] * (n_e - 1)),
                u=[[u_e, 0, 0]] * n_e, gamma=np.full(n_e, GAMMA),
                chi=np.full(n_e, CHI_E), alive=np.arange(n_e) < 1)
    ph = _tstate(JSpec.photon(), n_ph, cell=np.asarray(cells, np.int32),
                 weight=np.where(alive, 1.0e10, 0.0), u=[[K0, 0, 0]] * n_ph,
                 gamma=np.full(n_ph, K0), chi=np.full(n_ph, CHI_G),
                 tau_abs=tau_abs, tau_st=tau_st, alive=alive)
    return e, ph


@pytest.mark.parametrize("case", ["event_capacity", "active_capacity",
                                  "rotation"])
def test_deferrals_delay_not_lose(case):
    """The bounded working sets defer work and count it, never lose it:
    events past ``absorption_event_capacity`` are cancelled with their
    depths restored and their electrons unkicked; with an active
    capacity covering every photon the walk equals the whole-buffer walk,
    and an undersized one walks exactly that many photons and defers the
    rest untouched; under sustained overflow the rotating scan origin
    walks every photon within a few steps."""
    g = torch.Generator().manual_seed(7)
    if case == "event_capacity":
        n = 8
        u_e = -math.sqrt(GAMMA**2 - 1)
        e = _tstate(JSpec.electron(), n,
                    cell=np.arange(n, dtype=np.int32) % 4,
                    weight=np.full(n, 1e10), u=[[u_e, 0, 0]] * n,
                    gamma=np.full(n, GAMMA), chi=np.full(n, CHI_E),
                    alive=np.ones(n, bool))
        tau0 = 1e-10 * _per_weight_prob() * 1e10
        ph = _tstate(JSpec.photon(), n, cell=np.arange(n, dtype=np.int32) % 4,
                     weight=np.full(n, W_PH), u=[[K0, 0, 0]] * n,
                     gamma=np.full(n, K0), chi=np.full(n, CHI_G),
                     alive=np.ones(n, bool), tau_abs=np.full(n, tau0),
                     tau_st=np.full(n, 1e30))
        species, lost, deferred = I.absorb(
            _tsim(absorption_event_capacity=2),
            {"electron": e, "photon": ph}, 0.0, g)
        ph2 = species["photon"]
        assert int(lost) == 0 and n - int(ph2.alive.sum()) == 2
        assert int(deferred) == n - 2
        np.testing.assert_array_equal(ph2.tau_abs[ph2.alive].numpy(), tau0)
        assert np.count_nonzero((species["electron"].ux - e.ux).numpy()) == 2
        return
    rng = np.random.default_rng(11)
    if case == "active_capacity":
        n_ph = 512
        cells = np.where(rng.random(n_ph) < 0.5, 3, 9)
        alive = rng.random(n_ph) < 0.7
        e, ph = _uniform_pairs(n_ph, cells, alive,
                               rng.exponential(size=n_ph) * 50.0,
                               np.full(n_ph, 1e30))

        def run(cap):
            return I.absorb(_tsim(stimulated_emission=False,
                                  absorption_active_capacity=cap),
                            {"electron": e, "photon": ph}, 0.0,
                            torch.Generator().manual_seed(7))

        (f_sp, f_l, f_d), (c_sp, c_l, c_d) = run(0), run(n_ph - 1)
        assert torch.equal(f_sp["photon"].alive, c_sp["photon"].alive)
        assert torch.equal(f_sp["photon"].tau_abs, c_sp["photon"].tau_abs)
        assert torch.equal(f_sp["electron"].ux, c_sp["electron"].ux)
        assert int(f_l) == int(c_l) == int(f_d) == int(c_d) == 0
        assert int((~c_sp["photon"].alive & torch.as_tensor(alive)).sum()) > 0
        t_sp, t_l, t_d = run(8)
        mates = alive & (cells == 3)
        assert int(t_l) == 0 and int(t_d) == mates.sum() - 8
        changed = ((t_sp["photon"].tau_abs != ph.tau_abs)
                   | (t_sp["photon"].alive != ph.alive)).numpy()
        assert changed.sum() == 8 and mates[changed].all()
        return
    n_ph, cap = 64, 8
    e, ph = _uniform_pairs(n_ph, np.full(n_ph, 3), np.ones(n_ph, bool),
                           np.full(n_ph, 1e6), np.full(n_ph, 1e6), n_e=2)
    sim = _tsim(stimulated_emission=False, absorption_active_capacity=cap)
    species = {"electron": e, "photon": ph}
    for _ in range(4 * (n_ph // cap)):
        species, lost, deferred = I.absorb(sim, species, 0.0, g)
        assert int(lost) == 0 and int(deferred) == n_ph - cap
    assert bool((species["photon"].tau_abs < 1e6).all())


# ---------------------------------------------------------------------
# the event ring and its writer
# ---------------------------------------------------------------------

@pytest.mark.parametrize("fill", ["partial", "overflow"])
def test_event_ring_and_writer_match_opal_tpu(fill):
    """Records appended step by step through the port's ring (opal_tpu's
    rank arithmetic, sim.py:1148-1160) land where opal_tpu's formula puts
    them, and both writers print the drained ring byte for byte: the
    reference's 14-column lines, only the kinds asked for, and past the
    capacity the counted overflow line."""
    rng = np.random.default_rng(2)
    cap = 8
    to = SimOptions(dt=DT, photon_absorption=True,
                    extra_absorption_output=True,
                    extra_stimulated_emission_output=fill == "overflow",
                    event_log_capacity=cap)
    ring = (torch.zeros((cap, 14), dtype=torch.float64),
            torch.zeros((), dtype=torch.int64))
    ref_ring, ref_count = np.zeros((cap, 14)), 0
    for step in range(4 if fill == "overflow" else 2):
        rec = rng.normal(size=(6, 14)) * 10.0 ** rng.integers(-20, 5, (6, 14))
        rec[:, 13] = rng.integers(1, 3, 6)
        want = rng.random(6) < 0.6
        ring = Simulation._log_events(ring, torch.as_tensor(rec),
                                      torch.as_tensor(want))
        rank = np.cumsum(want) - 1 + min(ref_count, cap)
        ok = want & (rank < cap)
        ref_ring[rank[ok]] = rec[ok]
        ref_count += int(want.sum())
    np.testing.assert_array_equal(ring[0].numpy(), ref_ring)
    assert int(ring[1]) == ref_count
    assert (ref_count > cap) == (fill == "overflow")
    jo = JOptions(dt=DT, photon_absorption=True,
                  extra_absorption_output=to.extra_absorption_output,
                  extra_stimulated_emission_output=(
                      to.extra_stimulated_emission_output))
    a, b = io.StringIO(), io.StringIO()
    nt = write_event_log(a, to_numpy(ring), to)
    nj = j_write_event_log(b, (ref_ring, np.array([ref_count])), jo)
    assert nt == nj > 0 and a.getvalue() == b.getvalue()
    assert ("event ring overflow" in a.getvalue()) == (fill == "overflow")


# ---------------------------------------------------------------------
# the slice: a mini colliding-beams crossing with absorption
# ---------------------------------------------------------------------

# the crossing of test_torch_qed's deck with absorption on: the beam's
# density (S) raised 1e12-fold so that the pairs' probabilities reach
# ~1e-3 a step and events fire (without deposition the weights move no
# field, so the dynamics is that of the shipped deck), the walk bounded
# at 8 candidates, 512 photons a step and 64 events
MINI = """\
control:
 dx: 0.01*micro
 nx: 400
 xmin: -1*micro
 start: -1.5e-6/c
 end: -1.5e-6/c + {steps}.5 * 0.0095e-6/c
 current_deposition: false
 n_outputs: {outputs}

qed:
 photon_emission: true
 photon_absorption: true
 photon_angle_max: 100 * milli

electrons:
 npc: 12
 ne: S * a0 * critical(omega) * step(x,xmin,xmax)
 ux: -1000.0 * (1.0 + 0.01 * nrand)
 uy: 0.0
 uz: 0.0
 output: [x, chi]

ions:
 npc: 0

photons:
 npc: 0
 output: [energy:(log;energy)]

laser:
 Ey: >
  (a0*m*c*omega/e)
  *sin(omega*(t-x/c))
  *exp(-ln(2.0)*(omega*(t-x/c))^2/(2.0*pi^2*ncycles^2))
 Ez: 0.0

constants:
 S: 1.0e6
 a0: 20.0
 omega: 2*pi*c/0.8e-6
 ncycles: 4.0
 xmin: 0.2 * micro
 xmax: 0.7 * micro

features:
 extra_absorption_output: true
 extra_stimulated_emission_output: true

tpu:
 absorption_candidates: 8
 absorption_active_capacity: 512
 absorption_event_capacity: 64
{tpu}"""


def _deck(tmp_path, steps, outputs=1, tpu=""):
    (tmp_path / "deck.yaml").write_text(
        MINI.format(steps=steps, outputs=outputs, tpu=tpu))
    return tmp_path / "deck.yaml"


def _step_draws(key, nsteps, em_widths, abs_widths, n_ph, dtype):
    """Step i's draws of ``opal_tpu.sim.Simulation.run(..., key, ...,
    nsteps)`` at one device (sim.py:1138-1177, 1344): split(key,
    nsteps)[i]; absorption takes its first split's second key, emission
    the second key of the first key's split, each folded with the device
    index 0."""
    from tests.test_torch_qed import _jax_draws

    keys = jax.random.split(key, nsteps)

    def draws(i):
        k_rest, sub = jax.random.split(keys[i])
        d = _absorb_draws(jax.random.fold_in(sub, 0), *abs_widths, n_ph,
                          dtype)
        sub = jax.random.split(k_rest)[1]
        d.update(_jax_draws(jax.random.fold_in(sub, 0), *em_widths, dtype))
        return d

    return draws


def test_slice_f64_replayed(tmp_path):
    """The deck at f64 (the unfused push, absorption over the per-step
    sort) through both ``cli.build`` and ``Simulation.run`` for 120 steps
    in 3 calls, with opal_tpu's emission and absorption draws replayed:
    equal photon counts, equal event rings (records within 1e-10), the
    field, electron and photon energies within 1e-10 relative, equal
    deferred counts and no loss."""
    import opal_tpu.cli as jcli
    import opal_tpu_torch.cli as tcli
    from opal_tpu.sim import counter_total
    from opal_tpu_torch.interactions import emission_widths

    deck = _deck(tmp_path, 120)
    jsim, jsp, rp = jcli.build(deck, n_devices=1, dtype=jnp.float64,
                               field_dtype=jnp.float64)
    tsim, tsp, trp = tcli.build(deck, device="cpu", dtype=torch.float64,
                                field_dtype=torch.float64)
    assert trp["capacities"] == rp["capacities"]
    to = tsim.options
    assert to.photon_absorption and to.absorption_candidates == 8
    assert (to.absorption_active_capacity, to.absorption_event_capacity) == (
        512, 64)
    n_e, n_ph = (tsp[k].alive.shape[0] for k in ("electron", "photon"))
    em_w = emission_widths(to, n_e)
    abs_w = I.absorb_widths(to, n_e, n_ph)
    jst = (*jsim.init_fields(), jsp, rp["tstart"])
    tst = (*tsim.init_fields(), tsp, rp["tstart"])
    jc, tc = jsim.zero_counters(), tsim.zero_counters()
    jev, tev = jsim.zero_events(), tsim.zero_events()
    rows = []
    for i in range(3):
        key = jax.random.key(i)
        out = jsim.run(*jst, key, jc, 40, events=jev)
        jst, jc, jev = out[:6], out[6], out[7]
        out = tsim.run(*tst, tc, 40, events=tev, rng=_step_draws(
            key, 40, em_w, abs_w, n_ph, np.float64))
        tst, tc, tev = out[:6], out[6], out[7]
        js, ts = jst[4], tst[4]
        rows.append([
            jsim.em_field_energy(jst[0], jst[1]),
            jsim.total_kinetic_energy("electron", js["electron"]),
            jsim.total_kinetic_energy("photon", js["photon"]),
            int(np.asarray(js["photon"].alive).sum()),
            tsim.em_field_energy(tst[0], tst[1]),
            tsim.total_kinetic_energy("electron", ts["electron"]),
            tsim.total_kinetic_energy("photon", ts["photon"]),
            int(ts["photon"].alive.sum()),
        ])
    c = np.asarray(rows).T
    for name in tsim.specs:
        assert counter_total(jc[name]) == int(tc[name]) == 0, name
    assert counter_total(jc["qed_deferred"]) == int(tc["qed_deferred"])
    np.testing.assert_array_equal(c[7], c[3])
    assert c[3, -1] > 50
    for j, name in enumerate(("em_field", "electrons", "photons")):
        err = np.abs(c[4 + j] - c[j]) / np.abs(c[j]).max()
        assert err.max() < 1e-10, (name, err.max())
    n_ev = int(np.asarray(jev[1])[0])
    assert int(tev[1]) == n_ev > 20
    kinds = np.asarray(jev[0])[:n_ev, 13]
    assert (kinds == 1).any() and (kinds == 2).any()
    _assert_close(tev[0][:n_ev].numpy(), np.asarray(jev[0])[:n_ev],
                  "event ring", rtol=1e-10)
