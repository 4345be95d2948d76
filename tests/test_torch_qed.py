"""QED photon emission: opal_tpu's functions against the port's on the
same seeded numpy inputs, and the colliding-beams slice as a whole.

Tolerances, and why:

* the tables: equal.
* pwmci ``evaluate``/``invert`` (with queries below and above the
  tables): f64 within 1e-12, f32 within 1e-5 of the table's span.  The
  f64 path evaluates the same operations; at f32 XLA contracts
  multiply-adds on the CPU and PyTorch does not, and a bisection step
  that compares a rounded cubic may then turn the other way near the
  root.
* ``rate``/``classical_rate`` over chi 1e-4..1e3: f64 within 1e-14, f32
  within 1e-5 relative (the rational fit's cube root is ``pow(x, 1/3)``
  here, ``cbrt`` there).
* ``sample``/``classical_sample`` given the same r1..r3: photon energy
  f64 within 1e-13 and f32 within 1e-5 relative; the angle within 1e-9
  (f64) and 1e-3 (f32) absolute: theta ~ 1/gamma is an arccos near 1,
  where one ulp of cos(theta) moves it by sqrt(2 ulp).
* ``vay_push`` with the optical-depth decrement, ``photon_push``,
  ``photon_chi``: f64 within 1e-13 relative; the f64-compute push of f32
  state rounds to the same f32 values, within one f32 ulp (1.2e-7
  relative).
* ``insert``, both slot branches: equal.
* one ``emit_radiation`` pass with opal_tpu's draws, at f64: electron and
  photon buffers within 1e-9 relative (the angle's conditioning, above),
  the kept, deferred and lost counts equal.
* the slice: a small colliding-beams deck through both ``cli.build`` and
  ``Simulation.run`` with opal_tpu's draws replayed, at f64 (energies
  within 1e-10 relative, photon counts equal); and at ``--f32`` through
  the fused kernel (opal_tpu's in interpret mode, the port's plain
  version): energies within 1e-4 relative, photon counts within 5%:
  f32 rounding moves an electron's optical depth across zero a step
  earlier or later, which changes which draw it takes from then on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opal_tpu.cli as jcli
import opal_tpu_torch.cli as tcli
from opal_tpu import constants as const
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.interactions import emit_radiation as j_emit
from opal_tpu.ops import pusher as jpush
from opal_tpu.parallel import migrate as JM
from opal_tpu.qed import emission as JE
from opal_tpu.qed import pwmci as JP
from opal_tpu.qed import tables_data as JT
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.sim import counter_total
from opal_tpu.species import ParticleState as JState
from opal_tpu_torch.convert import state_from_numpy, to_numpy
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.interactions import emission_widths, emit_radiation
from opal_tpu_torch.ops import pusher as tpush
from opal_tpu_torch.parallel import migrate as TM
from opal_tpu_torch.qed import emission as TE
from opal_tpu_torch.qed import pwmci as TP
from opal_tpu_torch.qed import tables_data as TT
from opal_tpu_torch.sim import SimOptions

pytestmark = pytest.mark.unit

DTYPES = [pytest.param(np.float64, id="f64"), pytest.param(np.float32,
                                                           id="f32")]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol, atol_scale=0.0, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol_scale * np.abs(want).max(), err_msg=err_msg)


def test_tables_equal():
    """The port's copy of the tables is opal_tpu's."""
    names = [k for k in vars(JT) if k.isupper()]
    assert len(names) >= 15
    for k in names:
        np.testing.assert_array_equal(getattr(TT, k), getattr(JT, k),
                                      err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pwmci_evaluate_invert(dtype):
    """Both directions on the quantum CDF tables (35 tables of 31
    points), queries spread over each table and past both of its ends;
    ``in_range`` equal."""
    rng = np.random.default_rng(0)
    prep = JE._QUANTUM_PREP
    T, n = prep.x.shape
    tidx = rng.integers(0, T, 3000)
    lo_x, hi_x = prep.x[tidx, 0], prep.x[tidx, -1]
    xq = (lo_x + (hi_x - lo_x) * rng.uniform(-0.1, 1.1, tidx.size)).astype(dtype)
    lo_f, hi_f = prep.f[tidx, 0], prep.f[tidx, -1]
    fq = (lo_f + (hi_f - lo_f) * rng.uniform(-0.1, 1.1, tidx.size)).astype(dtype)
    assert (xq > hi_x).any() and (fq < lo_f).any()
    tol = 1e-12 if dtype == np.float64 else 1e-5
    tprep = TE._QUANTUM_PREP
    for jfn, tfn, q, span in ((JP.evaluate, TP.evaluate, xq, hi_f - lo_f),
                              (JP.invert, TP.invert, fq, hi_x - lo_x)):
        vj, okj = jfn(prep, jnp.asarray(tidx, jnp.int32), jnp.asarray(q))
        vt, okt = tfn(tprep, _t(tidx), _t(q))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        vj = np.asarray(vj)
        assert vt.dtype == torch.from_numpy(q).dtype
        err = np.abs(vt.numpy() - vj) / span
        assert err.max() <= tol, (jfn.__name__, err.max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_rates(dtype):
    rng = np.random.default_rng(1)
    chi = (10.0 ** rng.uniform(-4, 3, 4000)).astype(dtype)
    chi[:4] = (1e-4, 0.01, 100.0, 1e3)
    gamma = (10.0 ** rng.uniform(0.5, 4, 4000)).astype(dtype)
    tol = 1e-14 if dtype == np.float64 else 1e-5
    for jfn, tfn in ((JE.rate, TE.rate),
                     (JE.classical_rate, TE.classical_rate)):
        want = np.asarray(jfn(jnp.asarray(chi), jnp.asarray(gamma)))
        got = tfn(_t(chi), _t(gamma))
        assert got.dtype == torch.from_numpy(chi).dtype
        _close(got.numpy(), want, rtol=tol, err_msg=jfn.__name__)


@pytest.mark.parametrize("dtype", DTYPES)
def test_samplers(dtype):
    """The quantum sampler (with the classical fallback below chi 0.01)
    and the classical one, on the same r1..r3."""
    rng = np.random.default_rng(2)
    n = 3000
    chi = (10.0 ** rng.uniform(-3.5, 2.5, n)).astype(dtype)
    gamma = (10.0 ** rng.uniform(1, 4, n)).astype(dtype)
    r = rng.random((3, n)).astype(dtype)
    f64 = dtype == np.float64
    for jfn, tfn in ((JE.sample, TE.sample),
                     (JE.classical_sample, TE.classical_sample)):
        want = [np.asarray(a) for a in
                jfn(*(jnp.asarray(a) for a in (chi, gamma, *r)))]
        got = [a.numpy() for a in tfn(*(_t(a) for a in (chi, gamma, *r)))]
        name = jfn.__name__
        _close(got[0], want[0], rtol=1e-13 if f64 else 1e-5, err_msg=name)
        np.testing.assert_allclose(got[1], want[1], rtol=0,
                                   atol=1e-9 if f64 else 1e-3, err_msg=name)
        _close(got[2], want[2], rtol=1e-15 if f64 else 1e-7, err_msg=name)
        assert np.isfinite(got[0]).all() and (got[0] > 0).all()


def _push_inputs(dtype, n=500, seed=3):
    """Electrons of gamma ~ 1e3 with spread momenta in laser-strength
    fields, with optical depths that some of the rows cross."""
    rng = np.random.default_rng(seed)
    u = np.stack([-1000.0 * (1 + 0.1 * rng.normal(size=n)),
                  rng.normal(0, 30, n), rng.normal(0, 30, n)], axis=1)
    return dict(
        cell=rng.integers(0, 50, n).astype(np.int32),
        x=rng.random(n).astype(dtype), y=rng.normal(0, 1e-7, n).astype(dtype),
        z=rng.normal(0, 1e-7, n).astype(dtype), u=u.astype(dtype),
        gamma=np.sqrt(1 + (u ** 2).sum(1)).astype(dtype),
        tau=rng.exponential(0.02, n).astype(dtype),
        work=rng.normal(0, 1e-13, n),
        E=rng.normal(0, 3e13, (n, 3)), B=rng.normal(0, 1e5, (n, 3)),
    )


@pytest.mark.parametrize("case", ["quantum", "classical", "f64_compute"])
def test_vay_push_tau(case):
    """The optical-depth decrement inside the push, against the quantum
    and the classical rate, and the f64-compute push of f32 state (the
    work column stays f64, the state and tau round to f32)."""
    f32 = case == "f64_compute"
    d = _push_inputs(np.float32 if f32 else np.float64)
    EB = {k: d[k].astype(np.float32 if f32 else np.float64) for k in "EB"}
    dx, dt = 1e-8, 0.95e-8 / const.SPEED_OF_LIGHT
    kw = dict(classical_rates=case == "classical")
    jkw = dict(kw, compute_dtype=jnp.float64 if f32 else None)
    tkw = dict(kw, compute_dtype=torch.float64 if f32 else None)
    args = ("cell", "x", "y", "z", "u", "gamma", "tau", "work")
    rj = jpush.vay_push(*(jnp.asarray(d[k]) for k in args),
                        jnp.asarray(EB["E"]), jnp.asarray(EB["B"]), dx, dt,
                        **jkw)
    rt = tpush.vay_push(*(_t(d[k]) for k in args), _t(EB["E"]), _t(EB["B"]),
                        dx, dt, **tkw)
    tau0 = d["tau"]
    assert (np.asarray(rj.tau) < 0).any() and (np.asarray(rj.tau) < tau0).all()
    for name in rj._fields:
        want, got = np.asarray(getattr(rj, name)), getattr(rt, name).numpy()
        assert got.dtype == want.dtype, name
        if name == "cell":
            np.testing.assert_array_equal(got, want)
        elif f32 and name != "work":
            # both round the same f64 values: one f32 ulp at most
            _close(got, want, rtol=1.2e-7, err_msg=name)
        else:
            _close(got, want, rtol=1e-13, atol_scale=1e-15, err_msg=name)


def test_photon_push_and_chi():
    """Alive photons of spread directions: position, cell and chi."""
    rng = np.random.default_rng(4)
    n = 400
    k = rng.normal(0, 50, (n, 3))
    cell = rng.integers(0, 50, n).astype(np.int32)
    x, y, z = rng.random(n), rng.normal(0, 1e-7, n), rng.normal(0, 1e-7, n)
    E, B = rng.normal(0, 3e13, (n, 3)), rng.normal(0, 1e5, (n, 3))
    dx, dt = 1e-8, 0.95e-8 / const.SPEED_OF_LIGHT
    rj = jpush.photon_push(*map(jnp.asarray, (cell, x, y, z, k, E, B)), dx, dt)
    rt = tpush.photon_push(*map(_t, (cell, x, y, z, k, E, B)), dx, dt)
    np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
    assert (rt[0].numpy() != cell).any()
    for got, want in zip(rt[1:], rj[1:]):
        _close(got.numpy(), want, rtol=1e-13, atol_scale=1e-15)
    chi_t = tpush.photon_chi(_t(k), _t(E), _t(B)).numpy()
    _close(chi_t, jpush.photon_chi(*map(jnp.asarray, (k, E, B))), rtol=1e-13)
    assert rt[-1] is None or True
    none = tpush.photon_push(*map(_t, (cell, x, y, z, k)), None, None, dx, dt)
    assert none[-1] is None


def _photon_cols(n, alive_rows, dtype=np.float64, seed=5):
    rng = np.random.default_rng(seed)
    alive = np.zeros(n, bool)
    alive[alive_rows] = True
    cols = dict(
        cell=np.where(alive, rng.integers(0, 50, n), 0).astype(np.int32),
        x=np.where(alive, rng.random(n), 0.0), prev_x=rng.random(n),
        y=np.zeros(n), z=np.zeros(n), weight=np.where(alive, 1e5, 0.0),
        ux=np.where(alive, rng.normal(0, 50, n), 0.0),
        uy=np.where(alive, rng.normal(0, 5, n), 0.0), uz=np.zeros(n),
        gamma=np.where(alive, rng.random(n) * 50, 0.0), chi=np.zeros(n),
        tau_abs=np.where(alive, rng.exponential(size=n), np.inf),
        tau_st=np.where(alive, rng.exponential(size=n), np.inf),
        birth_time=np.where(alive, 0.0, -np.inf), alive=alive,
        pol=np.zeros((n, 4)), basis=rng.normal(size=(n, 6)),
    )
    return {k: (v.astype(dtype) if v.dtype == np.float64 else v)
            for k, v in cols.items()}


def _jstate(cols):
    fields = {f.name: None for f in dataclasses.fields(JState)}
    fields.update({k: jnp.asarray(v) for k, v in cols.items()})
    return JState(**fields)


#: photon buffers of 128 rows: an alive prefix (the insert takes the
#: contiguous tail past the high-water mark) and rows alive up to the
#: top (it takes the first dead slots, ascending)
BUFFERS = {"tail": np.arange(12), "dead_slots": np.r_[0:5, 9:20, 80:127]}


@pytest.mark.parametrize("branch", list(BUFFERS))
def test_insert_branches(branch):
    rng = np.random.default_rng(6)
    st = _photon_cols(128, BUFFERS[branch])
    buf = _photon_cols(16, np.arange(16), seed=7)
    valid = rng.random(16) < 0.6
    valid[:2] = True
    js, jovf = JM.insert(_jstate(st), _jstate(buf), jnp.asarray(valid))
    ts, tovf = TM.insert(state_from_numpy(st, device="cpu"),
                         state_from_numpy(buf, device="cpu"),
                         _t(valid))
    assert int(tovf) == int(jovf) == 0
    got = to_numpy(ts)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), err_msg=k)
    new = np.flatnonzero(got["alive"] & ~st["alive"])
    assert len(new) == valid.sum()
    if branch == "tail":
        np.testing.assert_array_equal(new, 12 + np.arange(valid.sum()))
    else:
        assert new[0] == 5


def _jax_draws(key, m, mi, dtype):
    """opal_tpu's draws of one emission pass (interactions.py:70-281)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    ek = jax.random.split(k5, 2)
    jd = jnp.dtype(dtype)
    d = dict(r1=jax.random.uniform(k1, (m,), jd),
             r2=jax.random.uniform(k2, (m,), jd),
             r3=jax.random.uniform(k3, (m,), jd),
             tau=jax.random.exponential(k4, (m,), jd),
             tau_abs=jax.random.exponential(ek[0], (mi,), jd),
             tau_st=jax.random.exponential(ek[1], (mi,), jd))
    return {k: np.asarray(v) for k, v in d.items()}


def _electrons(n=3200, seed=8):
    """A beam of gamma ~ 1e3 along -x with 0.05 rad of spread, chi over
    1e-3..10 (the classical branch below 0.01), 3050 alive rows past
    their optical depth."""
    rng = np.random.default_rng(seed)
    alive = np.arange(n) < 3100
    ang = rng.normal(0, 0.05, (2, n))
    g = 10 ** rng.uniform(2.5, 3.5, n)
    u = np.stack([-g, g * ang[0], g * ang[1]], axis=1)
    tau = rng.uniform(0.0, 1.0, n)
    tau[rng.permutation(3100)[:3050]] = -0.1
    return dict(
        cell=rng.integers(0, 50, n).astype(np.int32), x=rng.random(n),
        prev_x=rng.random(n), y=np.zeros(n), z=np.zeros(n),
        weight=np.where(alive, 1e5, 0.0), ux=u[:, 0], uy=u[:, 1], uz=u[:, 2],
        gamma=np.sqrt(1 + (u ** 2).sum(1)),
        chi=10 ** rng.uniform(-3, 1, n), tau=np.where(alive, tau, np.inf),
        work=np.zeros(n), alive=alive,
    )


def test_emit_radiation():
    """Active and insert capacities below the emitters, so that both
    deferrals run, with the three filters, into a buffer that hands out
    its first dead slots.  (Beaming and radiation reaction off run in
    ``test_slice_f32_fused``.)  The sampler works on 3000 rows, the size
    of ``test_samplers``, whose compiled JAX operations it then reuses."""
    kw = dict(emission_active_capacity=3000, emission_insert_capacity=40,
              photon_energy_min=1.0, photon_angle_max=0.1,
              max_formation_length=1e-7)
    dx, dt = 1e-8, 0.95e-8 / const.SPEED_OF_LIGHT
    gkw = dict(nx=50, dx=dx, xmin=0.0, n_devices=1)
    e = _electrons()
    ph = _photon_cols(128, BUFFERS["dead_slots"])
    t = 1.5e-15

    class JSimLike:
        options = JOptions(dt=dt, photon_emission=True, **kw)
        geom = JGeom(**gkw)

    class TSimLike:
        options = SimOptions(dt=dt, photon_emission=True, **kw)
        geom = GridGeometry(**gkw)

    key = jax.random.key(11)
    jsp, jlost, jdef = j_emit(
        JSimLike, {"electron": _jstate(e), "photon": _jstate(ph)}, t,
        jax.random.fold_in(key, 0))
    m, mi = emission_widths(TSimLike.options, 3200)
    draws = _jax_draws(jax.random.fold_in(key, 0), m, mi, np.float64)
    tsp, tlost, tdef = emit_radiation(
        TSimLike, {"electron": state_from_numpy(e, device="cpu"),
                   "photon": state_from_numpy(ph, device="cpu")}, t, draws)
    assert int(tlost) == int(jlost) == 0
    assert int(tdef) == int(jdef)
    n_emit = int((e["alive"] & (e["tau"] < 0)).sum())
    assert int(tdef) > n_emit - 3000  # both deferrals ran
    for name in ("electron", "photon"):
        got = to_numpy(tsp[name])
        for k, v in got.items():
            want = np.asarray(getattr(jsp[name], k))
            if v.dtype == np.float64:
                fin = np.isfinite(want)
                np.testing.assert_array_equal(np.isfinite(v), fin)
                _close(v[fin], want[fin], rtol=1e-9, atol_scale=1e-12,
                       err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(v, want, err_msg=f"{name} {k}")
    kept = int(to_numpy(tsp["photon"])["alive"].sum() - ph["alive"].sum())
    assert kept == 40


# ---------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------

#: a colliding-beams deck cut to nx 400 (-1..3 um) and a 0.5 um beam of
#: 600 electrons at gamma ~ 1000, starting 0.5 um/c before the pulse's
#: peak enters at the left edge, so that the peak meets the beam near
#: step 100; the beam leaves through the laser edge after ~150 steps
MINI = """\
control:
 dx: 0.01*micro
 nx: 400
 xmin: -1*micro
 start: -1.5e-6/c
 end: -1.5e-6/c + {steps}.5 * 0.0095e-6/c
 current_deposition: false
 n_outputs: 1

qed:
 photon_emission: true
 photon_absorption: false
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
 output: [energy:(log;energy), longitude:latitude:(energy)]

laser:
 Ey: >
  (a0*m*c*omega/e)
  *sin(omega*(t-x/c))
  *exp(-ln(2.0)*(omega*(t-x/c))^2/(2.0*pi^2*ncycles^2))
 Ez: 0.0

constants:
 S: 1.0e-6
 a0: 20.0
 omega: 2*pi*c/0.8e-6
 ncycles: 4.0
 xmin: 0.2 * micro
 xmax: 0.7 * micro
{tpu}"""


def _deck(tmp_path, name, steps, tpu=""):
    path = tmp_path / name
    path.mkdir()
    (path / "deck.yaml").write_text(MINI.format(steps=steps, tpu=tpu))
    return path / "deck.yaml"


def _replay(key, nsteps, m, mi, dtype):
    """Step i's emission draws of ``opal_tpu.sim.Simulation.run(...,
    key, ..., nsteps)`` at one device: split(key, nsteps)[i], its second
    split, folded with the device index 0 (sim.py:1171-1177,1344)."""
    keys = jax.random.split(key, nsteps)

    def draws(i):
        sub = jax.random.split(keys[i])[1]
        return _jax_draws(jax.random.fold_in(sub, 0), m, mi, dtype)

    return draws


def _run_both(deck, jkw, tkw, nsteps, every):
    jsim, jsp, rp = jcli.build(deck, n_devices=1, **jkw)
    tsim, tsp, trp = tcli.build(deck, device="cpu", **tkw)
    assert trp["capacities"] == rp["capacities"]
    n_e = tsp["electron"].alive.shape[0]
    m, mi = emission_widths(tsim.options, n_e)
    dtype = np.float32 if tkw["dtype"] == torch.float32 else np.float64
    jst = (*jsim.init_fields(), jsp, rp["tstart"])
    tst = (*tsim.init_fields(), tsp, rp["tstart"])
    jc, tc = jsim.zero_counters(), tsim.zero_counters()
    rows = []
    for i in range(nsteps // every):
        key = jax.random.key(i)
        out = jsim.run(*jst, key, jc, every)
        jst, jc = out[:6], out[6]
        out = tsim.run(*tst, tc, every, rng=_replay(key, every, m, mi, dtype))
        tst, tc = out[:6], out[6]
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
    for name in tsim.specs:
        assert counter_total(jc[name]) == int(tc[name]) == 0, name
    assert counter_total(jc["qed_deferred"]) == int(tc["qed_deferred"])
    return np.asarray(rows).T, jsim, tsim


def test_slice_f64_replayed(tmp_path):
    """The deck at f64 (the unfused push) with opal_tpu's draws: field,
    electron and photon energies within 1e-10 relative after every 40
    steps, the photon counts equal, the radiated energy real."""
    deck = _deck(tmp_path, "f64", 160)
    c, jsim, tsim = _run_both(
        deck, dict(dtype=jnp.float64, field_dtype=jnp.float64),
        dict(dtype=torch.float64, field_dtype=torch.float64), 160, 40)
    assert not tsim.options.fused_pusher
    np.testing.assert_array_equal(c[7], c[3])
    assert c[3, -1] > 50 and c[6, -1] > 1e-3 * c[5, 0]
    for j, name in enumerate(("em_field", "electrons", "photons")):
        err = np.abs(c[4 + j] - c[j]) / np.abs(c[j]).max()
        assert err.max() < 1e-10, (name, err.max())


def test_slice_f32_fused(tmp_path):
    """The deck at ``--f32`` with the kernel forced to blocks of 128
    rows (both packages then run the full Vay form without the deposit:
    opal_tpu's Pallas kernel in interpret mode, the port's plain
    version), opal_tpu's draws replayed, 100 steps, with radiation
    reaction off (so classical rates and spectrum) and beaming off."""
    tpu = ("features:\n no_radiation_reaction: true\n no_beaming: true\n"
           "tpu:\n fused_block: 128\n fused_window: 16\n fused_subblocks: 1\n")
    deck = _deck(tmp_path, "f32", 100, tpu)
    c, jsim, tsim = _run_both(
        deck, dict(dtype=jnp.float32, field_dtype=jnp.float32),
        dict(dtype=torch.float32, field_dtype=torch.float32), 100, 25)
    spec = tsim._fused_spec("electron")
    assert (spec.lite, spec.dep_skip, spec.pusher) == (False, True, "vay")
    assert tsim.options.fused_pusher and jsim.options.fused_pusher
    assert not tsim.options.radiation_reaction and not tsim.options.beaming
    assert c[3, -1] > 20
    np.testing.assert_allclose(c[7], c[3], rtol=0.05)
    for j, name in enumerate(("em_field", "electrons", "photons")):
        err = np.abs(c[4 + j] - c[j]) / np.abs(c[j]).max()
        assert err.max() < 1e-4, (name, err.max())
