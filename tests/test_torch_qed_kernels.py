"""The QED stages that run as hand CUDA kernels on the card: the
absorption walk's pass (``ops.absorb_walk.absorb_pass``), the bracketed
mode's cell envelopes (``ops.absorb_walk.cell_envelopes``) and the
emission sampler's CDF inversion (``qed.pwmci.invert_many``).  On the
CPU each wrapper runs its plain version, which is held here against an
independent reference; the ``cuda`` cases hold each kernel against its
plain version on the card and skip without one.

Tolerances, and why:

* ``absorb_pass_reference`` against a sequential per-photon numpy scan
  of the same pass (opal_tpu's cross sections, the reference's scan
  order), at f64, with the per-cell table and the transient segment
  rows (bracketed or not), stimulated emission on and off: equal first
  columns; sums and probabilities within 1e-12 of their scale (two
  libraries' ``pow``/``exp`` may differ in the last bit).
* ``cell_envelopes_reference`` against opal_tpu's ``_blocked_cummax`` and
  ``_suffix_min``: equal (integers).
* ``invert_many`` on the problems of both stacked calls of
  ``emission.sample`` against opal_tpu's ``pwmci.invert`` of each: f64
  within 1e-12 of the table's span, f32 within 1e-5 of it (XLA contracts
  multiply-adds on the CPU and PyTorch does not, so a halving may turn
  the other way near the root); ``in_range`` equal.
* ``airy.COEFFICIENTS`` read as the kernel reads it reproduces
  ``airy_ai`` within 1e-12 relative at f64 (numpy's ``exp``/``log``
  against PyTorch's: an ulp of the exponent's ~236 moves the result by
  ~5e-14).
* on the card, kernel against plain: K2 and K3 bitwise; K1 equal first
  columns, sums and probabilities within 1e-12 of their scale at f64
  and 1e-5 at f32 (the kernel sums in f64 in candidate order, the
  card's ``cumsum`` in f32 as a tree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import interactions as JI
from opal_tpu.qed import cross_sections as jcs
from opal_tpu.qed import emission as JE
from opal_tpu.qed import pwmci as JP
from opal_tpu_torch.ops import absorb_walk as AW
from opal_tpu_torch.qed import airy as tairy
from opal_tpu_torch.qed import emission as TE
from opal_tpu_torch.qed import pwmci as TP

pytestmark = pytest.mark.unit

B, NB = 8, 3
CDT_DX = 0.95


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# ---------------------------------------------------------------------
# K1: one pass of the absorption walk
# ---------------------------------------------------------------------

def _pass_inputs(source, seed=7, n_cells=6, nw=48):
    """Photons and candidates of one walk at f64: electrons 1..12 a cell
    (counter-propagating, gamma 5-50, chi 0.5-3, weights 1e10-2e10),
    photons in random cells with k0 0.05-3 and chi 0.1-1.5, a sixth of
    them done and a sixth with a negative depth; the other depths a
    random share of their pairs' summed probabilities, so that events
    fire at every column and some photons walk the pass without one.
    ``source``: ``table`` (the per-cell table, CC 7, empty slots not
    ok), ``segment`` (sorted rows, K bound at 2 passes + 3) or
    ``bracketed`` (adjacent cells' rows swapped, the cell column on)."""
    rng = np.random.default_rng(seed)
    per = rng.integers(1, 13, n_cells)
    cells = np.repeat(np.arange(n_cells), per)
    n_e = cells.size
    g = rng.uniform(5.0, 50.0, n_e)
    ang = rng.normal(0, 0.3, (2, n_e))
    pm = np.sqrt(g**2 - 1)
    e = np.stack([g, -pm * np.cos(ang[0]),
                  pm * np.sin(ang[0]) * np.cos(ang[1]),
                  pm * np.sin(ang[0]) * np.sin(ang[1]),
                  rng.uniform(0.5, 3.0, n_e), rng.uniform(1e10, 2e10, n_e),
                  cells.astype(np.float64)], axis=1)
    start = np.concatenate([[0], np.cumsum(per)[:-1]])
    end = start + per
    if source == "bracketed":
        for i in np.nonzero(cells[1:] != cells[:-1])[0]:
            e[[i, i + 1]] = e[[i + 1, i]]
        # the envelopes' brackets: a row of the neighbour cell inside
        start = np.maximum(start - 1, 0)
        end = np.minimum(end + 1, n_e)
    pc = rng.integers(0, n_cells, nw)
    k0 = 10 ** rng.uniform(-1.3, 0.5, nw)
    th = rng.normal(0, 0.3, nw)
    k4 = np.stack([k0, -k0 * np.cos(th), k0 * np.sin(th), 0 * k0], axis=1)
    chi = rng.uniform(0.1, 1.5, nw)
    args = dict(k4=k4, chi=chi, cell=pc.astype(np.int64),
                done=rng.random(nw) < 1 / 6)
    if source == "table":
        cand = np.zeros((n_cells, NB * B, 7))
        for c in range(n_cells):
            m = min(per[c], NB * B)
            cand[c, :m, :6] = e[start[c]:start[c] + m, :6]
            cand[c, :m, 6] = 1.0
        args["cand"] = cand
    else:
        args.update(e_table=e if source == "bracketed" else e[:, :6],
                    start=start[pc].astype(np.int64),
                    end=end[pc].astype(np.int64), K=2 * B + 3,
                    bracketed=source == "bracketed")
    return args


def _sigmas(k4, p4, chi_g, chi_e, stimulated):
    """opal_tpu's scaled cross sections of (photon, candidate) pairs."""
    k, p = jnp.asarray(k4), jnp.asarray(p4)
    cg, ce = jnp.asarray(chi_g), jnp.asarray(chi_e)
    if stimulated:
        sa, ss = jcs.pair_cross_sections(k, p, cg, ce)
    else:
        sa, _ = jcs.photon_absorption(k, p, cg, ce)
        ss = jnp.zeros_like(sa)
    return np.asarray(sa), np.asarray(ss)


def _scan(a, bi, tau_abs, tau_st, stimulated):
    """The pass as the reference runs it: each photon walks its B
    candidates in order, adding w_e c dt/dx sigma to two running sums;
    its event is the first column where either depth goes negative, and
    the sums and probabilities are taken there (at the last column
    without one).  The walk goes on to find the other depth's first
    crossing too, as the plain version reports both.  Returns (k_abs,
    k_st, s_abs, s_st, p_abs, p_st) as arrays."""
    nw = a["k4"].shape[0]
    rows = np.zeros((nw, B, 7))
    valid = np.zeros((nw, B), bool)
    for i in range(nw):
        for j in range(B):
            col = bi * B + j
            if "cand" in a:
                row = a["cand"][a["cell"][i], col]
                ok = row[6] > 0.5
            else:
                r = a["start"][i] + col
                et = a["e_table"]
                row = np.pad(et[min(max(r, 0), len(et) - 1)],
                             (0, 7 - et.shape[1]))
                ok = r < a["end"][i] and col < a["K"]
                if a["bracketed"]:
                    ok = ok and row[6] == a["cell"][i]
            rows[i, j], valid[i, j] = row, ok and not a["done"][i]
    sa, ss = _sigmas(np.repeat(a["k4"][:, None], B, 1), rows[..., :4],
                     np.repeat(a["chi"][:, None], B, 1), rows[..., 4],
                     stimulated)
    out = [np.full(nw, B), np.full(nw, B)] + [np.zeros(nw) for _ in range(4)]
    for i in range(nw):
        acc, got = [0.0, 0.0], False
        for j in range(B):
            p = [rows[i, j, 5] * CDT_DX * s[i, j] if valid[i, j] else 0.0
                 for s in (sa, ss)]
            acc = [acc[0] + p[0], acc[1] + p[1]]
            fire = [valid[i, j] and tau[i] - s < 0
                    for tau, s in ((tau_abs, acc[0]), (tau_st, acc[1]))]
            for f in (0, 1):
                if fire[f] and out[f][i] == B:
                    out[f][i] = j
            if not got and (any(fire) or j == B - 1):
                got = True
                out[2][i], out[3][i], out[4][i], out[5][i] = *acc, *p
    return out


def _depths(a, stimulated, seed=3):
    """Depths that cross inside the walk: a random share (0-1.6) of the
    photon's summed pair probabilities over every pass; a sixth
    negative (they fire on their first valid candidate), stimulated
    depths of photons without a stimulated pair at 1e30."""
    rng = np.random.default_rng(seed)
    tot = np.zeros((2, a["k4"].shape[0]))
    for bi in range(NB):
        inf = np.full(a["k4"].shape[0], np.inf)
        *_, s_abs, s_st, _, _ = _scan(a, bi, inf, inf, stimulated)
        tot += np.stack([s_abs, s_st])
    share = rng.uniform(0.0, 1.6, tot.shape)
    tau = share * tot
    tau[1] = np.where(tot[1] > 0, tau[1], 1e30)
    tau[0, rng.random(tau.shape[1]) < 1 / 6] = -1e-30
    return tau


def _torch_args(a, dtype=torch.float64, device="cpu"):
    return {k: (torch.as_tensor(v, device=device).to(dtype)
                if isinstance(v, np.ndarray) and v.dtype == np.float64
                else torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v)
            for k, v in a.items()}


def _pass(fn, a, tau, bi, stimulated, dtype=torch.float64, device="cpu"):
    t = _torch_args(a, dtype, device)
    src = {k: t[k] for k in ("cand", "e_table", "start", "end", "K",
                             "bracketed") if k in t}
    taus = [torch.as_tensor(v, device=device).to(dtype) for v in tau]
    return fn(t["k4"], t["chi"], *taus, t["done"], t["cell"], bi, B, CDT_DX,
              stimulated, **src)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


SOURCES = ["table", "segment", "bracketed"]


@pytest.mark.parametrize("stimulated", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("source", SOURCES)
def test_absorb_pass_reference_matches_sequential_scan(source, stimulated):
    a = _pass_inputs(source)
    tau = _depths(a, stimulated)
    fired = 0
    for bi in range(NB):
        want = _scan(a, bi, *tau, stimulated)
        got = [v.numpy() for v in _pass(AW.absorb_pass_reference, a, tau,
                                        bi, stimulated)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            _close(g, w, 1e-12)
        fired += int((np.minimum(want[0], want[1]) < B).sum())
        # the next pass's depths, as absorb carries them
        tau = (tau[0] - want[2], tau[1] - want[3])
    assert fired > 10
    # the wrapper on CPU tensors is the plain version
    res = _pass(AW.absorb_pass, a, tau, 0, stimulated)
    ref = _pass(AW.absorb_pass_reference, a, tau, 0, stimulated)
    assert all(torch.equal(x, y) for x, y in zip(res, ref))


def _airy_from_table(x, c):
    """Ai(x) with the constants read from the flat table as the kernel
    reads them (numpy f64, the plain code's operations)."""
    nt = int(c[0])
    F, G, scale, nbr = c[1:1 + nt], c[1 + nt:1 + 2 * nt], c[1 + 2 * nt], \
        int(c[2 + 2 * nt])
    xt = np.clip(x, 0.0, 1.0)
    y = xt * xt * xt
    f = np.zeros_like(x)
    g = np.zeros_like(x)
    for k in range(nt - 1, -1, -1):
        f, g = f * y + F[k], g * y + G[k]
    value = f + xt * g
    xq = np.clip(x, 1.0, 50.0)
    sq = 2.0 * xq * np.sqrt(xq) / 3.0
    ls = np.log(sq)
    pref = scale * np.exp(-sq - ls / 6.0)
    at = 3 + 2 * nt
    for _ in range(nbr):
        x_lo, a, bma, nc = c[at:at + 4]
        coef = c[at + 4:at + 4 + int(nc)]
        at += 4 + int(nc)
        u = 2.0 * (ls - a) / bma - 1.0
        b1 = np.zeros_like(x)
        b2 = np.zeros_like(x)
        for cc in coef[:0:-1]:
            b1, b2 = 2.0 * u * b1 - b2 + cc, b1
        value = np.where(x < x_lo, value, pref * (u * b1 - b2 + coef[0]))
    assert at == len(c)
    return np.where((x >= 0) & (x < 50), value, 0.0)


def test_airy_coefficient_table_layout():
    x = np.concatenate([np.linspace(-1, 0.999, 500),
                        np.linspace(1, 60, 5000)])
    want, _ = tairy.airy_ai(torch.from_numpy(x))
    got = _airy_from_table(x, tairy.COEFFICIENTS)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-300)


# ---------------------------------------------------------------------
# K2: the cell envelopes
# ---------------------------------------------------------------------

def _cells(kind, n, seed=11):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-5, 4000, n).astype(np.int32)
    c = np.sort(rng.integers(0, 4000, n)).astype(np.int32)
    if kind == "nearly_sorted":
        i = rng.integers(0, n - 1, n // 50)
        c[i], c[i + 1] = c[i + 1].copy(), c[i].copy()
    return c


@pytest.mark.parametrize("n", [5, 70_001, 131_073])
@pytest.mark.parametrize("kind", ["random", "sorted", "nearly_sorted"])
def test_cell_envelopes_match_opal_tpu(kind, n):
    c = _cells(kind, n)
    lo, hi = AW.cell_envelopes(torch.from_numpy(c))
    cj = jnp.asarray(c)
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(JI._blocked_cummax(cj)))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(JI._suffix_min(cj)))
    assert lo.dtype == hi.dtype == torch.int32


# ---------------------------------------------------------------------
# K3: the CDF inversions of emission.sample
# ---------------------------------------------------------------------

#: the port's table stacks and opal_tpu's, by name
PREPS = ("_QUANTUM_PREP", "_Y_PREP", "_Y_INF_PREP", "_CLASSICAL_PREP")


def _sample_problems(dtype, n=2000, seed=2):
    """The problems of the two ``invert_many`` calls of one
    ``emission.sample`` (chi 1e-3.5..1e2.5, so that both the quantum
    tables and the classical fallback run)."""
    rng = np.random.default_rng(seed)
    chi = (10.0 ** rng.uniform(-3.5, 2.5, n)).astype(dtype)
    gamma = (10.0 ** rng.uniform(1, 4, n)).astype(dtype)
    r = rng.random((3, n)).astype(dtype)
    calls = []
    real = TP.invert_many

    def spy(problems):
        calls.append(problems)
        return real(problems)

    TE.pwmci.invert_many = spy
    try:
        TE.sample(*(torch.from_numpy(v) for v in (chi, gamma, *r)))
    finally:
        TE.pwmci.invert_many = real
    return calls


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_invert_many_matches_opal_tpu(dtype):
    calls = _sample_problems(dtype)
    assert [len(c) for c in calls] == [3, 3]
    jprep = {id(getattr(TE, k).x): getattr(JE, k) for k in PREPS}
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for problems in calls:
        got = TP.invert_many(problems)
        ref = TP.invert_many_reference(problems)
        for (prep, tidx, fq), (x, ok), (xr, okr) in zip(problems, got, ref):
            assert torch.equal(x, xr) and torch.equal(ok, okr)
            jp = jprep[id(prep.x)]
            xj, okj = JP.invert(jp, jnp.asarray(tidx.numpy(), jnp.int32),
                                jnp.asarray(fq.numpy()))
            np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
            t = tidx.numpy()
            span = jp.x[t, -1] - jp.x[t, 0]
            err = np.abs(x.numpy() - np.asarray(xj)) / span
            assert err.max() <= tol, err.max()


# ---------------------------------------------------------------------
# the wrappers on other devices, and the kernels on the card
# ---------------------------------------------------------------------

def test_wrappers_raise_on_meta_tensors():
    a = _pass_inputs("table")
    tau = _depths(a, True)
    with pytest.raises(ValueError, match="meta"):
        _pass(AW.absorb_pass, a, tau, 0, True, device="meta")
    with pytest.raises(ValueError, match="meta"):
        AW.cell_envelopes(torch.zeros(8, dtype=torch.int32, device="meta"))
    fq = torch.zeros(4, dtype=torch.float64, device="meta")
    tidx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TP.invert_many([(TE._QUANTUM_PREP, tidx, fq)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("stimulated", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("source", SOURCES)
def test_absorb_pass_kernel_matches_plain(source, stimulated, dtype):
    _need_cuda()
    a = _pass_inputs(source)
    tau = _depths(a, stimulated)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for bi in range(NB):
        n0 = AW.absorb_pass.launches
        got = _pass(AW.absorb_pass, a, tau, bi, stimulated, dtype, "cuda")
        assert AW.absorb_pass.launches == n0 + 1
        ref = _pass(AW.absorb_pass_reference, a, tau, bi, stimulated, dtype,
                    "cuda")
        torch.cuda.synchronize()
        assert torch.equal(got.k_abs, ref.k_abs)
        assert torch.equal(got.k_st, ref.k_st)
        for g, w in zip(got[2:], ref[2:]):
            _close(g.cpu(), w.cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 70_001, 2_621_440])
@pytest.mark.parametrize("kind", ["random", "sorted", "nearly_sorted"])
def test_cell_envelopes_kernel_matches_plain(kind, n):
    _need_cuda()
    c = torch.from_numpy(_cells(kind, n)).cuda()
    got = AW.cell_envelopes(c)
    ref = AW.cell_envelopes_reference(c)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_invert_many_kernel_matches_plain(dtype):
    _need_cuda()
    for problems in _sample_problems(dtype):
        on = [(p, t.cuda(), f.cuda()) for p, t, f in problems]
        n0 = TP.invert_many.launches
        got = TP.invert_many(on)
        assert TP.invert_many.launches == n0 + 1
        ref = TP.invert_many_reference(on)
        torch.cuda.synchronize()
        for (x, ok), (xr, okr) in zip(got, ref):
            assert torch.equal(x, xr) and torch.equal(ok, okr)
