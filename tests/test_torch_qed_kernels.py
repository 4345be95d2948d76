"""The QED stages that run as hand CUDA kernels on the card: the
absorption walk (``ops.absorb_walk.absorb_walk``, its plain body one
pass, ``absorb_pass_reference``), the bracketed mode's cell envelopes
(``ops.absorb_walk.cell_envelopes``) and the emission sampler's CDF
inversion (``qed.pwmci.invert_many``).  On the CPU each wrapper runs
its plain version, which is held here against an
independent reference; the ``cuda`` cases hold each kernel against its
plain version on the card and skip without one.

Tolerances, and why:

* ``absorb_pass_reference`` against a sequential per-photon numpy scan
  of the same pass (opal_tpu's cross sections, the reference's scan
  order), at f64, with the per-cell table and the transient segment
  rows (bracketed or not), stimulated emission on and off: equal first
  columns; sums and probabilities within 1e-12 of their scale (two
  libraries' ``pow``/``exp`` may differ in the last bit).
* ``absorb_walk_reference`` against the same scan carried across the
  passes with pre-drawn draws (the event's choice and the depths as
  the reference sets them), at f64, for every source (the per-cell
  table with 7 and with 8 columns, the segment rows, bracketed or not)
  with stimulated emission on and off: equal event kinds, electrons,
  ranks and partners' columns; depths within 1e-12 of their scale.
  Against the pass-by-pass loop it replaced (``absorb_pass_reference``
  a pass, then the event choice and the depth updates), at f64, f32
  and f32 candidates with f64 depths: bitwise (the same operations).
  The walk kernel's order of work (photons in warps, slots screened a
  window at a time, valid pairs computed in chunks, each photon's scan
  per chunk) emulated in numpy against the scan: bitwise (the same
  sums in the same order).
* the walk kernel's Airy table (``airy_table``, the Chebyshev
  coefficients padded with zeros) read as the kernel reads it
  reproduces ``airy_ai`` within 1e-12 relative at f64, as the flat
  table does.
* K3's bisection by a group of lanes a query (rounds of up to five
  halvings, each node's midpoint formed along its own path) emulated
  with the plain code's operations at 1, 4 and 32 lanes: bitwise
  ``invert_many_reference`` at f32 and f64.
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
* on the card, kernel against plain: K2 and K3 bitwise (K3 also on a
  table of 100 ordinates, queries below, at and above its range, at
  every lane group); the walk (at 1, 4 and 32 photons a warp) equal
  events, electrons and partners' columns, depths within 1e-14 of each
  photon's scale at f64 and one ulp (2**-23 of it) with f32 candidates
  (the kernel sums in f64 in candidate order, the card's ``cumsum`` as
  a tree: the f64 sums differ in their last bits, the f32 ones only
  where that rounds across a tie; a kernel summing in f32 would be
  tens of ulps off).
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
# K1: the whole walk
# ---------------------------------------------------------------------

#: the walk's sources: the per-cell table with 7 columns and with the
#: replicated mode's 8 (pass bi serves rank bi // NB_LOC), the segment
#: rows, bracketed or not
WALK_SOURCES = ["table", "table8", "segment", "bracketed"]
NB_LOC = 1
#: the walk's passes of WB candidates (over the first 20 of the
#: table's, so that events fire in every pass)
WB, WNB = 4, 5


def _walk_inputs(source, seed=7, n_cells=6, nw=48):
    """:func:`_pass_inputs` for a whole walk: no photon done yet, each
    photon's first segment row (``start``) and the electrons' count
    (``n_e``) for the event's electron, every pass's draws (``r`` (WNB,
    nw) uniform, ``exp`` (WNB, 2, nw) exponential) and, for ``table8``,
    the table's candidate buffer rows (f32-exact integers)."""
    a = _pass_inputs("table" if source == "table8" else source, seed,
                     n_cells, nw)
    a["done"] = np.zeros(nw, bool)
    rng = np.random.default_rng(seed)
    per = rng.integers(1, 13, n_cells)  # _pass_inputs' first draw
    if "cand" in a:
        a["start"] = np.concatenate([[0], np.cumsum(per)[:-1]])[a["cell"]]
    a["n_e"] = int(per.sum())
    if source == "table8":
        cols = a["cand"].shape[1]
        rows = rng.permutation(1 << 20)[:n_cells * cols].astype(np.float64)
        a["cand"] = np.concatenate(
            [a["cand"], rows.reshape(n_cells, cols, 1)], axis=2)
        a["nb_loc"] = NB_LOC
    rng = np.random.default_rng(seed + 1)
    a["r"] = rng.random((WNB, nw))
    a["exp"] = rng.exponential(size=(WNB, 2, nw))
    return a


def _pairs(a, bi, stimulated):
    """Pass ``bi``'s candidate rows (nw, WB, CC), their validity and both
    probabilities ``w_e c dt/dx sigma`` (0 where invalid), with
    opal_tpu's cross sections."""
    nw = a["k4"].shape[0]
    cc = a["cand"].shape[2] if "cand" in a else 7
    rows = np.zeros((nw, WB, cc))
    valid = np.zeros((nw, WB), bool)
    for i in range(nw):
        for j in range(WB):
            col = bi * WB + j
            if "cand" in a:
                rows[i, j] = a["cand"][a["cell"][i], col]
                valid[i, j] = rows[i, j, 6] > 0.5
            else:
                r = a["start"][i] + col
                et = a["e_table"]
                rows[i, j, :et.shape[1]] = et[min(max(r, 0), len(et) - 1)]
                ok = r < a["end"][i] and col < a["K"]
                if a["bracketed"]:
                    ok = ok and rows[i, j, 6] == a["cell"][i]
                valid[i, j] = ok
    sa, ss = _sigmas(np.repeat(a["k4"][:, None], WB, 1), rows[..., :4],
                     np.repeat(a["chi"][:, None], WB, 1), rows[..., 4],
                     stimulated)
    pa = np.where(valid, rows[..., 5] * CDT_DX * sa, 0.0)
    ps = np.where(valid, rows[..., 5] * CDT_DX * ss, 0.0)
    return rows, valid, pa, ps


def _walk_scan(a, tau, stimulated):
    """The walk as the reference runs it: each photon scans its passes'
    candidates in order with two running sums a pass; at the first
    column where either depth goes negative the pass's draw chooses the
    event where both do (absorbed when r < p_abs / (p_abs + p_st)), the
    depths fall to that column (a stimulated event redraws tau_st, and
    tau_abs too where both crossed) and the walk stops; a pass without
    one takes its totals off.  Returns (tau_abs, tau_st, kind, idx,
    done, dev, we, p4chi) as arrays."""
    nw = a["k4"].shape[0]
    pairs = [_pairs(a, bi, stimulated) for bi in range(WNB)]
    ta, ts = tau[0].astype(np.float64), tau[1].astype(np.float64)
    kind, idx, dev = (np.zeros(nw, np.int64) for _ in range(3))
    we, p4chi = np.zeros(nw), np.zeros((nw, 5))
    nb_loc = a.get("nb_loc", 0)
    for i in range(nw):
        for bi in range(WNB):
            rows, valid, pa, ps = pairs[bi]
            sa = ss = 0.0
            for j in range(WB):
                sa, ss = sa + pa[i, j], ss + ps[i, j]
                fa = bool(valid[i, j] and ta[i] - sa < 0)
                fs = bool(valid[i, j] and ts[i] - ss < 0)
                if fa or fs:
                    break
            else:
                ta[i], ts[i] = ta[i] - sa, ts[i] - ss
                continue
            both = fa and fs
            absorbed = (a["r"][bi, i] < pa[i, j] / max(pa[i, j] + ps[i, j],
                                                       1e-300)
                        if both else fa)
            ta[i] = a["exp"][bi, 0, i] if both and not absorbed \
                else ta[i] - sa
            ts[i] = ts[i] - ss if absorbed else a["exp"][bi, 1, i]
            kind[i] = 1 if absorbed else 2
            row = rows[i, j]
            if nb_loc:
                idx[i], dev[i], we[i] = int(row[7]), bi // nb_loc, row[5]
                p4chi[i] = row[:5]
            else:
                idx[i] = min(max(a["start"][i] + bi * WB + j, 0),
                             a["n_e"] - 1)
            break
    return ta, ts, kind, idx, kind > 0, dev, we, p4chi


def _walk_depths(a, stimulated):
    """:func:`_depths` of the walk's photons (over the table's first 7
    columns)."""
    return _depths(dict(a, cand=a["cand"][..., :7]) if "cand" in a else a,
                   stimulated)


def _walk_by_chunks(a, tau, stimulated, photons, lanes, window):
    """:func:`_walk_scan` as the walk kernel orders it: ``photons`` a warp
    of ``lanes``; a warp screens ``window`` candidate slots (pass-major)
    of each of its photons a round, computes the round's valid pairs
    ``lanes`` at a time, photon by photon, and after each chunk each
    photon scans its own pairs in it in candidate order (a new pass
    takes the last one's sums off first) up to its event."""
    nw = a["k4"].shape[0]
    pairs = [_pairs(a, bi, stimulated) for bi in range(WNB)]
    ta, ts = tau[0].astype(np.float64), tau[1].astype(np.float64)
    kind, idx, dev = (np.zeros(nw, np.int64) for _ in range(3))
    we, p4chi = np.zeros(nw), np.zeros((nw, 5))
    nb_loc = a.get("nb_loc", 0)
    at = lambda i, s, k: pairs[s // WB][k][i, s % WB]
    n_slots = WNB * WB
    for g0 in range(0, nw, photons):
        warp = range(g0, min(g0 + photons, nw))
        tot = {i: [0.0, 0.0] for i in warp}
        end = dict.fromkeys(warp, WB)
        for w0 in range(0, n_slots, window):
            queue = [(i, s) for i in warp if not kind[i]
                     for s in range(w0, min(w0 + window, n_slots))
                     if at(i, s, 1)]
            for c0 in range(0, len(queue), lanes):
                chunk = queue[c0:c0 + lanes]
                for i, s in chunk:
                    if kind[i]:
                        continue
                    if s >= end[i]:
                        ta[i], ts[i] = ta[i] - tot[i][0], ts[i] - tot[i][1]
                        tot[i], end[i] = [0.0, 0.0], (s // WB + 1) * WB
                    pa, ps = at(i, s, 2), at(i, s, 3)
                    tot[i] = [tot[i][0] + pa, tot[i][1] + ps]
                    fa, fs = ta[i] - tot[i][0] < 0, ts[i] - tot[i][1] < 0
                    if not (fa or fs):
                        continue
                    bi, both = s // WB, fa and fs
                    absorbed = (a["r"][bi, i] < pa / max(pa + ps, 1e-300)
                                if both else fa)
                    new_a, new_s = ta[i] - tot[i][0], ts[i] - tot[i][1]
                    ta[i] = a["exp"][bi, 0, i] if both and not absorbed \
                        else new_a
                    ts[i] = new_s if absorbed else a["exp"][bi, 1, i]
                    kind[i] = 1 if absorbed else 2
                    row = pairs[bi][0][i, s % WB]
                    if nb_loc:
                        idx[i], dev[i], we[i] = (int(row[7]), bi // nb_loc,
                                                 row[5])
                        p4chi[i] = row[:5]
                    else:
                        idx[i] = min(max(a["start"][i] + s, 0),
                                     a["n_e"] - 1)
        for i in warp:
            if not kind[i]:
                ta[i], ts[i] = ta[i] - tot[i][0], ts[i] - tot[i][1]
    return ta, ts, kind, idx, kind > 0, dev, we, p4chi


def _walk(fn, a, tau, stimulated, dtype=torch.float64, tau_dtype=None,
          device="cpu"):
    """``fn`` (the walk or its plain version) on ``a``'s arrays, the
    candidates and draws in ``dtype``, the depths in ``tau_dtype``."""
    t = _torch_args(a, dtype, device)
    src = {k: t[k] for k in ("cand", "e_table", "end", "K", "bracketed")
           if k in t}
    taus = [torch.as_tensor(v, device=device).to(tau_dtype or dtype)
            for v in tau]
    nb_loc = a.get("nb_loc", 0)
    return fn(t["k4"], t["chi"], *taus, t["cell"], t["start"], t["r"],
              t["exp"], WB, CDT_DX, stimulated, a["n_e"], nb_loc=nb_loc,
              p4chi=nb_loc > 0, **src)


def _pass_loop(a, tau, stimulated, dtype, tau_dtype):
    """The walk as ``interactions.absorb`` ran it pass by pass before
    the whole-walk kernel: :func:`absorb_pass_reference` a pass, then
    the event choice, the depth updates and the event columns."""
    t = _torch_args(a, dtype)
    tau_abs, tau_st = (torch.as_tensor(v).to(tau_dtype) for v in tau)
    nw, nb_loc = len(a["k4"]), a.get("nb_loc", 0)
    tiny = 1e-37 if dtype == torch.float32 else 1e-300
    done = torch.zeros(nw, dtype=torch.bool)
    ev_kind = torch.zeros(nw, dtype=torch.int32)
    ev_idx, ev_dev = (torch.zeros(nw, dtype=torch.int64) for _ in range(2))
    ev_we, ev_p4chi = torch.zeros(nw, dtype=dtype), torch.zeros(
        (nw, 5), dtype=dtype)
    source = ({"cand": t["cand"]} if "cand" in t else
              {k: t[k] for k in ("e_table", "start", "end", "K",
                                 "bracketed")})
    for bi in range(WNB):
        res = AW.absorb_pass_reference(t["k4"], t["chi"], tau_abs, tau_st,
                                       done, t["cell"], bi, WB, CDT_DX,
                                       stimulated, **source)
        k_abs, k_st = res.k_abs, res.k_st
        k_ev = torch.minimum(k_abs, k_st)
        event = k_ev < WB
        both = event & (k_abs == k_st)
        kc = torch.clamp(k_ev, 0, WB - 1)
        pa_k, ps_k = res.p_abs, res.p_st
        r = t["r"][bi]
        choose_abs = r < pa_k / torch.clamp(pa_k + ps_k, min=tiny)
        absorbed_now = event & ((both & choose_abs) | (~both & (k_abs < k_st)))
        stim_now = event & ~absorbed_now
        new_abs = (tau_abs - res.s_abs).to(tau_abs.dtype)
        new_st = (tau_st - res.s_st).to(tau_st.dtype)
        exp1 = t["exp"][bi]
        tau_abs = torch.where(stim_now & both, exp1[0].to(tau_abs.dtype),
                              new_abs)
        tau_st = torch.where(stim_now, exp1[1].to(tau_st.dtype), new_st)
        ev_kind = torch.where(event, torch.where(absorbed_now, 1, 2),
                              ev_kind).to(torch.int32)
        if nb_loc:
            row = t["cand"][t["cell"], bi * WB + kc]
            ev_idx = torch.where(event, row[:, 7].long(), ev_idx)
            ev_dev = torch.where(event, bi // nb_loc, ev_dev)
            ev_we = torch.where(event, row[:, 5], ev_we)
            ev_p4chi = torch.where(event[:, None], row[:, :5], ev_p4chi)
        else:
            ev_idx = torch.where(
                event, torch.clamp(t["start"] + bi * WB + kc, 0,
                                   a["n_e"] - 1), ev_idx)
        done = done | event
    return (tau_abs, tau_st, ev_kind, ev_idx, done) + (
        (ev_dev, ev_we, ev_p4chi) if nb_loc else (None, None, None))


def _same_walk(got, want, tol=None, tau=None):
    """Two walks' results: events, electrons, ranks and partners'
    columns equal; depths bitwise (``tol`` None) or each within ``tol``
    of its photon's scale, the larger of its depth before (``tau``) and
    after the walk."""
    for k, (name, g, w) in enumerate(zip(AW.WalkResult._fields, got, want)):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        g = torch.as_tensor(g).cpu()
        w = torch.as_tensor(w).cpu()
        if k < 2 and tol is not None:
            g, w = g.double().numpy(), w.double().numpy()
            scale = np.maximum(np.abs(w), np.abs(tau[k]))
            assert (np.abs(g - w) <= tol * scale).all(), (
                name, (np.abs(g - w) / scale).max())
        else:
            assert torch.equal(g.to(w.dtype), w), name


@pytest.mark.parametrize("stimulated", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("source", WALK_SOURCES)
def test_absorb_walk_reference_matches_sequential_scan(source, stimulated):
    a = _walk_inputs(source)
    tau = _walk_depths(a, stimulated)
    want = _walk_scan(a, tau, stimulated)
    got = _walk(AW.absorb_walk_reference, a, tau, stimulated)
    if not a.get("nb_loc"):
        want = want[:5] + (None, None, None)
    _same_walk(got, want, 1e-12, tau)
    kinds = np.bincount(want[2], minlength=3)
    # both kinds fire (without stimulated emission only absorption),
    # and some photons walk every pass without an event
    assert kinds[0] > 0 and kinds[1] > 5 and (kinds[2] > 5) == stimulated
    assert len(set(np.asarray(got.ev_idx)[want[4]])) > 10
    # the wrapper on CPU tensors is the plain version
    _same_walk(_walk(AW.absorb_walk, a, tau, stimulated), got)


@pytest.mark.parametrize("photons, lanes, window",
                         [(32, 32, 16), (1, 32, 16), (4, 4, 8), (3, 2, 2)],
                         ids=["32_32_16", "1_32_16", "4_4_8", "3_2_2"])
@pytest.mark.parametrize("stimulated", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("source", WALK_SOURCES)
def test_walk_by_chunks_matches_sequential_scan(source, stimulated, photons,
                                                lanes, window):
    """The walk kernel's order of work (``csrc/absorb_walk.cu``; its warp
    and window also scaled down here, so that windows and chunks end
    inside passes and photons) gives the sequential scan's result
    exactly."""
    a = _walk_inputs(source)
    tau = _walk_depths(a, stimulated)
    want = _walk_scan(a, tau, stimulated)
    got = _walk_by_chunks(a, tau, stimulated, photons, lanes, window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[4].sum() > 10


@pytest.mark.parametrize("dtypes", [(torch.float64, torch.float64),
                                    (torch.float32, torch.float32),
                                    (torch.float32, torch.float64)],
                         ids=["f64", "f32", "f32_f64_depths"])
@pytest.mark.parametrize("stimulated", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("source", WALK_SOURCES)
def test_absorb_walk_reference_matches_pass_loop(source, stimulated, dtypes):
    a = _walk_inputs(source)
    tau = _walk_depths(a, stimulated)
    got = _walk(AW.absorb_walk_reference, a, tau, stimulated, *dtypes)
    _same_walk(got, _pass_loop(a, tau, stimulated, *dtypes))
    assert int(got.done.sum()) > 10


def test_walk_group_shrinks_with_the_photons():
    assert AW.walk_group(10**6) == AW.walk_group(32 * AW.WALK_WARPS) == 32
    groups = [AW.walk_group(n) for n in (75_776, 4096, 100)]
    assert groups == sorted(groups, reverse=True) and groups[-1] == 1
    assert all(n >= g * AW.WALK_WARPS for g, n in zip(groups, (75_776,)))


def _airy_from_walk_table(x, c):
    """Ai(x) with the constants read from :func:`AW.airy_table` as the
    walk kernel reads them (numpy f64, the plain code's operations; the
    padded recurrence for every branch)."""
    nt, nbr, ncheb = AW.AIRY_TERMS, AW.AIRY_BRANCHES, AW.AIRY_CHEB
    F, G, scale = c[:nt], c[nt:2 * nt], c[2 * nt]
    lo, ua, bma = (c[2 * nt + 1 + k * nbr:2 * nt + 1 + (k + 1) * nbr]
                   for k in range(3))
    coef = c[2 * nt + 1 + 3 * nbr:].reshape(nbr, ncheb)
    xt = np.clip(x, 0.0, 1.0)
    y = xt * xt * xt
    f = np.zeros_like(x)
    g = np.zeros_like(x)
    for k in range(nt - 1, -1, -1):
        f, g = f * y + F[k], g * y + G[k]
    series = f + xt * g
    br = np.full(x.shape, -1)
    for b in range(nbr):
        br = np.where(x < lo[b], br, b)
    xq = np.clip(x, 1.0, 50.0)
    sq = 2.0 * xq * np.sqrt(xq) / 3.0
    ls = np.log(sq)
    pref = scale * np.exp(-sq - ls / 6.0)
    bc = np.maximum(br, 0)
    u = 2.0 * (ls - ua[bc]) / bma[bc] - 1.0
    b1 = np.zeros_like(x)
    b2 = np.zeros_like(x)
    for k in range(ncheb - 1, 0, -1):
        b1, b2 = 2.0 * u * b1 - b2 + coef[bc, k], b1
    quad = pref * (u * b1 - b2 + coef[bc, 0])
    value = np.where(br < 0, series, quad)
    return np.where((x >= 0) & (x < 50), value, 0.0)


def test_airy_walk_table_layout():
    c = AW.airy_table()
    assert c.size == 2 * AW.AIRY_TERMS + 1 + AW.AIRY_BRANCHES * (
        3 + AW.AIRY_CHEB)
    x = np.concatenate([np.linspace(-1, 0.999, 500),
                        np.linspace(1, 60, 5000)])
    want, _ = tairy.airy_ai(torch.from_numpy(x))
    got = _airy_from_walk_table(x, c)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-300)
    # the padding is zeros at the high orders of the shorter branches
    coef = c[2 * AW.AIRY_TERMS + 1 + 3 * AW.AIRY_BRANCHES:].reshape(
        AW.AIRY_BRANCHES, AW.AIRY_CHEB)
    assert (coef[0, 13:] == 0).all() and (coef[0, :13] != 0).all()



@pytest.mark.parametrize("variant", ["threads=64", "threads=128",
                                     "minblocks=2", "window=16",
                                     "window=32,threads=64,minblocks=4"])
def test_kernel_variant_walk_edits_apply(variant):
    """``kernel_variants.py --walk``'s edits still find what they change
    in the walk kernel's source, each once; an unknown edit is
    refused."""
    import kernel_variants as KV

    src = (KV.ROOT / KV.WALK_SOURCE).read_text()
    out = KV.edit_walk(src, variant)
    assert out != src
    assert ("constexpr int kWindow = 32;" in out) == ("window=32" in variant)
    with pytest.raises(ValueError):
        KV.edit_walk(src, variant + ",segments=4")

@pytest.mark.parametrize("variant", ["threads=1024", "ctas=1", "nokeep",
                                     "threads=256,ctas=2,mintiles=4,nokeep"])
def test_kernel_variant_envelope_edits_apply(variant):
    """``kernel_variants.py --envelope``'s edits still find what they
    change in the envelope kernel's source, each once; an unknown edit
    is refused."""
    import kernel_variants as KV

    src = (KV.ROOT / KV.ENVELOPE_SOURCE).read_text()
    out = KV.edit_envelope(src, variant)
    assert out != src
    assert ("plan[2] = 0;" in out) == ("nokeep" in variant)
    with pytest.raises(ValueError):
        KV.edit_envelope(src, variant + ",window=8")

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


def _long_table_problem(dtype, n=100, queries=600, seed=5):
    """Two tables of ``n`` ordinates (more than a warp's 32: the kernel's
    segment count takes several sweeps) and queries below the range, at
    every ordinate, inside and above it."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 3, (2, n)), axis=1)
    f = np.cumsum(rng.uniform(0, 1, (2, n)), axis=1)
    f = (f - f[:, :1]) / (f[:, -1:] - f[:, :1])
    prep = TP.prepare(np.stack([x, f], axis=-1))
    tidx = rng.integers(0, 2, queries)
    fq = rng.uniform(-0.2, 1.2, queries)
    fq[:n] = f[tidx[:n], np.arange(n)]  # at the ordinates
    fq[n:n + 8] = [-1.0, -1e-9, 0.0, 1.0, 1.0 + 1e-9, 2.0, 0.5, 1e-300]
    return prep, torch.from_numpy(tidx), torch.from_numpy(fq.astype(dtype))


def _invert_by_rounds(problems, group):
    """``invert_many`` as the kernel computes it, ``group`` lanes a
    query, emulated with the plain code's operations: the segment by a
    count of the ordinates below the query, then rounds of up to L
    halvings (the largest L with 2^L - 1 <= group): every node of the
    round's tree evaluated at the midpoint formed along its own path
    from the round's [a, b], and the path the votes pick walked from the
    root."""
    levels = 1
    while (1 << (levels + 1)) - 1 <= group:
        levels += 1
    out = []
    for prep, tidx, fq in problems:
        T = TP.tables_as(prep, fq.dtype, fq.device)
        n = prep.x.shape[1]
        count = (fq[:, None] > T.f[tidx]).sum(dim=1)
        seg = torch.clamp(count - 1, 0, n - 2)
        par = TP._segment(T, tidx, seg)
        a, b = par[0], par[1]
        done = 0
        while done < TP.BISECTION_ITERS:
            lv = min(levels, TP.BISECTION_ITERS - done)
            votes = []
            for node in range(1, 1 << lv):
                na, nb = a, b
                for d in range(node.bit_length() - 2, -1, -1):
                    mid = 0.5 * (na + nb)
                    if (node >> d) & 1:
                        na = mid
                    else:
                        nb = mid
                votes.append(TP._hermite(0.5 * (na + nb), *par) < fq)
            votes = torch.stack(votes)
            v = torch.ones_like(count)
            for _ in range(lv):
                mid = 0.5 * (a + b)
                go = votes[v - 1, torch.arange(len(fq))]
                a, b = torch.where(go, mid, a), torch.where(go, b, mid)
                v = 2 * v + go.long()
            done += lv
        out.append((0.5 * (a + b), count < n))
    return out


@pytest.mark.parametrize("group", [1, 4, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_invert_by_rounds_matches_reference(dtype, group):
    calls = _sample_problems(dtype) + [[_long_table_problem(dtype)]]
    for problems in calls:
        got = _invert_by_rounds(problems, group)
        ref = TP.invert_many_reference(problems)
        for (x, ok), (xr, okr) in zip(got, ref):
            assert torch.equal(x, xr) and torch.equal(ok, okr)
    # the long table's queries fall below, inside and above its range
    ok = ref[0][1]
    assert ok.any() and not ok.all()


def test_inversion_group_shrinks_with_the_queries():
    assert TP.inversion_group(1) == TP.inversion_group(1000) == 32
    groups = [TP.inversion_group(n) for n in (2370, 32718, 10**7)]
    assert groups == sorted(groups, reverse=True) and groups[-1] == 1
    assert all(g * n <= TP.INVERSION_LANES for g, n in
               zip(groups[:2], (2370, 32718)))


# ---------------------------------------------------------------------
# the wrappers on other devices, and the kernels on the card
# ---------------------------------------------------------------------

def test_wrappers_raise_on_meta_tensors():
    a = _walk_inputs("table")
    tau = _walk_depths(a, True)
    with pytest.raises(ValueError, match="meta"):
        _walk(AW.absorb_walk, a, tau, True, device="meta")
    with pytest.raises(ValueError, match="meta"):
        AW.cell_envelopes(torch.zeros(8, dtype=torch.int32, device="meta"))
    fq = torch.zeros(4, dtype=torch.float64, device="meta")
    tidx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TP.invert_many([(TE._QUANTUM_PREP, tidx, fq)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.float64, torch.float64),
                                    (torch.float32, torch.float32),
                                    (torch.float32, torch.float64)],
                         ids=["f64", "f32", "f32_f64_depths"])
@pytest.mark.parametrize("stimulated", [True, False], ids=["stim", "no_stim"])
@pytest.mark.parametrize("source", WALK_SOURCES)
def test_absorb_walk_kernel_matches_plain(source, stimulated, dtypes):
    _need_cuda()
    a = _walk_inputs(source)
    tau = _walk_depths(a, stimulated)
    ref = _walk(AW.absorb_walk_reference, a, tau, stimulated, *dtypes,
                device="cuda")
    # the default group (one photon a warp at this size), a few and a
    # whole warp's
    for group in (None, 4, 32):
        n0 = AW.absorb_walk.launches
        walk = lambda *args, **kw: AW.absorb_walk(*args, **kw, group=group)
        got = _walk(walk, a, tau, stimulated, *dtypes, device="cuda")
        assert AW.absorb_walk.launches == n0 + 1
        torch.cuda.synchronize()
        _same_walk(got, ref,
                   1e-14 if dtypes[0] == torch.float64 else 2.0**-23, tau)
    assert int(ref.done.sum()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 70_001, 2_621_440, 16_777_216])
@pytest.mark.parametrize("kind", ["random", "sorted", "nearly_sorted"])
def test_cell_envelopes_kernel_matches_plain(kind, n):
    """One launch a call, bitwise the plain version's; 16,777,216 cells
    take more than the grid's shared memory, so most tiles are read
    twice."""
    _need_cuda()
    c = torch.from_numpy(_cells(kind, n)).cuda()
    n0 = AW.cell_envelopes.launches
    got = AW.cell_envelopes(c)
    ref = AW.cell_envelopes_reference(c)
    torch.cuda.synchronize()
    assert AW.cell_envelopes.launches == n0 + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    ctas, tiles, stored, smem = AW.cell_envelope_plan(n)
    assert ctas * tiles * 128 >= n > (ctas - 1) * tiles * 128
    assert (stored < tiles) == (n == 16_777_216)


def _envelope_sizes():
    """Cells that end a CTA's chunk exactly, one short of it and one past
    it, at the ``bench --qed`` shape's chunk and at a chunk of one tile a
    warp; none, one and a few cells; a start that is not 16-byte
    aligned."""
    sizes = [0, 1, 3, 127, 128, 129]
    for n in (2_621_440, 75_776):
        ctas, tiles, _, _ = AW.cell_envelope_plan(n)
        sizes += [ctas * tiles * 128 + d for d in (-1, 0, 1)]
        sizes += [(ctas - 1) * tiles * 128 + d for d in (-1, 0, 1)]
    return sizes


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_cell_envelopes_kernel_edges(offset):
    """Bitwise the plain version's at the chunk and tile boundaries, at
    no, one and a few cells, from an unaligned start, and on cells that
    reach int32's extremes; no launch without cells."""
    _need_cuda()
    rng = np.random.default_rng(23)
    for n in _envelope_sizes():
        for extremes in (False, True):
            c = rng.integers(-5, 4000, n + offset).astype(np.int32)
            if extremes and n:
                i = rng.integers(0, n + offset, max(1, n // 100))
                c[i] = rng.choice(np.array([np.iinfo(np.int32).min,
                                            np.iinfo(np.int32).max,
                                            np.iinfo(np.int32).min + 1],
                                           np.int32), i.size)
            c = torch.from_numpy(c).cuda()[offset:]
            n0 = AW.cell_envelopes.launches
            got = AW.cell_envelopes(c)
            ref = AW.cell_envelopes_reference(c)
            torch.cuda.synchronize()
            assert AW.cell_envelopes.launches == n0 + (n > 0)
            assert torch.equal(got[0], ref[0]), (n, extremes)
            assert torch.equal(got[1], ref[1]), (n, extremes)


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


@pytest.mark.cuda
@pytest.mark.parametrize("group", [None, 1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_invert_many_kernel_long_table(dtype, group):
    _need_cuda()
    prep, tidx, fq = _long_table_problem(dtype)
    on = [(prep, tidx.cuda(), fq.cuda())]
    got = TP.invert_many(on, group=group)
    ref = TP.invert_many_reference(on)
    torch.cuda.synchronize()
    for (x, ok), (xr, okr) in zip(got, ref):
        assert torch.equal(x, xr) and torch.equal(ok, okr)
    assert ref[0][1].any() and not ref[0][1].all()
