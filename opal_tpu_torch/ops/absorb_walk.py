"""The absorption walk and the bracketed mode's cell envelopes: the two
stages of ``interactions.absorb`` that opal_tpu's XLA fuses, as hand
CUDA kernels.

* :func:`absorb_walk` (kernel ``csrc/absorb_walk.cu``) is the whole
  walk, opal_tpu's ``fori_loop`` (body at ``opal_tpu/interactions.py:
  705``, run at ``:843``): pass by pass, for each walked photon, both
  scaled cross sections against the pass's B candidates, the running
  sums of ``w_e c dt/dx sigma`` in candidate order, the first column
  where either optical depth crosses, the event's choice by the pass's
  draws, the depth updates and the event's columns.  The candidates
  come from the per-cell table (``cand``, (n_cells, nb*B, CC), CC = 7 or
  8 with the replicated mode's buffer row) or from the transient
  segment rows of ``e_table`` ((n_e, 6), or 7 with the row's cell in
  the bracketed mode).  :func:`absorb_pass_reference` is one pass, the
  plain walk's body.
* :func:`cell_envelopes` (kernel ``csrc/cell_envelope.cu``) is the
  bracketed mode's pair of envelopes, the inclusive prefix maximum and
  the suffix minimum of the electrons' int32 cells (opal_tpu's
  ``_blocked_cummax``/``_suffix_min``, ``opal_tpu/interactions.py:
  298-318``).

Each has its plain PyTorch version beside it
(:func:`absorb_walk_reference`, :func:`cell_envelopes_reference`), which
the wrapper runs for CPU tensors; CUDA tensors launch the kernel or
raise, and any other device raises.  ``absorb_walk.launches`` and
``cell_envelopes.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..qed import airy, cross_sections


class PassResult(NamedTuple):
    """One pass's outcome per photon: the first firing column of each
    depth (B for none), the two running sums and the two probabilities
    at the event's column ``min(k_abs, k_st)`` (the sums at the pass's
    last column, and the probabilities there, without an event)."""

    k_abs: torch.Tensor  # (nw,) int64
    k_st: torch.Tensor
    s_abs: torch.Tensor  # (nw,) the candidates' dtype
    s_st: torch.Tensor
    p_abs: torch.Tensor
    p_st: torch.Tensor


def absorb_pass_reference(k4, chi, tau_abs, tau_st, done, cell, bi, B,
                          cdt_dx, stimulated, cand=None, e_table=None,
                          start=None, end=None, K=0, bracketed=False):
    """Pass ``bi`` of the walk in plain PyTorch ops (the body of
    :func:`absorb_walk_reference`).  ``k4`` (nw, 4) and ``chi`` (nw,) are the
    walked photons' four-momenta and chi, ``tau_abs``/``tau_st`` their
    depths (in their own dtype), ``done`` the photons that already had
    their event, ``cell`` their (halo-extended) cells.  The candidates
    are ``cand[cell, bi*B:(bi+1)*B]`` with the per-cell table, else the
    rows ``start + bi*B + j`` of ``e_table`` below ``end`` and the
    bound ``K`` (and, ``bracketed``, of the photon's cell); ``cell``
    indexes ``cand``'s first dimension."""
    dtype = (cand if cand is not None else e_table).dtype
    ar = torch.arange(B, device=k4.device)
    if cand is not None:
        # this pass's rows of each photon's cell
        rows = cand[cell, bi * B:(bi + 1) * B]
        valid = (~done)[:, None] & (rows[..., 6] > 0.5)
        w_e = rows[..., 5]
    else:
        # transient gathers of the photons' own segment rows
        n_e = e_table.shape[0]
        cidx = start[:, None] + bi * B + ar[None, :]
        in_seg = (cidx < end[:, None]) & (bi * B + ar < K)[None, :]
        rows = e_table[torch.clamp(cidx, 0, n_e - 1)]
        if bracketed:
            in_seg = in_seg & (rows[..., 6] == cell[:, None].to(dtype))
        valid = (~done)[:, None] & in_seg
        w_e = torch.where(valid, rows[..., 5], 0.0)
    p4, chi_e = rows[..., 0:4], rows[..., 4]
    if stimulated:
        sig_abs, sig_st = cross_sections.pair_cross_sections(
            k4[:, None, :], p4, chi[:, None], chi_e)
        p_abs = torch.where(valid, w_e * cdt_dx * sig_abs, 0.0)
        p_st = torch.where(valid, w_e * cdt_dx * sig_st, 0.0)
    else:
        sig_abs, _ = cross_sections.photon_absorption(
            k4[:, None, :], p4, chi[:, None], chi_e)
        p_abs = torch.where(valid, w_e * cdt_dx * sig_abs, 0.0)
        p_st = torch.zeros_like(p_abs)
    # the running sums in f64 (as the CPU's cumsum keeps a float row),
    # each rounded to the candidates' dtype
    cum_abs = torch.cumsum(p_abs, dim=1, dtype=torch.float64).to(dtype)
    cum_st = torch.cumsum(p_st, dim=1, dtype=torch.float64).to(dtype)
    # only a valid candidate can fire: a finished photon's negative
    # depth must not fire again
    abs_fire = valid & ((tau_abs[:, None] - cum_abs) < 0.0)
    st_fire = valid & ((tau_st[:, None] - cum_st) < 0.0)
    # the first firing column of each, B for none
    k_abs = torch.where(abs_fire, ar, B).min(dim=1).values
    k_st = torch.where(st_fire, ar, B).min(dim=1).values
    k_ev = torch.minimum(k_abs, k_st)
    event = k_ev < B
    kc = torch.clamp(k_ev, 0, B - 1)[:, None]
    take = lambda m: m.gather(1, kc)[:, 0]
    # the depths fall by the whole pass without an event, else up to the
    # event's column (the reference stops scanning there)
    return PassResult(k_abs, k_st,
                      torch.where(event, take(cum_abs), cum_abs[:, -1]),
                      torch.where(event, take(cum_st), cum_st[:, -1]),
                      take(p_abs), take(p_st))


class WalkResult(NamedTuple):
    """The walk's outcome per photon: its depths after the walk, its
    event (kind 0 none, 1 absorbed, 2 stimulated) and the event's
    electron (a row of the cell-sorted view, or in the replicated mode
    the candidate's buffer row on its rank), and whether it fired; in
    the replicated mode also the partner's rank and weight and, when
    asked for, its p4 and chi (None otherwise)."""

    tau_abs: torch.Tensor  # (nw,) the depths' dtype
    tau_st: torch.Tensor
    ev_kind: torch.Tensor  # (nw,) int32
    ev_idx: torch.Tensor  # (nw,) int64
    done: torch.Tensor  # (nw,) bool
    ev_dev: torch.Tensor | None  # (nw,) int64
    ev_we: torch.Tensor | None  # (nw,) the candidates' dtype
    ev_p4chi: torch.Tensor | None  # (nw, 5)


def absorb_walk_reference(k4, chi, tau_abs, tau_st, cell, start, r, exp, B,
                          cdt_dx, stimulated, n_e, cand=None, e_table=None,
                          end=None, K=0, bracketed=False, nb_loc=0,
                          p4chi=False) -> WalkResult:
    """The whole walk in plain PyTorch ops: :func:`absorb_pass_reference`
    a pass, then the event choice, the depth updates and the event
    columns (the loop of ``interactions.absorb`` as it ran pass by
    pass).  ``r`` (nb, nw) and ``exp`` (nb, 2, nw) are every pass's
    draws, ``start`` each photon's first segment row (the event's
    electron is ``start + column``, clipped to the ``n_e`` rows), the
    other arguments as :func:`absorb_pass_reference`'s.  With
    ``nb_loc`` > 0 (the replicated mode: ``cand`` has the buffer row in
    column 7, pass ``bi`` serves rank ``bi // nb_loc``) the event's
    columns come from the table's row, and ``p4chi`` keeps its p4 and
    chi for the records."""
    dtype = (cand if cand is not None else e_table).dtype
    tiny = cross_sections._tiny(dtype)
    nw, dev = k4.shape[0], k4.device
    replicated = nb_loc > 0
    tau_abs, tau_st = tau_abs.clone(), tau_st.clone()
    done = torch.zeros(nw, dtype=torch.bool, device=dev)
    ev_kind = torch.zeros(nw, dtype=torch.int32, device=dev)
    ev_idx = torch.zeros(nw, dtype=torch.int64, device=dev)
    ev_dev = ev_we = ev_p4chi = None
    if replicated:
        # the partner's rank, weight and (for the records) p4 and chi
        # ride the walk: the partner may sit on another rank
        ev_dev = torch.zeros(nw, dtype=torch.int64, device=dev)
        ev_we = torch.zeros(nw, dtype=dtype, device=dev)
        ev_p4chi = torch.zeros((nw, 5), dtype=dtype, device=dev)
    source = (dict(cand=cand) if cand is not None else dict(
        e_table=e_table, start=start, end=end, K=K, bracketed=bracketed))
    for bi in range(r.shape[0]):
        # the pass's cross sections, running sums and first crossings
        res = absorb_pass_reference(k4, chi, tau_abs, tau_st, done, cell, bi,
                                    B, cdt_dx, stimulated, **source)
        k_abs, k_st = res.k_abs, res.k_st
        k_ev = torch.minimum(k_abs, k_st)
        event = k_ev < B
        both = event & (k_abs == k_st)
        kc = torch.clamp(k_ev, 0, B - 1)
        pa_k, ps_k = res.p_abs, res.p_st
        choose_abs = r[bi] < pa_k / torch.clamp(pa_k + ps_k, min=tiny)
        absorbed_now = event & ((both & choose_abs) | (~both & (k_abs < k_st)))
        stim_now = event & ~absorbed_now
        # the depths fall by the whole pass without an event, else up to
        # the event's column (the reference stops scanning there)
        new_abs = (tau_abs - res.s_abs).to(tau_abs.dtype)
        new_st = (tau_st - res.s_st).to(tau_st.dtype)
        exp1 = exp[bi]
        tau_abs = torch.where(stim_now & both, exp1[0].to(tau_abs.dtype),
                              new_abs)
        tau_st = torch.where(stim_now, exp1[1].to(tau_st.dtype), new_st)
        ev_kind = torch.where(event, torch.where(absorbed_now, 1, 2),
                              ev_kind).to(torch.int32)
        if replicated:
            # the event's row of the table: its electron's buffer row on
            # its rank, weight, p4 and chi
            row = cand[cell, bi * B + kc]
            ev_idx = torch.where(event, row[:, 7].long(), ev_idx)
            ev_dev = torch.where(event, bi // nb_loc, ev_dev)
            ev_we = torch.where(event, row[:, 5], ev_we)
            if p4chi:
                ev_p4chi = torch.where(event[:, None], row[:, :5], ev_p4chi)
        else:
            # the event's electron, as a row of the cell-sorted view
            ev_idx = torch.where(
                event, torch.clamp(start + bi * B + kc, 0, n_e - 1), ev_idx)
        done = done | event
    return WalkResult(tau_abs, tau_st, ev_kind, ev_idx, done, ev_dev, ev_we,
                      ev_p4chi if p4chi else None)


_FLOATS = (torch.float32, torch.float64)
#: the most CTAs an SM holds (32 on Hopper), which bounds the envelope
#: kernel's grid (``kMaxCtasPerSm`` of ``csrc/cell_envelope.cu`` an SM)
MAX_CTAS_PER_SM = 32
#: each (device, stream)'s scratch of the envelope kernel
_ENVELOPE_AGG: dict = {}
_AIRY: dict = {}


#: the walk kernel's Airy constants (``csrc/absorb_walk.cu``): the series'
#: terms, the quadrature branches and the longest branch's Chebyshev
#: coefficients
AIRY_TERMS, AIRY_BRANCHES, AIRY_CHEB = 14, 3, 17


def airy_table() -> np.ndarray:
    """``airy.COEFFICIENTS`` rearranged as the walk kernel reads it: the
    series' f then g coefficients, ``_SCALE``, each branch's lower bound,
    then each one's u-map ``a``, then each one's ``b - a``, then each
    one's Chebyshev coefficients padded with zeros to the longest
    branch's count (the leading zero terms leave the recurrence's b1 and
    b2 exactly 0, so every branch runs one loop to the same result)."""
    c = airy.COEFFICIENTS
    nt, nbr = int(c[0]), int(c[2 + 2 * int(c[0])])
    branches, at = [], 3 + 2 * nt
    for _ in range(nbr):
        nc = int(c[at + 3])
        branches.append((c[at:at + 3], c[at + 4:at + 4 + nc]))
        at += 4 + nc
    ncmax = max(len(coef) for _, coef in branches)
    if (nt, nbr, ncmax) != (AIRY_TERMS, AIRY_BRANCHES, AIRY_CHEB):
        raise ValueError(f"airy.COEFFICIENTS has {nt} terms, {nbr} branches "
                         f"of up to {ncmax} coefficients; the walk kernel "
                         f"takes {AIRY_TERMS}, {AIRY_BRANCHES}, {AIRY_CHEB}")
    pad = [np.pad(coef, (0, ncmax - len(coef))) for _, coef in branches]
    return np.concatenate([c[1:1 + 2 * nt], c[1 + 2 * nt:2 + 2 * nt]]
                          + [np.array([h[k] for h, _ in branches])
                             for k in range(3)] + pad)


def _airy_table(dtype, device):
    """:func:`airy_table` as a tensor of ``dtype`` on ``device`` (rounded
    once, as the plain code's Python floats are), cached."""
    key = (dtype, str(device))
    hit = _AIRY.get(key)
    if hit is None:
        hit = _AIRY[key] = torch.as_tensor(airy_table(), dtype=dtype,
                                           device=device)
    return hit


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _check(name, t, dev, dtypes, shape=None):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the photons on {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


#: warps a launch of the walk kernel aims at: ``group`` photons a warp,
#: the largest power of two up to 32 that leaves at least this many
#: warps (on an H100, 132 SMs of 24 warps each at the kernel's 80
#: registers, so ~2.6 waves); from the kernel's times by group: 32
#: photons a warp at the ``bench --qed`` shape (655,360 photons), 8 at
#: the colliding_beams crossing (75,776), one for a few thousand
WALK_WARPS = 8192


def walk_group(n_photons: int) -> int:
    """Photons a warp of the walk kernel for ``n_photons`` walkers: 32
    while they fill the card so, fewer as they shrink (a warp computes
    its photons' pairs 32 at a time, so a warp of few photons finishes
    its walk sooner)."""
    g = 32
    while g > 1 and n_photons < g * WALK_WARPS:
        g //= 2
    return g


def absorb_walk(k4, chi, tau_abs, tau_st, cell, start, r, exp, B, cdt_dx,
                stimulated, n_e, cand=None, e_table=None, end=None, K=0,
                bracketed=False, nb_loc=0, p4chi=False,
                group: int | None = None) -> WalkResult:
    """The absorption walk (arguments and result as
    :func:`absorb_walk_reference`).  CPU tensors go through the plain
    version; CUDA tensors launch ``csrc/absorb_walk.cu`` once on the
    current stream (``group`` photons a warp, :func:`walk_group` of
    their count by default, each warp's valid pairs computed 32 at a
    time, a lane a candidate, every pass in the one launch, each
    photon's running sums in f64 in candidate order as the CPU's
    ``cumsum`` keeps them), or raise.  Without photons nothing is
    launched."""
    args = (k4, chi, tau_abs, tau_st, cell, start, r, exp, B, cdt_dx,
            stimulated, n_e, cand, e_table, end, K, bracketed, nb_loc, p4chi)
    dev = k4.device
    if dev.type == "cpu":
        return absorb_walk_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"no absorption walk kernel for device {dev}")
    if group is None:
        group = walk_group(k4.shape[0])
    if group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"group must be a power of two up to 32, got "
                         f"{group}")
    src = cand if cand is not None else e_table
    dtype = src.dtype
    nw, nb = k4.shape[0], r.shape[0]
    replicated = nb_loc > 0
    _check("k4", k4, dev, (dtype,), (nw, 4))
    _check("chi", chi, dev, (dtype,), (nw,))
    _check("tau_abs", tau_abs, dev, _FLOATS, (nw,))
    _check("tau_st", tau_st, dev, (tau_abs.dtype,), (nw,))
    _check("cell", cell, dev, (torch.int64,), (nw,))
    _check("r", r, dev, (dtype,), (nb, nw))
    _check("exp", exp, dev, (dtype,), (nb, 2, nw))
    if not replicated or cand is None:
        _check("start", start, dev, (torch.int64,), (nw,))
    if cand is not None:
        _check("cand", cand, dev, (dtype,))
        if cand.dim() != 3 or cand.shape[2] != (8 if replicated else 7) \
                or cand.shape[1] < nb * B:
            raise ValueError(f"cand has shape {tuple(cand.shape)}; want "
                             f"(cells, >= {nb * B}, "
                             f"{8 if replicated else 7})")
    else:
        if replicated:
            raise ValueError("the replicated walk reads the per-cell table")
        _check("e_table", e_table, dev, (dtype,))
        if e_table.dim() != 2 or e_table.shape[1] != (7 if bracketed else 6):
            raise ValueError(f"e_table has shape {tuple(e_table.shape)}")
        _check("end", end, dev, (torch.int64,), (nw,))
    empty = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device=dev)
    out = WalkResult(
        empty(nw, dt=tau_abs.dtype), empty(nw, dt=tau_abs.dtype),
        empty(nw, dt=torch.int32), empty(nw, dt=torch.int64),
        empty(nw, dt=torch.bool),
        empty(nw, dt=torch.int64) if replicated else None,
        empty(nw) if replicated else None,
        empty(nw, 5) if replicated and p4chi else None)
    if nw == 0:
        return out
    from .._build import library

    lib = library()
    coef = _airy_table(dtype, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_absorb_walk(
            _ptr(k4), _ptr(chi), _ptr(tau_abs), _ptr(tau_st), _ptr(cell),
            _ptr(start), _ptr(end), _ptr(cand), _ptr(e_table), _ptr(r),
            _ptr(exp), _ptr(coef), *(_ptr(t) for t in out),
            nw, src.shape[0], src.shape[1] if cand is not None else 0, n_e,
            src.shape[-1], coef.numel(), nb, B, K, nb_loc, int(stimulated),
            int(bracketed), group, int(dtype == torch.float64),
            int(tau_abs.dtype == torch.float64), cdt_dx,
            cross_sections._PREF, cross_sections._tiny(dtype),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"absorb_walk kernel failed: cudaError {rc}")
    absorb_walk.launches += 1
    return out


def cell_envelopes_reference(cell):
    """(prefix max, suffix min) of the int32 cells along dim 0, in plain
    PyTorch ops (``torch.cummax``/``cummin``; the TPU's two-level
    blocking of opal_tpu's ``_blocked_cummax`` is not needed)."""
    lo = torch.cummax(cell, dim=0).values
    hi = torch.flip(torch.cummin(torch.flip(cell, [0]), dim=0).values, [0])
    return lo, hi


def cell_envelope_plan(n: int) -> tuple[int, int, int, int]:
    """The envelope kernel's launch of ``n`` cells on the current CUDA
    device: (CTAs, warp tiles of 128 cells a CTA, of them kept in shared
    memory between the two reads, dynamic shared bytes a CTA)."""
    from .._build import library

    out = (ctypes.c_longlong * 4)()
    rc = library().opal_cell_envelope_plan(n, out)
    if rc != 0:
        raise RuntimeError(f"cell_envelope plan failed: cudaError {rc}")
    return tuple(out)


def _envelope_agg(dev, stream):
    """The kernel's scratch on ``dev`` for ``stream`` (each CTA's max and
    min, written before they are read in every launch), kept: launches
    on one stream run in order."""
    key = (dev.index, stream)
    agg = _ENVELOPE_AGG.get(key)
    if agg is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        agg = _ENVELOPE_AGG[key] = torch.empty(
            2 * MAX_CTAS_PER_SM * sms, dtype=torch.int32, device=dev)
    return agg


def cell_envelopes(cell):
    """The bracketed mode's envelopes of the electrons' int32 cells:
    ``(cummax(cell), min(cell[i:]))``.  CPU tensors go through the plain
    version; CUDA tensors launch ``csrc/cell_envelope.cu`` once on the
    current stream (one cooperative grid that reads each cell once), or
    raise.  Without cells nothing is launched."""
    dev = cell.device
    if dev.type == "cpu":
        return cell_envelopes_reference(cell)
    if dev.type != "cuda":
        raise ValueError(f"no cell envelope kernel for device {dev}")
    _check("cell", cell, dev, (torch.int32,))
    if cell.dim() != 1:
        raise ValueError(f"cell must be 1-D, got shape {tuple(cell.shape)}")
    n = cell.shape[0]
    lo, hi = torch.empty_like(cell), torch.empty_like(cell)
    if n == 0:
        return lo, hi
    from .._build import library

    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        agg = _envelope_agg(dev, stream)
        rc = lib.opal_cell_envelope(_ptr(cell), _ptr(lo), _ptr(hi),
                                    _ptr(agg), n, agg.numel(),
                                    ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cell_envelope kernel failed: cudaError {rc}")
    cell_envelopes.launches += 1
    return lo, hi


#: kernel launches since the counts were last set to 0
absorb_walk.launches = 0
cell_envelopes.launches = 0
