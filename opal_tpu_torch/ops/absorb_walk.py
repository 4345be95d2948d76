"""The absorption walk's pass and the bracketed mode's cell envelopes:
the two stages of ``interactions.absorb`` that opal_tpu's XLA fuses,
as hand CUDA kernels.

* :func:`absorb_pass` (kernel ``csrc/absorb_pass.cu``) is one pass of
  the walk, the body of opal_tpu's ``fori_loop``
  (``opal_tpu/interactions.py:705``, run at ``:843``): for each walked
  photon, both scaled cross sections against the pass's B candidates,
  the running sums of ``w_e c dt/dx sigma`` in candidate order, the
  first column where either optical depth crosses, and the sums and
  probabilities at that column (or the pass's totals).  The candidates
  come from the per-cell table (``cand``, (n_cells, nb*B, CC), CC = 7 or
  8 with the replicated mode's buffer row) or from the transient
  segment rows of ``e_table`` ((n_e, 6), or 7 with the row's cell in
  the bracketed mode).
* :func:`cell_envelopes` (kernel ``csrc/cell_envelope.cu``) is the
  bracketed mode's pair of envelopes, the inclusive prefix maximum and
  the suffix minimum of the electrons' int32 cells (opal_tpu's
  ``_blocked_cummax``/``_suffix_min``, ``opal_tpu/interactions.py:
  298-318``).

Each has its plain PyTorch version beside it
(:func:`absorb_pass_reference`, :func:`cell_envelopes_reference`), which
the wrapper runs for CPU tensors; CUDA tensors launch the kernel or
raise, and any other device raises.  ``absorb_pass.launches`` and
``cell_envelopes.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
    """Pass ``bi`` of the walk in plain PyTorch ops (the loop body of
    ``interactions.absorb``).  ``k4`` (nw, 4) and ``chi`` (nw,) are the
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


_FLOATS = (torch.float32, torch.float64)
#: cells a CTA of the envelope kernel scans (``kTile`` of
#: ``csrc/cell_envelope.cu``)
ENVELOPE_TILE = 2048
_AIRY: dict = {}


def _airy_table(dtype, device):
    """``airy.COEFFICIENTS`` as a tensor of ``dtype`` on ``device``
    (rounded once, as the plain code's Python floats are), cached."""
    key = (dtype, str(device))
    hit = _AIRY.get(key)
    if hit is None:
        hit = _AIRY[key] = torch.as_tensor(airy.COEFFICIENTS, dtype=dtype,
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


def absorb_pass(k4, chi, tau_abs, tau_st, done, cell, bi, B, cdt_dx,
                stimulated, cand=None, e_table=None, start=None, end=None,
                K=0, bracketed=False) -> PassResult:
    """Pass ``bi`` of the absorption walk (arguments as
    :func:`absorb_pass_reference`).  CPU tensors go through the plain
    version; CUDA tensors launch ``csrc/absorb_pass.cu`` on the current
    stream (one thread a photon, its B candidates in order, the running
    sums in f64 as the CPU's ``cumsum`` keeps them), or raise."""
    args = (k4, chi, tau_abs, tau_st, done, cell, bi, B, cdt_dx, stimulated,
            cand, e_table, start, end, K, bracketed)
    dev = k4.device
    if dev.type == "cpu":
        return absorb_pass_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"no absorption pass kernel for device {dev}")
    src = cand if cand is not None else e_table
    dtype = src.dtype
    nw = k4.shape[0]
    _check("k4", k4, dev, (dtype,), (nw, 4))
    _check("chi", chi, dev, (dtype,), (nw,))
    _check("tau_abs", tau_abs, dev, _FLOATS, (nw,))
    _check("tau_st", tau_st, dev, (tau_abs.dtype,), (nw,))
    _check("done", done, dev, (torch.bool,), (nw,))
    _check("cell", cell, dev, (torch.int64,), (nw,))
    if cand is not None:
        _check("cand", cand, dev, (dtype,))
        if cand.dim() != 3 or cand.shape[2] not in (7, 8) \
                or cand.shape[1] < (bi + 1) * B:
            raise ValueError(f"cand has shape {tuple(cand.shape)}; want "
                             f"(cells, >= {(bi + 1) * B}, 7 or 8)")
    else:
        _check("e_table", e_table, dev, (dtype,))
        if e_table.dim() != 2 or e_table.shape[1] != (7 if bracketed else 6):
            raise ValueError(f"e_table has shape {tuple(e_table.shape)}")
        _check("start", start, dev, (torch.int64,), (nw,))
        _check("end", end, dev, (torch.int64,), (nw,))
    from .._build import library

    lib = library()
    out = PassResult(
        torch.empty(nw, dtype=torch.int64, device=dev),
        torch.empty(nw, dtype=torch.int64, device=dev),
        *(torch.empty(nw, dtype=dtype, device=dev) for _ in range(4)))
    coef = _airy_table(dtype, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_absorb_pass(
            _ptr(k4), _ptr(chi), _ptr(tau_abs), _ptr(tau_st), _ptr(done),
            _ptr(cell), _ptr(cand), _ptr(e_table), _ptr(start), _ptr(end),
            _ptr(coef), *(_ptr(t) for t in out),
            nw, src.shape[0], src.shape[1] if cand is not None else 0,
            src.shape[-1], coef.numel(), bi, B, K, int(stimulated),
            int(bracketed),
            int(dtype == torch.float64), int(tau_abs.dtype == torch.float64),
            cdt_dx, cross_sections._PREF, cross_sections._tiny(dtype),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"absorb_pass kernel failed: cudaError {rc}")
    absorb_pass.launches += 1
    return out


def cell_envelopes_reference(cell):
    """(prefix max, suffix min) of the int32 cells along dim 0, in plain
    PyTorch ops (``torch.cummax``/``cummin``; the TPU's two-level
    blocking of opal_tpu's ``_blocked_cummax`` is not needed)."""
    lo = torch.cummax(cell, dim=0).values
    hi = torch.flip(torch.cummin(torch.flip(cell, [0]), dim=0).values, [0])
    return lo, hi


def cell_envelopes(cell):
    """The bracketed mode's envelopes of the electrons' int32 cells:
    ``(cummax(cell), min(cell[i:]))``.  CPU tensors go through the plain
    version; CUDA tensors launch ``csrc/cell_envelope.cu`` (a two-level
    scan: per tile, then across tiles) on the current stream, or
    raise."""
    dev = cell.device
    if dev.type == "cpu":
        return cell_envelopes_reference(cell)
    if dev.type != "cuda":
        raise ValueError(f"no cell envelope kernel for device {dev}")
    _check("cell", cell, dev, (torch.int32,))
    if cell.dim() != 1:
        raise ValueError(f"cell must be 1-D, got shape {tuple(cell.shape)}")
    from .._build import library

    lib = library()
    n = cell.shape[0]
    lo, hi = torch.empty_like(cell), torch.empty_like(cell)
    tiles = -(-n // ENVELOPE_TILE)
    # each tile's max and min, then the carries into each tile
    scratch = torch.empty((4, tiles), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_cell_envelope(_ptr(cell), _ptr(lo), _ptr(hi),
                                    _ptr(scratch), n, tiles,
                                    ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cell_envelope kernel failed: cudaError {rc}")
    cell_envelopes.launches += 1
    return lo, hi


#: kernel launches since the counts were last set to 0
absorb_pass.launches = 0
cell_envelopes.launches = 0
