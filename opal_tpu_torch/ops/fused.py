"""Fused gather + push + deposit: the PIC hot loop of the port.

One pass per block of ``block`` particles does what three passes
(``ops.interp.fields_at`` -> ``ops.pusher.vay_push``/``boris_push`` ->
``ops.deposit.deposit``) do: the particle columns are read once, the
block's field window and its deposit tile stay in fast memory.  It is
the port of ``opal_tpu/ops/fused.py``'s Pallas kernel (``_kernel_block``
launched by ``fused_push_deposit``) in the forms the step reaches: the
Vay push for electrons, with the work column, lite or full (the QED
outputs chi, gamma at the half step and prev_x as well), and the lite
Boris push for ions, without it; each with the deposit on or skipped
(``dep_skip``, decks without current deposition).  It is also the port
of the packed-layout kernel (``_kernel_packed`` launched by
``fused_push_deposit_packed``, below :data:`H_COLS`): the same physics
with the full outputs on a species packed into one hot matrix.  The
CUDA kernel of both is ``csrc/fused_push_deposit.cu``;
:func:`fused_push_deposit_reference` and
:func:`fused_push_deposit_packed_reference` are the same functions in
plain PyTorch ops.

Shape contract (as in the JAX kernel)
-------------------------------------
* particle columns are (capacity,) with capacity % block == 0; f32
  floats and int32 cells; ``anchors`` (capacity/block,) int32 window
  bases in table-row space.
* particles are *approximately* cell-sorted: block b sees field rows
  [anchors[b], anchors[b] + window).  Alive rows whose cell is outside
  rel in [1, window-3] (or outside the deposit reach) are not updated
  and not deposited; they are flagged in ``miss`` and pushed by the
  compacted fallback (:func:`misfit_fallback`).
* the field slab is an (n_rows, 8) f32 table with columns
  Ex Ey Ez Bx By Bz 0 0 and ``PAD`` extra rows on both sides.

Deposit output layout
---------------------
An (n_rows, 16) slab whose 16 columns are the reference's 15 deposit
taps (5 longitudinal-flux cells for jx, 3 b-spline taps each for jy/jz,
3+1 for rho) plus one pad column, each stored *unshifted* at the
particle's post-push cell row; :func:`fold_out_slab` shifts and sums
them into (J, rho).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from .. import constants as const
from .deposit import _particle_values
from .interp import fields_at, flux, weight
from .pusher import boris_push, vay_push

F32 = torch.float32

#: extra field-table rows on each side so base-2 .. base+W+2 never leave
#: the table for any in-domain (or one-cell-out leaver) particle
PAD = 8

#: the 16 deposit columns: (tap offset, target) with target 0..2 = J
#: xyz, 3 = rho, 4 = unused pad; mirrors ops.deposit._particle_values
COLS = (
    (-2, 0), (-1, 0), (0, 0), (1, 0), (2, 0),
    (-1, 1), (0, 1), (1, 1),
    (-1, 2), (0, 2), (1, 2),
    (-1, 3), (0, 3), (1, 3), (-2, 3), (0, 4),
)


class FusedSpec(NamedTuple):
    """Static configuration of one fused-kernel instantiation (the
    fields of ``opal_tpu.ops.fused.FusedSpec`` that the port's forms
    read)."""

    block: int          # particles per block (BS)
    window: int         # field cells visible per block (W)
    n_rows: int         # field table rows (n_slab + 2*PAD)
    dx: float
    dt: float
    charge: float       # species charge: macrocharge = weight * charge
    mass: float
    pusher: str = "vay"  # "vay" (electrons) or "boris" (ions)
    # field-table row = particle cell + row_off (HALO + PAD)
    row_off: int = 0
    # carry and integrate the work column (electrons); ions have none
    work_out: bool = True
    # output the per-step work INCREMENT (seeded at 0) for a caller that
    # accumulates work in a wider dtype, instead of accumulating into
    # the f32 work column passed in
    work_inc: bool = False
    # skip the chi / gamma-half / prev_x outputs; the full form (Vay
    # only) writes them for the QED emission pass
    lite: bool = True
    # skip the deposit: no slab is read, written or returned
    dep_skip: bool = False


def form_name(spec: FusedSpec) -> str:
    """The kernel form a spec launches, as the launch counts name it:
    the pusher, ``_full`` for the full outputs, ``_dep_skip`` without
    the deposit."""
    return (spec.pusher + ("" if spec.lite else "_full")
            + ("_dep_skip" if spec.dep_skip else ""))


def _scalars(spec: FusedSpec) -> dict:
    """The push constants, each formed in f64 exactly as the JAX kernel
    forms them (Python float products) and rounded once to f32."""
    C = const.SPEED_OF_LIGHT
    alpha = spec.charge * spec.dt / (2.0 * spec.mass * C)
    return dict(
        charge=spec.charge,
        alpha=alpha,
        c=C,
        kwork=spec.charge * C,
        dt=spec.dt,
        talpha=alpha * C,
        kx=C * spec.dt / spec.dx,
        inv_dt=1.0 / spec.dt,
        inv_dx=1.0 / spec.dx,
        crit=const.CRITICAL_FIELD,
    )


def _reach_rows(spec: FusedSpec):
    """[lo, hi] table rows whose deposit taps stay inside the current
    slab after :func:`fold_out_slab` trims the PAD rows."""
    return PAD + 2, spec.n_rows - PAD - 3


def _gather(eb_rows, row, rel, x, fit, n_rows):
    """The field gather of the kernel: the 4 live b-spline taps, rows
    rel-1 .. rel+2, summed from 0 in ascending order (the JAX W-cell
    loop adds exact zeros for every other cell, so the sums are the
    same), zeroed on rows that do not fit their window."""
    relf = rel.to(F32)
    fitf = fit.to(F32)
    d = relf + x
    zero = torch.zeros_like(x)
    Ex, Ey, Ez, By, Bz = zero, zero, zero, zero, zero
    for kk in range(4):
        wdf = (rel + (kk - 1)).to(F32)
        e = eb_rows[torch.clamp(row + (kk - 1), 0, n_rows - 1)]
        ce = weight(d - wdf)          # edge taps (Ey, Ez)
        cc = weight(d - wdf - 0.5)    # centred taps (Ex, By, Bz)
        Ex = Ex + cc * e[:, 0]
        Ey = Ey + ce * e[:, 1]
        Ez = Ez + ce * e[:, 2]
        By = By + cc * e[:, 4]
        Bz = Bz + cc * e[:, 5]
    Bx = zero + eb_rows[torch.clamp(row, 0, n_rows - 1), 3]
    return tuple(f * fitf for f in (Ex, Ey, Ez, Bx, By, Bz))


def _push(spec: FusedSpec, k: dict, ux, uy, uz, gamma, work_in, fields,
          full: bool):
    """The momentum update (``opal_tpu/ops/fused.py::_push_core``).
    Returns (unx, uny, unz, gn, ign, gh, chi, work, vty, vtz); gh, chi
    and work are ``None`` where the form does not compute them: Vay
    computes gh with ``full`` or a work column, the work with a work
    column and chi with ``full``; Boris has gh (its gamma at the half
    rotation) and chi 0 with ``full``, and passes the work through."""
    Ex, Ey, Ez, Bx, By, Bz = fields
    C = k["c"]
    alpha = k["alpha"]
    gh = chi = None
    wk = work_in
    if spec.pusher == "boris":
        # ---- Boris push (ion.rs:168-214), gamma-1 cancellation-free --
        cBx, cBy, cBz = C * Bx, C * By, C * Bz
        umx = ux + alpha * Ex
        umy = uy + alpha * Ey
        umz = uz + alpha * Ez
        um2 = umx * umx + umy * umy + umz * umz
        gam = 1.0 + um2 / (1.0 + torch.sqrt(1.0 + um2))
        if full:
            gh, chi = gam, torch.zeros_like(ux)
        # a true division: ``float / tensor`` is a reciprocal and a
        # product in PyTorch, two roundings where the kernel has one
        tb = torch.full_like(gam, alpha) / gam
        upx = umx + tb * (umy * cBz - umz * cBy)
        upy = umy + tb * (umz * cBx - umx * cBz)
        upz = umz + tb * (umx * cBy - umy * cBx)
        cB2 = cBx * cBx + cBy * cBy + cBz * cBz
        tp = 2.0 * tb / (1.0 + tb * tb * cB2)
        uplx = umx + tp * (upy * cBz - upz * cBy)
        uply = umy + tp * (upz * cBx - upx * cBz)
        uplz = umz + tp * (upx * cBy - upy * cBx)
        unx = uplx + alpha * Ex
        uny = uply + alpha * Ey
        unz = uplz + alpha * Ez
        un2 = unx * unx + uny * uny + unz * unz
        gn = 1.0 + un2 / (1.0 + torch.sqrt(1.0 + un2))
        ign = 1.0 / gn
        # transverse positions advance with the NEW velocity
        vty, vtz = C * uny * ign, C * unz * ign
        return unx, uny, unz, gn, ign, gh, chi, wk, vty, vtz

    # ---- Vay push (electron.rs:268-330) ------------------------------
    ig = 1.0 / gamma
    vx, vy, vz = C * ux * ig, C * uy * ig, C * uz * ig
    uhx = ux + alpha * (Ex + (vy * Bz - vz * By))
    uhy = uy + alpha * (Ey + (vz * Bx - vx * Bz))
    uhz = uz + alpha * (Ez + (vx * By - vy * Bx))
    if work_in is not None or full:
        gh = torch.sqrt(1.0 + uhx * uhx + uhy * uhy + uhz * uhz)
    if work_in is not None:
        wk = work_in + k["kwork"] * (
            uhx * Ex + uhy * Ey + uhz * Ez) * k["dt"] / gh
    if full:
        # chi from F.u at the half step; a true division by the
        # critical field (``tensor / float`` is a product with the
        # reciprocal on CUDA)
        fx = gh * Ex + C * (uhy * Bz - uhz * By)
        fy = gh * Ey + C * (uhz * Bx - uhx * Bz)
        fz = gh * Ez + C * (uhx * By - uhy * Bx)
        eu = Ex * uhx + Ey * uhy + Ez * uhz
        f2 = fx * fx + fy * fy + fz * fz - eu * eu
        chi = torch.sqrt(torch.clamp(f2, min=0.0)) / torch.full_like(
            f2, k["crit"])
    upx = uhx + alpha * Ex
    upy = uhy + alpha * Ey
    upz = uhz + alpha * Ez
    gp2 = 1.0 + upx * upx + upy * upy + upz * upz
    ta = k["talpha"]
    tvx, tvy, tvz = ta * Bx, ta * By, ta * Bz
    ustar = upx * tvx + upy * tvy + upz * tvz
    t2 = tvx * tvx + tvy * tvy + tvz * tvz
    sig = gp2 - t2
    gn = torch.sqrt(
        0.5 * sig + torch.sqrt(0.25 * sig * sig + t2 + ustar * ustar))
    ign = 1.0 / gn
    itx, ity, itz = tvx * ign, tvy * ign, tvz * ign
    s = 1.0 / (1.0 + itx * itx + ity * ity + itz * itz)
    udt = upx * itx + upy * ity + upz * itz
    unx = s * (upx + udt * itx + (upy * itz - upz * ity))
    uny = s * (upy + udt * ity + (upz * itx - upx * itz))
    unz = s * (upz + udt * itz + (upx * ity - upy * itx))
    # transverse positions advance with the OLD velocity
    return unx, uny, unz, gn, ign, gh, chi, wk, vy, vz


def _step(spec: FusedSpec, anchors, row, x, ux, uy, uz, gamma, q, work_in,
          eb_rows, full: bool):
    """Fit test, gather, push and x advance of every row, and the next
    window bases (``_kernel_block``/``_kernel_packed`` up to their
    write-back).  ``row`` is the table row (cell + row_off), ``q`` the
    macrocharge.  Returns a dict of the intermediate tensors."""
    BS, W, n_rows = spec.block, spec.window, spec.n_rows
    nblk = row.shape[0] // BS
    k = {name: float(v) for name, v in _scalars(spec).items()}
    base = anchors.long().repeat_interleave(BS)
    rel = row - base
    lo_row, hi_row = _reach_rows(spec)
    fit = (rel >= 1) & (rel <= W - 3) & (row >= lo_row) & (row <= hi_row)
    alive = q != 0.0
    upd = fit & alive
    fields = _gather(eb_rows, row, rel, x, fit, n_rows)
    unx, uny, unz, gn, ign, gh, chi, wk, vty, vtz = _push(
        spec, k, ux, uy, uz, gamma, work_in, fields, full)

    # ---- x advance and the +-1 cell shift (sign of floor) -----------
    xn = x + k["kx"] * unx * ign
    fl = torch.floor(xn)
    celln = row + torch.sign(fl).long()
    xn = xn - fl
    prevn = x - fl

    # ---- next window bases: per-block minimum of the post-push fit
    # rows, or of the alive rows' pre-push cells when none fit --------
    sent = n_rows
    amin_fit = torch.where(upd, celln, sent).view(nblk, BS).amin(dim=1)
    amin_alive = torch.where(alive, row, sent).view(nblk, BS).amin(dim=1)
    amin = torch.where(amin_fit == sent, amin_alive, amin_fit)
    anchors_next = torch.clamp(amin - 1, 2, n_rows - W - 2).to(torch.int32)
    return dict(k=k, upd=upd, miss=(alive & ~fit).to(F32), unx=unx,
                uny=uny, unz=unz, gn=gn, ign=ign, gh=gh, chi=chi, work=wk,
                vty=vty, vtz=vtz, xn=xn, celln=celln, prevn=prevn,
                q=q, anchors_next=anchors_next)


def _deposit(spec: FusedSpec, r: dict):
    """The charge-conserving deposit of the updated rows' 16 unshifted
    tap columns into a new (n_rows, 16) slab."""
    k, upd = r["k"], r["upd"]
    xn, prevn, ign = r["xn"], r["prevn"], r["ign"]
    qd = torch.where(upd, r["q"], 0.0)
    qf = qd * k["inv_dt"]
    qx = qd * k["inv_dx"]
    qy = qx * (k["c"] * r["uny"] * ign)
    qz = qx * (k["c"] * r["unz"] * ign)
    w_m1 = weight(1.0 + xn)
    w_0 = weight(xn)
    w_p1 = weight(1.0 - xn)
    w_q = weight(2.0 - xn)  # the reference's index-2 rho quirk
    vals = torch.stack(
        [qf * flux(b - prevn, b - xn) for b in (-1.5, -0.5, 0.5, 1.5, 2.5)]
        + [qy * w_m1, qy * w_0, qy * w_p1,
           qz * w_m1, qz * w_0, qz * w_p1,
           qx * w_m1, qx * w_0, qx * w_p1, qx * w_q,
           torch.zeros_like(qd)],
        dim=1,
    )
    vals = torch.where(upd[:, None], vals, 0.0)
    out = torch.zeros((spec.n_rows, 16), dtype=F32, device=xn.device)
    out.index_add_(0, torch.where(upd, r["celln"], 0), vals)
    return out


def fused_push_deposit_reference(spec: FusedSpec, anchors, cell, x, y, z,
                                 ux, uy, uz, gamma, weight_, work, eb_rows):
    """Plain PyTorch version of the fused kernel, vectorized over all
    rows.  Same arguments and results as :func:`fused_push_deposit`.

    The arithmetic follows the JAX kernel operation by operation (same
    association, constants rounded to f32 once), so on a card the CUDA
    kernel, built without FMA contraction, reproduces its push columns
    bit for bit; the deposit slab differs only by summation order."""
    _check_form(spec)
    work_in = None
    if spec.work_out:
        work_in = torch.zeros_like(ux) if spec.work_inc else work
    row = cell.long() + spec.row_off
    r = _step(spec, anchors, row, x, ux, uy, uz, gamma,
              weight_ * float(spec.charge), work_in, eb_rows,
              full=not spec.lite)
    upd = r["upd"]
    dt = r["k"]["dt"]
    cols = dict(
        cell=(torch.where(upd, r["celln"], row) - spec.row_off).to(
            torch.int32),
        x=torch.where(upd, r["xn"], x),
        y=torch.where(upd, y + r["vty"] * dt, y),
        z=torch.where(upd, z + r["vtz"] * dt, z),
        ux=torch.where(upd, r["unx"], ux),
        uy=torch.where(upd, r["uny"], uy),
        uz=torch.where(upd, r["unz"], uz),
        gamma=torch.where(upd, r["gn"], gamma),
    )
    if spec.work_out:
        cols["winc" if spec.work_inc else "work"] = torch.where(
            upd, r["work"], work_in)
    if not spec.lite:
        # rows not updated are inert in the emission rate: rate(0) = 0
        cols.update(prev_x=torch.where(upd, r["prevn"], x),
                    gh=torch.where(upd, r["gh"], 1.0),
                    chi=torch.where(upd, r["chi"], 0.0))
    out = None if spec.dep_skip else _deposit(spec, r)
    return cols, r["miss"], out, r["anchors_next"]


def _check_form(spec: FusedSpec):
    """Refuse a form the kernel does not build: electrons (vay) carry
    the work column, lite or full; ions (boris) are lite without it."""
    ok = (spec.pusher == "vay" and spec.work_out) or (
        spec.pusher == "boris" and not spec.work_out and spec.lite)
    if not ok:
        raise ValueError(
            f"no kernel for pusher {spec.pusher!r} with work_out="
            f"{spec.work_out}, lite={spec.lite}: electrons (vay) carry the "
            "work column, ions (boris) are lite and do not"
        )


def _check_args(spec: FusedSpec, anchors, cols: dict, work, eb_rows):
    dev = eb_rows.device
    n = cols["cell"].shape[0]
    if n % spec.block:
        raise ValueError(f"capacity {n} is not a multiple of block {spec.block}")
    if spec.window + 4 > spec.n_rows:
        raise ValueError("window + 4 must not exceed the field table rows")
    _check_form(spec)
    want = dict(cols, anchors=anchors, eb_rows=eb_rows)
    if spec.work_out and not spec.work_inc:
        want["work"] = work
    elif work is not None:
        raise ValueError("work_inc and work_out=False kernels take no work "
                         "column")
    for name, t in want.items():
        if t is None:
            raise ValueError(f"{name} is required")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, eb_rows on {dev}")
        dtype = torch.int32 if name in ("cell", "anchors") else F32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in want.items():
        shape = {
            "anchors": (n // spec.block,), "eb_rows": (spec.n_rows, 8),
        }.get(name, (n,))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def fused_push_deposit(spec: FusedSpec, anchors, cell, x, y, z, ux, uy, uz,
                       gamma, weight_, work, eb_rows):
    """Run the fused gather + push + deposit over all particle blocks.

    CPU tensors go through :func:`fused_push_deposit_reference`; CUDA
    tensors launch the CUDA kernel (``csrc/fused_push_deposit.cu``) on
    the current stream, or raise.  ``work`` is the f32 work column, or
    ``None`` with ``spec.work_inc`` or without ``spec.work_out``.

    Returns ``(cols, miss, out_slab, anchors_next)``: ``cols`` the
    updated columns (cell x y z ux uy uz gamma, with ``work_out``
    ``work`` or ``winc``, and unless ``lite`` prev_x gh chi), ``miss`` an
    f32 0/1 mask of alive rows outside their window, ``out_slab`` the
    (n_rows, 16) unshifted deposit accumulator (``None`` with
    ``dep_skip``), and ``anchors_next`` the window bases for the next
    step.
    """
    args = (spec, anchors, cell, x, y, z, ux, uy, uz, gamma, weight_,
            work, eb_rows)
    if cell.device.type == "cpu":
        return fused_push_deposit_reference(*args)
    if cell.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {cell.device}")
    cols_in = dict(cell=cell, x=x, y=y, z=z, ux=ux, uy=uy, uz=uz,
                   gamma=gamma, weight=weight_)
    _check_args(spec, anchors, cols_in, work, eb_rows)
    from .._build import library

    lib = library()
    n = cell.shape[0]
    out_cols = {name: torch.empty_like(t) for name, t in cols_in.items()
                if name != "weight"}
    wname = "winc" if spec.work_inc else "work"
    if spec.work_out:
        out_cols[wname] = torch.empty_like(x)
    if not spec.lite:
        out_cols.update(prev_x=torch.empty_like(x), gh=torch.empty_like(x),
                        chi=torch.empty_like(x))
    miss = torch.empty_like(x)
    anchors_next = torch.empty_like(anchors)
    out = (None if spec.dep_skip else
           torch.zeros((spec.n_rows, 16), dtype=F32, device=x.device))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    k = _scalars(spec)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_fused_push_deposit(
            ptr(anchors), ptr(cell), ptr(x), ptr(y), ptr(z), ptr(ux),
            ptr(uy), ptr(uz), ptr(gamma), ptr(weight_),
            ptr(work), ptr(eb_rows),
            *(ptr(out_cols.get(c)) for c in
              ("cell", "x", "y", "z", "ux", "uy", "uz", "gamma", wname,
               "prev_x", "gh", "chi")),
            ptr(miss), ptr(anchors_next), ptr(out),
            n, spec.block, spec.window, spec.n_rows, spec.row_off, PAD,
            int(spec.pusher == "boris"), int(spec.work_out),
            int(not spec.lite), int(not spec.dep_skip),
            *(k[c] for c in ("charge", "alpha", "c", "kwork", "dt",
                             "talpha", "kx", "inv_dt", "inv_dx", "crit")),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"fused_push_deposit kernel failed: cudaError {rc}")
    fused_push_deposit.launches[form_name(spec)] += 1
    return out_cols, miss, out, anchors_next


# ----------------------------------------------------------------------
# The packed layout (opal_tpu/ops/fused.py:895-1131)
# ----------------------------------------------------------------------
#
# A fused species may ride the step as ONE hot matrix
#
#     h: (nblk, 9, RB, 128) f32   columns H_COLS (cell as f32 .. work)
#
# read and written by the kernel, an aux matrix the kernel derives every
# step (prev_x chi gh miss), and a read-only weight array whose sign is
# the alive mask.  opal_tpu packed it for the TPU's DMA engine (one
# block read instead of ~24); on a GPU each column of a block is still a
# contiguous run of ``block`` values, so the packed kernel is the column
# kernel with other strides.  The layout's semantics are opal_tpu's: the
# cell is stored as f32 (exact below 2**24), dead rows have weight 0,
# ions carry a zero work column, and the work integral accumulates in
# f32 inside h even under mixed precision (cast back on unpack).

#: hot-matrix columns (kernel input and output)
H_COLS = ("cell", "x", "y", "z", "ux", "uy", "uz", "gamma", "work")
#: aux-matrix columns (kernel output only, re-derived every step)
A_COLS = ("prev_x", "chi", "gh", "miss")


@dataclasses.dataclass
class PackedState:
    """Fused-species state in the packed hot/aux layout; ``tau`` (the
    electrons' optical depth) stays a column outside the kernel."""

    h: torch.Tensor                # (nblk, len(H_COLS), RB, 128) f32
    aux: torch.Tensor              # (nblk, len(A_COLS), RB, 128) f32
    weight: torch.Tensor           # (nblk, RB, 128) f32; alive: > 0
    tau: torch.Tensor | None       # (n,) or None


def pack_fused(st, block: int) -> PackedState:
    """``ParticleState`` of an electron or ion species -> ``PackedState``
    (``opal_tpu/ops/fused.py::pack_fused``)."""
    n = st.x.shape[0]
    nblk, RB = n // block, block // 128
    to4 = lambda a: a.to(F32).reshape(nblk, RB, 128)
    zero = torch.zeros((nblk, RB, 128), dtype=F32, device=st.x.device)
    hc = dict(
        cell=to4(st.cell), x=to4(st.x), y=to4(st.y), z=to4(st.z),
        ux=to4(st.ux), uy=to4(st.uy), uz=to4(st.uz), gamma=to4(st.gamma),
        work=to4(st.work) if st.work is not None else zero,
    )
    ac = dict(
        prev_x=to4(st.prev_x),
        chi=to4(st.chi) if st.chi is not None else zero,
        gh=torch.ones_like(zero), miss=zero,
    )
    return PackedState(
        h=torch.stack([hc[c] for c in H_COLS], dim=1),
        aux=torch.stack([ac[c] for c in A_COLS], dim=1),
        weight=to4(torch.where(st.alive, st.weight, 0.0)),
        tau=st.tau,
    )


def unpack_fused(ps: PackedState, template):
    """``PackedState`` -> ``ParticleState`` with the template's dtypes
    and its other columns; alive is ``weight > 0``, and the f32 work
    column is cast to the template's (f64 under mixed precision)."""
    n = template.x.shape[0]
    flat = lambda a: a.reshape(n)
    w = flat(ps.weight).to(template.weight.dtype)
    rep = dict(
        cell=flat(ps.h[:, 0]).to(template.cell.dtype),
        x=flat(ps.h[:, 1]), y=flat(ps.h[:, 2]), z=flat(ps.h[:, 3]),
        ux=flat(ps.h[:, 4]), uy=flat(ps.h[:, 5]), uz=flat(ps.h[:, 6]),
        gamma=flat(ps.h[:, 7]), prev_x=flat(ps.aux[:, 0]),
        weight=w, alive=w > 0,
    )
    if template.work is not None:
        rep["work"] = flat(ps.h[:, 8]).to(template.work.dtype)
    if template.chi is not None:
        rep["chi"] = flat(ps.aux[:, 1])
    if template.tau is not None:
        rep["tau"] = ps.tau
    return dataclasses.replace(template, **rep)


def packed_form_name(spec: FusedSpec) -> str:
    """The packed kernel form a spec launches: the pusher, ``_packed``,
    and ``_dep_skip`` without the deposit.  The packed kernel always
    writes the full outputs and carries the work column, so the spec's
    ``lite``, ``work_out`` and ``work_inc`` do not apply to it."""
    return spec.pusher + "_packed" + ("_dep_skip" if spec.dep_skip else "")


def fused_push_deposit_packed_reference(spec: FusedSpec, anchors, H,
                                        weight_, eb_rows):
    """Plain PyTorch version of the packed kernel
    (``opal_tpu/ops/fused.py::_kernel_packed`` and the anchor clip of
    ``fused_push_deposit_packed``); same arguments and results as
    :func:`fused_push_deposit_packed`.  The physics is the column
    version's (:func:`_step`, :func:`_deposit`), with the full outputs
    and the work read from and accumulated into ``H``."""
    nblk, CH, RB, _ = H.shape
    n = nblk * RB * 128
    col = lambda c: H[:, c].reshape(n)
    cellf, x, y, z, ux, uy, uz, g, work_in = (col(c) for c in range(CH))
    row = cellf.to(torch.int32).long() + spec.row_off
    r = _step(spec, anchors, row, x, ux, uy, uz, g,
              weight_.reshape(n) * float(spec.charge), work_in, eb_rows,
              full=True)
    upd = r["upd"]
    dt = r["k"]["dt"]
    hn = (
        torch.where(upd, (r["celln"] - spec.row_off).to(F32), cellf),
        torch.where(upd, r["xn"], x),
        torch.where(upd, y + r["vty"] * dt, y),
        torch.where(upd, z + r["vtz"] * dt, z),
        torch.where(upd, r["unx"], ux),
        torch.where(upd, r["uny"], uy),
        torch.where(upd, r["unz"], uz),
        torch.where(upd, r["gn"], g),
        torch.where(upd, r["work"], work_in),
    )
    an = (
        torch.where(upd, r["prevn"], x),
        torch.where(upd, r["chi"], 0.0),
        torch.where(upd, r["gh"], 1.0),
        r["miss"],
    )
    to4 = lambda a: a.view(nblk, RB, 128)
    out = None if spec.dep_skip else _deposit(spec, r)
    return (torch.stack([to4(a) for a in hn], dim=1),
            torch.stack([to4(a) for a in an], dim=1), out,
            r["anchors_next"])


def _check_packed_args(spec: FusedSpec, anchors, H, weight_, eb_rows):
    if H.dim() != 4 or tuple(H.shape[1:2] + H.shape[3:]) != (
            len(H_COLS), 128):
        raise ValueError(f"H has shape {tuple(H.shape)}, want "
                         f"(nblk, {len(H_COLS)}, RB, 128)")
    nblk, _, RB, _ = H.shape
    if spec.block != RB * 128:
        raise ValueError(f"block {spec.block} is not RB * 128 = {RB * 128}")
    if spec.window + 4 > spec.n_rows:
        raise ValueError("window + 4 must not exceed the field table rows")
    want = dict(anchors=((nblk,), torch.int32), H=(tuple(H.shape), F32),
                weight=((nblk, RB, 128), F32),
                eb_rows=((spec.n_rows, 8), F32))
    for name, t in dict(anchors=anchors, H=H, weight=weight_,
                        eb_rows=eb_rows).items():
        shape, dtype = want[name]
        if t.device != H.device:
            raise ValueError(f"{name} is on {t.device}, H on {H.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def fused_push_deposit_packed(spec: FusedSpec, anchors, H, weight_,
                              eb_rows):
    """Run the fused kernel over the packed layout: ``H`` (nblk, 9, RB,
    128) in the columns :data:`H_COLS`, ``weight_`` (nblk, RB, 128),
    ``anchors`` (nblk,) int32, the (n_rows, 8) field table; ``spec.block
    == RB * 128``.

    CPU tensors go through :func:`fused_push_deposit_packed_reference`;
    CUDA tensors launch the CUDA kernel (``csrc/fused_push_deposit.cu``,
    its packed forms) on the current stream, or raise.

    Returns ``(H_new, A_new, out_slab, anchors_next)``: the updated hot
    matrix, the aux matrix (nblk, 4, RB, 128) in the columns
    :data:`A_COLS`, the (n_rows, 16) deposit slab (``None`` with
    ``dep_skip``) and the window bases for the next step."""
    if H.device.type == "cpu":
        return fused_push_deposit_packed_reference(spec, anchors, H,
                                                   weight_, eb_rows)
    if H.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {H.device}")
    if spec.pusher not in ("vay", "boris"):
        raise ValueError(f"no packed kernel for pusher {spec.pusher!r}")
    _check_packed_args(spec, anchors, H, weight_, eb_rows)
    from .._build import library

    lib = library()
    nblk = H.shape[0]
    H_new = torch.empty_like(H)
    A_new = torch.empty((nblk, len(A_COLS)) + tuple(H.shape[2:]),
                        dtype=F32, device=H.device)
    anchors_next = torch.empty_like(anchors)
    out = (None if spec.dep_skip else
           torch.zeros((spec.n_rows, 16), dtype=F32, device=H.device))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    k = _scalars(spec)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_fused_push_deposit_packed(
            ptr(anchors), ptr(H), ptr(weight_), ptr(eb_rows), ptr(H_new),
            ptr(A_new), ptr(anchors_next), ptr(out), nblk, spec.block,
            spec.window, spec.n_rows, spec.row_off, PAD,
            int(spec.pusher == "boris"), int(not spec.dep_skip),
            *(k[c] for c in ("charge", "alpha", "c", "kwork", "dt",
                             "talpha", "kx", "inv_dt", "inv_dx", "crit")),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_push_deposit_packed kernel failed: cudaError {rc}")
    fused_push_deposit_packed.launches[packed_form_name(spec)] += 1
    return H_new, A_new, out, anchors_next


#: the kernel forms the step can reach, by :func:`form_name` (column
#: layout) and :func:`packed_form_name` (packed layout)
FORMS = ("vay", "vay_dep_skip", "vay_full", "vay_full_dep_skip", "boris",
         "boris_dep_skip", "vay_packed", "vay_packed_dep_skip",
         "boris_packed", "boris_packed_dep_skip")

#: kernel launches of each form since the counts were last reset, one
#: dict for both layouts' wrappers (chip_smoke.py reads it to show the
#: main path ran through the kernel)
fused_push_deposit.launches = dict.fromkeys(FORMS, 0)
fused_push_deposit_packed.launches = fused_push_deposit.launches


def make_eb_rows(E_slab, B_slab):
    """(n_slab, 3)+(n_slab, 3) field slabs -> padded (n_rows, 8) f32 table."""
    n_slab = E_slab.shape[0]
    eb = torch.zeros((n_slab + 2 * PAD, 8), dtype=F32, device=E_slab.device)
    eb[PAD:PAD + n_slab, 0:3] = E_slab
    eb[PAD:PAD + n_slab, 3:6] = B_slab
    return eb


@functools.lru_cache(maxsize=None)
def _tap_offsets(device: torch.device):
    """The row offsets of :data:`COLS` on ``device``, made once: a copy
    from the host's pageable memory waits for the device's queue."""
    return torch.tensor([off for off, _ in COLS], device=device)


def fold_out_slab(out_slab):
    """(n_rows, 16) unshifted tap accumulator -> (n_slab, 3) J and
    (n_slab,) rho: column c with tap offset ``off`` adds at row + off.
    Rows the kernel writes stay >= 2 away from the table edge, so the
    wrapped rows are zero."""
    n_rows = out_slab.shape[0]
    offs = _tap_offsets(out_slab.device)
    src = (torch.arange(n_rows, device=out_slab.device)[:, None]
           - offs[None, :]) % n_rows
    shifted = torch.gather(out_slab, 0, src)
    tgt = [t for _, t in COLS]
    comp = [
        sum(shifted[:, k] for k in range(len(COLS)) if tgt[k] == c)
        for c in range(4)
    ]
    J = torch.stack(comp[:3], dim=-1)
    return J[PAD:-PAD], comp[3][PAD:-PAD]


def deposit_into_slab(out_slab, row, x, prev_x, macrocharge, velocity,
                      dx, dt):
    """Misfit-fallback deposition added into the kernel's (n_rows, 16)
    tap slab (a new tensor is returned), so one fold serves kernel and
    fallback alike.  ``row`` is table-row space (cell + row_off).  Rows
    outside the deposit reach [PAD+2, n_rows-PAD-3] deposit nothing;
    callers count them as losses.  Dead rows must carry zero
    macrocharge."""
    n_rows = out_slab.shape[0]
    vals, _plan = _particle_values(
        x, prev_x, macrocharge, velocity[:, 1], velocity[:, 2], dx, dt
    )
    vals = torch.cat([vals, torch.zeros_like(vals[:, :1])], dim=1)
    row = row.long()
    ok = (row >= PAD + 2) & (row <= n_rows - PAD - 3)
    out = out_slab.clone()
    out.index_add_(
        0, torch.where(ok, row, 0),
        torch.where(ok[:, None], vals, 0.0).to(out.dtype),
    )
    return out


def block_anchors(spec: FusedSpec, cell):
    """Per-block window bases for a cell-sorted state: the block's
    minimum cell in table-row space, minus 1 so rel >= 1, clipped to
    [2, n_rows - W - 2] so neither the window read nor the deposit
    write (base-2 .. base+W+2) leaves the table."""
    mins = cell.view(-1, spec.block).amin(dim=1)
    return torch.clamp(
        mins + spec.row_off - 1, 2, spec.n_rows - spec.window - 2
    ).to(torch.int32)


#: rows of a tile of the compaction kernel (``csrc/misfit_compact.cu``'s
#: ``kTile``): it counts the flags a tile, and reads again only the tiles
#: whose rows enter the table
COMPACT_TILE = 8192


def misfit_compact_reference(miss, capacity, counts=None):
    """Plain PyTorch version of :func:`misfit_compact` (opal_tpu's
    ``misfit_compact``, XLA's cumsum and searchsorted): a compare, an
    int64 cast, a cumsum and a searchsorted over every flag.  Same
    arguments; where ``counts`` is given, the tiles the kernel reads
    again are added to it (:func:`compact_tiles_read`)."""
    m = miss.reshape(-1) > 0.5
    R = torch.cumsum(m.long(), dim=0)
    table = torch.searchsorted(
        R, torch.arange(1, capacity + 1, device=miss.device)
    )
    if counts is not None:
        counts += compact_tiles_read(miss, capacity)
    return table, torch.clamp(R[-1] - capacity, min=0)


def compact_tiles_read(miss, capacity):
    """The tiles of :data:`COMPACT_TILE` rows (cut within each row of a
    2-d ``miss``) that the compaction kernel reads a second time: those
    with a flag whose flags before them number fewer than ``capacity``
    (0-d int64)."""
    m = (miss > 0.5).reshape(-1, miss.shape[-1] if miss.dim() == 2
                             else miss.numel())
    nblk, block = m.shape
    tiles = torch.zeros((nblk, -(-block // COMPACT_TILE) * COMPACT_TILE),
                        dtype=torch.int64, device=miss.device)
    tiles[:, :block] = m
    c = tiles.view(-1, COMPACT_TILE).sum(dim=1)
    return ((c > 0) & (torch.cumsum(c, dim=0) - c < capacity)).sum()


def misfit_compact(miss, capacity, counts=None):
    """Indices of the first ``capacity`` rows whose flag in ``miss`` is
    above 0.5 (int64, ascending), plus the overflow count (a fresh 0-d
    int64: the flagged rows past the capacity).  Entries beyond the
    flagged total come back as n, the number of flags.

    ``miss`` is f32: a contiguous column of the n flags, or an (nblk,
    block) view with its rows at unit stride, row r of the flags at
    ``miss[r // block, r % block]`` (the packed layout's aux column).
    Where ``counts`` is given, a (1,) int64 (while a profiler records),
    the tiles the kernel read a second time are added to it.

    CPU tensors go through :func:`misfit_compact_reference`; CUDA tensors
    launch the compaction kernel (``csrc/misfit_compact.cu``: three
    launches, sized by the shapes alone, no read of the device) on the
    current stream, or raise."""
    if miss.device.type == "cpu":
        return misfit_compact_reference(miss, capacity, counts)
    if miss.device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {miss.device}")
    capacity = int(capacity)
    nblk, block, stride = _check_compact_args(miss, capacity, counts)
    from .._build import library

    lib = library()
    dev = miss.device
    ntiles = nblk * -(-block // COMPACT_TILE)
    table = torch.empty(capacity, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    scan = torch.empty(ntiles + 1, dtype=torch.int64, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_misfit_compact(
            ptr(miss), nblk, block, stride, ptr(scan), scan.numel(),
            ptr(table), capacity, ptr(overflow), ptr(counts),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"misfit_compact kernel failed: cudaError {rc}")
    misfit_compact.launches += 1
    return table, overflow


def _check_compact_args(miss, capacity: int, counts):
    """(nblk, block, stride) of the flags, or raise."""
    if miss.dtype != F32:
        raise TypeError(f"miss must be {F32}, got {miss.dtype}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    if miss.dim() == 1 and miss.is_contiguous():
        n = miss.numel()
        rows = (1, n, n)
    elif miss.dim() == 2 and miss.stride(1) == 1 and (
            miss.shape[0] <= 1 or miss.stride(0) >= miss.shape[1]):
        rows = (*miss.shape, miss.stride(0))
    else:
        raise ValueError(
            f"miss must be a contiguous column or an (nblk, block) view "
            f"with rows at unit stride, got shape {tuple(miss.shape)} "
            f"strides {miss.stride()}")
    if counts is not None and (
            counts.device != miss.device or counts.dtype != torch.int64
            or counts.shape != (1,)):
        raise ValueError("counts must be a (1,) int64 on the flags' device")
    return rows


#: compaction calls on the card (three kernel launches each) since the
#: count was last reset
misfit_compact.launches = 0


# ----------------------------------------------------------------------
# The misfit fallback (opal_tpu/sim.py:617-708)
# ----------------------------------------------------------------------
#
# The rows a kernel flags in ``miss`` (alive, outside their block's
# window or its deposit reach) come back from it as they were.  The
# fallback pushes and deposits them, in place in the kernel's outputs,
# every step at the table's fixed capacity: on a card as one launch
# whatever the table holds, so that the step reads nothing back to the
# host.  Both layouts go through it as the same rows: each column an
# (nblk, block) view into the kernel's outputs.

#: the columns of the fallback's rows; ``work`` is the kernel's work
#: column (``work`` or ``winc``), and prev_x gh chi are there in the full
#: forms (no gh in the packed layout)
ROW_COLS = ("cell", "x", "y", "z", "ux", "uy", "uz", "gamma", "work",
            "prev_x", "gh", "chi")


def column_rows(cols: dict, block: int) -> dict:
    """The outputs of :func:`fused_push_deposit` as the fallback's rows:
    each column an (nblk, block) view, ``winc`` named ``work``."""
    return {("work" if c == "winc" else c): v.view(-1, block)
            for c, v in cols.items()}


def packed_rows(h, aux) -> dict:
    """The outputs of :func:`fused_push_deposit_packed` as the fallback's
    rows: views of the hot matrix's columns and of the aux matrix's
    prev_x and chi.  Its gh stays as the kernel wrote it (1 on misfit
    rows): the packed layout runs no QED and nothing reads it, as in
    opal_tpu."""
    nblk, _, RB, L = h.shape
    rows = {c: h[:, k].view(nblk, RB * L) for k, c in enumerate(H_COLS)}
    for c in ("prev_x", "chi"):
        rows[c] = aux[:, A_COLS.index(c)].view(nblk, RB * L)
    return rows


def misfit_fallback_reference(spec: FusedSpec, mtab, rows: dict, weight_,
                              E_slab, B_slab, out_slab, losses,
                              counts=None):
    """Plain PyTorch version of :func:`misfit_fallback` (opal_tpu's
    ``_fallback``): the unfused field gather (``fields_at`` on the
    halo-extended field slabs), the Vay or Boris push and the deposit
    into the tap slab (:func:`deposit_into_slab`) of the table's rows.
    Same arguments; on the CPU the count waits on nothing, so a table
    with no row returns at once."""
    nblk, block = rows["x"].shape
    idx = mtab[mtab < nblk * block]
    if counts is not None:
        counts += torch.tensor([idx.numel(), int(idx.numel() > 0)],
                               device=counts.device)
    if not idx.numel():
        return
    blk, pin = idx // block, idx % block
    old = {c: v[blk, pin] for c, v in rows.items()}
    cell = old["cell"].to(torch.int32)
    x = old["x"]
    q = weight_.reshape(-1)[idx] * float(spec.charge)
    Ep, Bp = fields_at(E_slab, B_slab, cell + (spec.row_off - PAD), x)
    Ep, Bp = Ep.to(x.dtype), Bp.to(x.dtype)
    u = torch.stack([old["ux"], old["uy"], old["uz"]], dim=1)
    if spec.pusher == "vay":
        res = vay_push(cell, x, old["y"], old["z"], u, old["gamma"], None,
                       old["work"], Ep, Bp, spec.dx, spec.dt)
        new = dict(cell=res.cell, x=res.x, prev_x=res.prev_x, y=res.y,
                   z=res.z, u=res.u, gamma=res.gamma, work=res.work,
                   gh=res.gamma_half, chi=res.chi)
    else:
        cell_n, x_n, prev_x, y, z, u_n, gamma_m1 = boris_push(
            cell, x, old["y"], old["z"], u, torch.full_like(x, spec.charge),
            torch.full_like(x, spec.mass), Ep, Bp, spec.dx, spec.dt)
        # ions carry their work through
        new = dict(cell=cell_n, x=x_n, prev_x=prev_x, y=y, z=z, u=u_n,
                   gamma=1.0 + gamma_m1, chi=torch.zeros_like(x))
    new.update(ux=new["u"][:, 0], uy=new["u"][:, 1], uz=new["u"][:, 2])
    for c, v in rows.items():
        if c in new:
            v[blk, pin] = new[c].to(v.dtype)
    if out_slab is not None:
        vel = const.SPEED_OF_LIGHT * new["u"] / new["gamma"][:, None]
        out_slab.copy_(deposit_into_slab(
            out_slab, new["cell"] + spec.row_off, new["x"], new["prev_x"], q,
            vel, spec.dx, spec.dt))
        # rows past the deposit reach drop taps: losses
        lo, hi = _reach_rows(spec)
        row = cell + spec.row_off
        losses += ((q != 0.0) & ((row < lo) | (row > hi))).sum()


def misfit_fallback(spec: FusedSpec, mtab, rows: dict, weight_, eb_rows,
                    E_slab, B_slab, out_slab, losses, counts=None):
    """Push and deposit the misfit rows of the compaction table ``mtab``
    (:func:`misfit_compact`: ascending row indices, ``n`` marking an
    unused entry) after either kernel, in place.

    ``rows`` are the kernel's outputs (:func:`column_rows`,
    :func:`packed_rows`), which hold the misfit rows as they were before
    the step; their pushed values are written there, the full forms'
    prev_x and chi (and gh, in the column layout) too.  ``weight_`` is
    the weight of the ``n`` rows, ``eb_rows`` the kernel's field table
    and ``E_slab``/``B_slab`` the field slabs it was made from (the plain
    version gathers from them, in the field dtype, as opal_tpu does).
    Unless ``out_slab`` is ``None`` (``dep_skip``) the rows' taps are
    added to it, and a row whose cell before the step lies past the
    deposit reach adds one to the 0-d int64 ``losses`` instead.  Where
    ``counts`` is given, an int64 pair, the table's rows are added to
    ``counts[0]`` and, if there are any, one to ``counts[1]``.

    CPU tensors go through :func:`misfit_fallback_reference`; CUDA
    tensors launch the CUDA kernel (``csrc/fused_push_deposit.cu``,
    ``misfit_fallback_kernel``) on the current stream, once whatever the
    table holds, or raise."""
    if mtab.device.type == "cpu":
        return misfit_fallback_reference(spec, mtab, rows, weight_, E_slab,
                                         B_slab, out_slab, losses, counts)
    if mtab.device.type != "cuda":
        raise ValueError(f"no fallback kernel for device {mtab.device}")
    packed, full = rows["cell"].dtype == F32, "prev_x" in rows
    _check_fallback_args(spec, mtab, rows, weight_, eb_rows, out_slab,
                         losses, counts, packed)
    from .._build import library

    lib = library()
    nblk, block = rows["x"].shape
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    k = _scalars(spec)
    with torch.cuda.device(mtab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.opal_misfit_fallback(
            ptr(mtab), mtab.numel(), nblk * block,
            *(ptr(rows.get(c)) for c in ROW_COLS),
            ptr(weight_), ptr(eb_rows), ptr(out_slab),
            ptr(losses if out_slab is not None else None), ptr(counts),
            rows["x"].stride(0), rows["chi" if full else "x"].stride(0),
            block, spec.n_rows, spec.row_off, PAD,
            int(spec.pusher == "boris"), int(full), int(packed),
            *(k[c] for c in ("charge", "alpha", "c", "kwork", "dt",
                             "talpha", "kx", "inv_dt", "inv_dx", "crit")),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"misfit_fallback kernel failed: cudaError {rc}")
    misfit_fallback.launches[
        packed_form_name(spec) if packed else form_name(spec)] += 1


def _check_fallback_args(spec: FusedSpec, mtab, rows: dict, weight_,
                         eb_rows, out_slab, losses, counts, packed: bool):
    nblk, block = rows["x"].shape
    if block != spec.block:
        raise ValueError(f"rows of {block} a block, spec {spec.block}")
    unknown = set(rows) - set(ROW_COLS)
    if unknown:
        raise ValueError(f"no fallback column {sorted(unknown)}")
    # the C entry's strides: one for cell .. work, one for prev_x gh chi
    strides = {}
    for c, v in rows.items():
        dtype = torch.int32 if c == "cell" and not packed else F32
        if v.dtype != dtype:
            raise TypeError(f"{c} must be {dtype}, got {v.dtype}")
        if tuple(v.shape) != (nblk, block) or v.stride(1) != 1:
            raise ValueError(f"{c} must be an ({nblk}, {block}) view with "
                             f"rows at unit stride")
        strides.setdefault(c in ROW_COLS[:9], set()).add(v.stride(0))
    if any(len(s) != 1 for s in strides.values()):
        raise ValueError(f"fallback columns of mixed strides: {strides}")
    want = dict(mtab=(mtab, (mtab.numel(),), torch.int64),
                weight=(weight_, (nblk * block,), F32),
                eb_rows=(eb_rows, (spec.n_rows, 8), F32),
                losses=(losses, (), torch.int64))
    if out_slab is not None:
        want["out_slab"] = (out_slab, (spec.n_rows, 16), F32)
    if counts is not None:
        want["counts"] = (counts, (2,), torch.int64)
    for name, (t, shape, dtype) in want.items():
        if t.device != mtab.device:
            raise ValueError(f"{name} is on {t.device}, mtab on {mtab.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.numel() != math.prod(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}")


#: fallback launches of each kernel form (as :data:`FORMS` names them)
#: since the counts were last reset
misfit_fallback.launches = dict.fromkeys(FORMS, 0)
