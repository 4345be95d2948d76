"""Piecewise-monotone cubic Hermite interpolation, vectorized.

The port of ``opal_tpu/qed/pwmci.py``: tabulated CDFs (reference
``src/qed/pwmci.rs``) are evaluated and inverted in batch.  Tables are
prepared once on the host (tangents with the reference's monotonicity
clamps); a batched query names its table by a per-query index.
Inversion is a fixed-count bisection of the monotone cubic (44
halvings, far below the reference's 1e-6 relative tolerance).

f32 queries read the tables rounded to f32 (the values opal_tpu's
one-hot MXU fetch returns), f64 queries the f64 tables, both by plain
indexing.  :func:`invert_many` solves several inversions at once: on
CUDA tensors in one launch of ``csrc/pwmci_invert.cu`` (the port of
opal_tpu's ``invert``, whose unrolled bisection XLA fuses; a group of
lanes a query), on CPU
tensors through its plain version :func:`invert_many_reference`, one
stacked loop whose halvings are each one pass over all of them.
``invert_many.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

BISECTION_ITERS = 44


class PreparedTables(NamedTuple):
    """Host-precomputed Hermite fit parameters for T tables of n points:
    abscissae and ordinates, and per segment (points s, s+1) the
    monotonicity-clamped tangents at its two ends."""

    x: np.ndarray  # (T, n)
    f: np.ndarray  # (T, n)
    m0: np.ndarray  # (T, n-1) tangent at the left end of each segment
    m1: np.ndarray  # (T, n-1) tangent at the right end of each segment


def prepare(tables: np.ndarray) -> PreparedTables:
    """Per-segment tangents for a (T, n, 2) or (n, 2) table stack
    (``pwmci.rs:14-68``): the mean of the adjacent secants where they
    share a sign (else zero), then the left tangent clamped against the
    segment's secant and the right one against the next secant."""
    tables = np.asarray(tables, dtype=np.float64)
    if tables.ndim == 2:
        tables = tables[None]
    x = tables[:, :, 0]
    f = tables[:, :, 1]
    sec = (f[:, 1:] - f[:, :-1]) / (x[:, 1:] - x[:, :-1])  # (T, n-1)
    sec_l = np.concatenate([sec[:, :1], sec[:, :-1]], axis=1)
    sec_r = np.concatenate([sec[:, 1:], sec[:, -1:]], axis=1)

    m0 = np.where(sec_l * sec > 0.0, 0.5 * (sec_l + sec), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(sec != 0.0, m0 / sec, 0.0)
    m0 = np.where((sec != 0.0) & (alpha > 3.0), 3.0 * sec, m0)

    m1 = np.where(sec * sec_r > 0.0, 0.5 * (sec + sec_r), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.where(sec_r != 0.0, m1 / sec_r, 0.0)
    m1 = np.where((sec_r != 0.0) & (beta > 3.0), 3.0 * sec_r, m1)
    return PreparedTables(*(np.ascontiguousarray(a) for a in (x, f, m0, m1)))


_TENSORS: dict = {}


def tables_as(prep: PreparedTables, dtype, device) -> PreparedTables:
    """The tables as tensors of ``dtype`` on ``device`` (f64 values
    rounded once), cached per table stack, dtype and device."""
    key = (id(prep.x), dtype, str(device))
    hit = _TENSORS.get(key)
    if hit is None:
        hit = PreparedTables(*(
            torch.as_tensor(a, dtype=dtype, device=device) for a in prep
        ))
        _TENSORS[key] = hit
    return hit


def _locate(rows, q, n):
    """Segment of each query: the smallest i with q <= rows[i] gives
    segment (i-1, i), clipped to the table; ``in_range`` is False past
    its last entry."""
    idx = torch.sum(q[:, None] > rows, dim=1)
    return torch.clamp(idx - 1, 0, n - 2), idx < n


def _segment(T: PreparedTables, tidx, seg):
    """Per-query segment parameters (x0, x1, f0, f1, m0, m1)."""
    return (T.x[tidx, seg], T.x[tidx, seg + 1], T.f[tidx, seg],
            T.f[tidx, seg + 1], T.m0[tidx, seg], T.m1[tidx, seg])


def _hermite(x, x0, x1, f0, f1, m0, m1):
    """Cubic Hermite basis evaluation (``pwmci.rs:70-77``)."""
    h = x1 - x0
    t = (x - x0) / h
    omt = 1.0 - t
    h00 = (1.0 + 2.0 * t) * omt * omt
    h10 = t * omt * omt
    h01 = t * t * (3.0 - 2.0 * t)
    h11 = t * t * (t - 1.0)
    return f0 * h00 + f1 * h01 + h * (m0 * h10 + m1 * h11)


def evaluate(prep: PreparedTables, tidx, x):
    """Evaluate each query ``x`` on its table ``tidx``.  Returns
    ``(value, in_range)``; ``in_range`` is False past the table's last
    abscissa (the reference returns ``None``, ``pwmci.rs:104-106``), and
    below-range queries extrapolate the first segment."""
    T = tables_as(prep, x.dtype, x.device)
    seg, in_range = _locate(T.x[tidx], x, prep.x.shape[1])
    return _hermite(x, *_segment(T, tidx, seg)), in_range


def invert_many_reference(problems):
    """Solve ``hermite(x) == fq`` for several inversions at once, in
    plain PyTorch ops.

    ``problems`` is a list of ``(prep, tidx, fq)`` with 1-D queries of
    one dtype.  Returns a list of ``(x, in_range)``, one per problem;
    ``in_range`` is False where ``fq`` exceeds the table's last
    ordinate (``pwmci.rs:121-123``).  The segment of every query is
    found first; then one bisection of the stacked queries bounds each
    solution inside its monotone segment."""
    pars, ranges, sizes = [], [], []
    for prep, tidx, fq in problems:
        T = tables_as(prep, fq.dtype, fq.device)
        seg, in_range = _locate(T.f[tidx], fq, prep.f.shape[1])
        pars.append((fq,) + _segment(T, tidx, seg))
        ranges.append(in_range)
        sizes.append(fq.shape[0])
    fq, x0, x1, f0, f1, m0, m1 = (torch.cat(c) for c in zip(*pars))
    a, b = x0, x1
    for _ in range(BISECTION_ITERS):
        mid = 0.5 * (a + b)
        go_right = _hermite(mid, x0, x1, f0, f1, m0, m1) < fq
        a = torch.where(go_right, mid, a)
        b = torch.where(go_right, b, mid)
    sol = torch.split(0.5 * (a + b), sizes)
    return list(zip(sol, ranges))


_STACKS: dict = {}


def _stack_as(preps, dtype, device):
    """The table stacks of ``preps`` concatenated for the kernel, cached
    per stacks, dtype and device: ``(tab, meta, bases)`` with ``tab``
    (4, total) of the rows x, f, m0, m1 of every table back to back (m0
    and m1 padded to n entries a table; f64 values rounded once),
    ``meta`` (2, tables) int32 of each table's offset and n, and
    ``bases`` the first global table of each stack."""
    key = (tuple(id(p.x) for p in preps), dtype, str(device))
    hit = _STACKS.get(key)
    if hit is None:
        pad = lambda m: np.pad(m, ((0, 0), (0, 1)))
        tab = np.stack([np.concatenate([a.ravel() for a in arrs])
                        for arrs in zip(*((p.x, p.f, pad(p.m0), pad(p.m1))
                                          for p in preps))])
        ns = np.concatenate([np.full(p.x.shape[0], p.x.shape[1])
                             for p in preps])
        offs = np.cumsum(ns) - ns
        bases = np.cumsum([0] + [p.x.shape[0] for p in preps])[:-1].tolist()
        tab = torch.as_tensor(tab, dtype=dtype, device=device)
        meta = torch.as_tensor(np.stack([offs, ns]), dtype=torch.int32,
                               device=device)
        hit = _STACKS[key] = (tab, meta, bases)
    return hit


#: problems an inversion launch takes (``kMaxProblems`` of
#: ``csrc/pwmci_invert.cu``)
MAX_PROBLEMS = 8
#: lanes in flight a launch of the inversion kernel aims at: a group of
#: lanes a query, the largest power of two up to a warp whose groups stay
#: within this many lanes.  On an H100 a group of 16 was the fastest at
#: 2,370 queries and one lane at 32,718 (``kernel_variants.py --walk
#: --groups``): past ~40k lanes the rounds' extra work costs more than
#: their shorter chain saves
INVERSION_LANES = 40_960


def inversion_group(n_queries: int) -> int:
    """Lanes a query of the inversion kernel for ``n_queries`` queries: a
    warp while they are few, fewer as they grow (a group of G lanes does
    about G / L times a thread's work in L rounds)."""
    g = 32
    while g > 1 and g * n_queries > INVERSION_LANES:
        g //= 2
    return g


def invert_many(problems, group: int | None = None):
    """Solve ``hermite(x) == fq`` for several inversions at once
    (arguments and result as :func:`invert_many_reference`).  CPU
    tensors go through the plain version; CUDA tensors launch
    ``csrc/pwmci_invert.cu`` once over every problem's queries (a group
    of ``group`` lanes a query, :func:`inversion_group` of their count
    by default: its segment by ballots, then the halvings in rounds, a
    node of the bisection tree a lane), or raise.  Bitwise equal to the
    plain version."""
    fq0 = problems[0][2]
    dev, dtype = fq0.device, fq0.dtype
    if dev.type == "cpu":
        return invert_many_reference(problems)
    if dev.type != "cuda":
        raise ValueError(f"no pwmci inversion kernel for device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"queries must be f32 or f64, got {dtype}")
    if len(problems) > MAX_PROBLEMS:
        raise ValueError(f"at most {MAX_PROBLEMS} problems a call, got "
                         f"{len(problems)}")
    for _, tidx, fq in problems:
        if fq.dtype != dtype or fq.device != dev or tidx.device != dev:
            raise ValueError("every problem's queries and table indices "
                             f"must be {dtype} on {dev}")
        if fq.dim() != 1 or tidx.shape != fq.shape:
            raise ValueError("queries and table indices must be 1-D of "
                             "one length a problem")
    nq = sum(fq.shape[0] for _, _, fq in problems)
    if group is None:
        group = inversion_group(nq)
    if group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"group must be a power of two up to 32, got "
                         f"{group}")
    tab, meta, bases = _stack_as([p for p, _, _ in problems], dtype, dev)
    fqs = [fq.contiguous() for _, _, fq in problems]
    tidxs = [t.to(torch.int64).contiguous() for _, t, _ in problems]
    out = [(torch.empty_like(fq), torch.empty(fq.shape, dtype=torch.bool,
                                              device=dev)) for fq in fqs]
    if nq:
        from .._build import library

        n = len(problems)
        ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = library().opal_pwmci_invert(
                ctypes.c_void_p(tab.data_ptr()),
                ctypes.c_void_p(meta.data_ptr()), n, ptrs(fqs), ptrs(tidxs),
                ptrs([x for x, _ in out]), ptrs([ok for _, ok in out]),
                (ctypes.c_longlong * n)(*(f.shape[0] for f in fqs)),
                (ctypes.c_int * n)(*bases), tab.shape[1], meta.shape[1],
                BISECTION_ITERS, group, int(dtype == torch.float64),
                ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"pwmci_invert kernel failed: cudaError {rc}")
        invert_many.launches += 1
    return out


#: kernel launches since the count was last set to 0
invert_many.launches = 0


def invert(prep: PreparedTables, tidx, fq):
    """:func:`invert_many` of one inversion: returns ``(x, in_range)``."""
    return invert_many([(prep, tidx, fq)])[0]
