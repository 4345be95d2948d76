"""The maintenance sort and the migration of the species over the ring.

Ports of ``opal_tpu/parallel/migrate.py``'s ``sort_state``
(``:494-569``) and ``migrate_edges`` (``:679-903``) for cell-sorted
species, of their packed-layout forms ``sort_packed``,
``migrate_edges_packed`` and ``_edges_packed_full`` (``:905-1101``), of
``migrate_compact`` (``:385-491``) for the unsorted species of a
decomposed run, of ``opal_tpu/sim.py``'s ``_wrap_kill`` for the unsorted
species of a one-device or replicated-field run, and of ``insert``
(``:572-``), which places emitted photons into dead slots.  The JAX
versions move the state as one packed float matrix; here every column
keeps its own dtype on the rank (cells stay integers, and the
field-dtype ``work`` column of mixed-precision runs is never rounded to
the particle dtype, which the packed matrix does), and only the rows
that cross to a neighbour travel as one f64 matrix, which holds every
column's values exactly.

The leavers go to the ring neighbours with ``parallel.dist.Ring.shift``
(at a world of 1, to the rank itself).  Between the exchanges nothing
synchronises with the host: window positions and index tables stay
tensors, and dropped writes go to a scratch row past the window.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..grid import GridGeometry
from ..species import ParticleState
from .dist import SOLO, Ring

_BIG = 2**30


def sort_state(state: ParticleState, n_loc: int) -> ParticleState:
    """Local cell re-sort: alive rows ascending by the key
    ``2*cell + (ux > 0)``, dead rows to the tail with key ``_BIG`` and
    the in-range placeholder cell ``n_loc - 1``.

    The direction bit keeps the state strictly cell-sorted but puts
    counter-streaming populations into different kernel blocks, so each
    block drifts coherently.  ``prev_x`` and ``gamma`` are rebuilt
    (``prev_x`` as the sorted ``x``, ``gamma = sqrt(1 + |u|^2)``) and
    ``chi`` is zeroed, as the reference does."""
    dead = ~state.alive
    cell = torch.where(dead, n_loc - 1, state.cell).to(state.cell.dtype)
    skey = torch.where(
        dead, _BIG, 2 * cell + (state.ux > 0.0).to(cell.dtype)
    )
    order = torch.argsort(skey, stable=True)
    skip = {"prev_x", "gamma", "chi"}
    cols = {
        name: (cell if name == "cell" else a)[order]
        for name, a in state.columns().items()
        if name not in skip
    }
    st = dataclasses.replace(state, **cols)
    return dataclasses.replace(
        st,
        prev_x=st.x.clone(),
        gamma=torch.sqrt(1.0 + st.ux * st.ux + st.uy * st.uy + st.uz * st.uz),
        chi=torch.zeros_like(state.chi),
    )


def pack_state_window(state: ParticleState, widx) -> dict:
    """Rows ``widx`` (the head and tail windows) of every column."""
    return {name: a[widx] for name, a in state.columns().items()}


def unpack_state_window(W: dict, state: ParticleState, widx) -> ParticleState:
    """Write the window rows back into copies of the state's columns."""
    cols = {}
    for name, a in state.columns().items():
        a = a.clone()
        a[widx] = W[name]
        cols[name] = a
    return dataclasses.replace(state, **cols)


def _take(col, idx, n):
    """``col[idx]`` with rows ``idx >= n`` filled with zero (False)."""
    rows = col[torch.clamp(idx, max=n - 1)]
    ok = (idx < n).view(-1, *([1] * (col.dim() - 1)))
    return torch.where(ok, rows, torch.zeros_like(rows))


def _put(col, dest, rows):
    """``col[dest] = rows`` where ``dest < len(col)``; other rows drop
    into a scratch row past the end."""
    n = col.shape[0]
    ext = torch.cat([col, col[:1]])
    ext[torch.clamp(dest, max=n)] = rows
    return ext[:n]


def migrate_edges(state: ParticleState, geom: GridGeometry,
                  send_capacity: int, window: int, ring: Ring = SOLO):
    """Migration for a cell-sorted state: every leaver, every freed slot
    and the dead pool live in the head/tail ``window`` rows, so the
    exchange touches O(window) rows.  Leavers go to the ring neighbours
    (at a world of 1, to the rank itself): arrivals from the left take
    the lowest free head slots, arrivals from the right the lowest free
    tail slots.  Leavers outside the windows, sends beyond
    ``send_capacity`` and arrivals without a free slot are counted in
    the returned overflow, never silently dropped.

    On a non-periodic grid rows in the windows whose cell left the
    interior are deleted instead (see :func:`_edges_core`).

    Returns ``(state, overflow)`` with ``overflow`` a 0-d int64 tensor.
    """
    n = state.alive.shape[0]
    K = int(min(window, n // 2))
    cap = int(min(send_capacity, K // 2))
    dev = state.alive.device

    # tail window: just below the alive/dead boundary (sorted states
    # keep dead rows at the tail), clamped so the windows never overlap
    t0 = torch.clamp(state.alive.sum() - K // 2, K, n - K)
    ar = torch.arange(K, device=dev)
    widx = torch.cat([ar, t0 + ar])

    tot_l = torch.sum(state.alive & (state.cell < 0))
    tot_r = torch.sum(state.alive & (state.cell >= geom.n_loc))
    W = pack_state_window(state, widx)
    W, overflow = _edges_core(W, geom, ring, tot_l, tot_r, K, cap)
    return unpack_state_window(W, state, widx), overflow


def _pack_rows(rows: dict, count):
    """One f64 matrix of the rows to send: row 0 carries ``count``, the
    rows below every column of ``rows`` (bools as 0/1, integers and f32
    exactly)."""
    m = torch.cat([v.reshape(v.shape[0], -1).to(torch.float64)
                   for v in rows.values()], dim=1)
    head = torch.zeros_like(m[:1])
    head[0, 0] = count
    return torch.cat([head, m])


def _unpack_rows(m, like: dict):
    """(count, rows): the inverse of :func:`_pack_rows`, with the
    dtypes and trailing shapes of ``like``."""
    rows, i = {}, 0
    for k, v in like.items():
        w = math.prod(v.shape[1:])
        a = m[1:, i:i + w].reshape(v.shape)
        if v.dtype == torch.bool:
            a = a > 0.5
        elif not v.dtype.is_floating_point:
            a = torch.round(a)
        rows[k] = a.to(v.dtype)
        i += w
    return m[0, 0].to(torch.int64), rows


def exchange_rows(ring: Ring, send_right: dict, n_right, send_left: dict,
                  n_left):
    """The ring exchange of migrating rows: ``send_right`` (``n_right``
    valid rows) to the right neighbour and ``send_left`` to the left.
    Returns ``(from_left, n_from_left, from_right, n_from_right)``.  At
    a world of 1 the rows come back to this rank unchanged."""
    if ring.world == 1:
        return send_right, n_right, send_left, n_left
    fl, fr = ring.shift(_pack_rows(send_right, n_right),
                        _pack_rows(send_left, n_left))
    n_fl, from_left = _unpack_rows(fl, send_right)
    n_fr, from_right = _unpack_rows(fr, send_left)
    return from_left, n_fl, from_right, n_fr


def _deleted(alive, cell, geom: GridGeometry, rank: int):
    """Rows of a non-periodic grid whose global extended cell ``g =
    rank * n_loc + cell`` left the interior (``mod.rs:309-329``: the
    reference drops leavers with no neighbour); none on a periodic
    grid."""
    if geom.left_boundary == "periodic":
        return torch.zeros_like(alive)
    g = cell + rank * geom.n_loc
    return alive & ((g < geom.interior_start) | (g >= geom.interior_end))


def _edges_core(W: dict, geom: GridGeometry, ring: Ring, tot_l, tot_r,
                K: int, cap: int):
    """The edge exchange on the (2K,) head+tail window columns ``W``
    (``opal_tpu/parallel/migrate.py:739-862``).  On a non-periodic grid
    every window row whose global cell lies outside the interior (a
    boundary zone or beyond) is deleted instead of sent.
    Returns ``(W_new, overflow)``."""
    n_loc = geom.n_loc
    alive_w, cell_w = W["alive"], W["cell"]
    dev = cell_w.device
    L = 2 * K

    go_left = alive_w & (cell_w < 0)
    go_right = alive_w & (cell_w >= n_loc)
    # out-of-slab rows the windows caught, before the deletion filter:
    # tot_l/tot_r count exactly these over the whole state
    missed = (tot_l + tot_r) - torch.sum(go_left | go_right)
    deleted = _deleted(alive_w, cell_w, geom, ring.rank)
    go_left = go_left & ~deleted
    go_right = go_right & ~deleted
    gone = go_left | go_right | deleted
    free_after = ~alive_w | gone

    # (4, 2K) running counts, scanned along the contiguous dimension
    cum = torch.cumsum(
        torch.stack([go_left, go_right, gone, free_after]).long(), dim=1
    )
    n_left, n_right, nf = cum[0, -1], cum[1, -1], cum[3, -1]
    q = torch.arange(1, 2 * cap + 1, device=dev)
    lt = torch.searchsorted(cum[0], q[:cap])
    rt = torch.searchsorted(cum[1], q[:cap])
    gt = torch.searchsorted(cum[2], q)
    # per-half free-slot tables, lowest rows first: arrivals land in the
    # slots leavers just vacated, or in the pool rows nearest the alive
    # region
    nf_h = cum[3, K - 1]
    fh = torch.searchsorted(cum[3, :K], q[:cap])
    ft = K + torch.searchsorted(cum[3, K:] - nf_h, q)
    nf_t = nf - nf_h

    lane = torch.arange(cap, device=dev)
    overflow = (
        torch.clamp(n_left - cap, min=0) + torch.clamp(n_right - cap, min=0)
        + missed
    )

    send_left = {k: _take(v, lt, L) for k, v in W.items()}
    send_left["cell"] = send_left["cell"] + n_loc
    send_right = {k: _take(v, rt, L) for k, v in W.items()}
    send_right["cell"] = send_right["cell"] - n_loc
    from_left, n_arr_l, from_right, n_arr_r = exchange_rows(
        ring, send_right, torch.clamp(n_right, max=cap), send_left,
        torch.clamp(n_left, max=cap))

    # retire leavers and deleted rows: zero the row (alive False, weight
    # 0, momentum 0, cell 0) except gamma, which stays 1 so no 0/0
    # reaches a division
    W = {
        k: _put(v, gt, torch.full((), 1 if k == "gamma" else 0,
                                  dtype=v.dtype, device=dev))
        for k, v in W.items()
    }

    # insert: left arrivals take the lowest free head slots, right
    # arrivals the lowest free tail slots; left arrivals beyond the
    # head's free count spill into the tail after the right side's
    vl = lane < n_arr_l
    vr = lane < n_arr_r
    n_r_used = torch.minimum(n_arr_r, nf_t)
    ok_r = vr & (lane < n_r_used)
    dest_r = torch.where(ok_r, ft[lane], L)
    in_head = lane < nf_h
    spill = lane - nf_h + n_r_used
    ok_l = vl & (in_head | (spill < torch.clamp(nf_t, max=2 * cap)))
    dest_l = torch.where(
        ok_l,
        torch.where(in_head, fh[lane], ft[torch.clamp(spill, 0, 2 * cap - 1)]),
        L,
    )
    W = {k: _put(v, dest_l, from_left[k]) for k, v in W.items()}
    W = {k: _put(v, dest_r, from_right[k]) for k, v in W.items()}
    ins_overflow = vl.sum() + vr.sum() - ok_l.sum() - ok_r.sum()
    return W, overflow + ins_overflow


def _packed_columns(ps, rows_of):
    """The window columns of a ``PackedState`` by name (``H_COLS``,
    ``A_COLS``, ``weight`` and ``tau``): ``rows_of(a)`` takes the
    window's rows of a flat column.  ``tau`` rides at f32 as in
    opal_tpu's packed window matrix; ``alive`` is ``weight > 0``."""
    from ..ops.fused import A_COLS, H_COLS

    n = ps.weight.numel()
    flat = lambda a: a.reshape(n)
    W = {c: rows_of(flat(ps.h[:, i])) for i, c in enumerate(H_COLS)}
    W.update({c: rows_of(flat(ps.aux[:, i])) for i, c in enumerate(A_COLS)})
    W["weight"] = rows_of(flat(ps.weight))
    if ps.tau is not None:
        W["tau"] = rows_of(ps.tau).to(ps.h.dtype)
    W["alive"] = W["weight"] > 0.0
    return W


def _packed_totals(ps, geom: GridGeometry):
    """Alive rows left of and right of the local slab, over the whole
    state."""
    alive, cell = ps.weight > 0.0, ps.h[:, 0]
    return (torch.sum(alive & (cell < 0.0)),
            torch.sum(alive & (cell >= geom.n_loc)))


def migrate_edges_packed(ps, geom: GridGeometry, send_capacity: int,
                         window: int, ring: Ring = SOLO):
    """:func:`migrate_edges` on the packed layout (``ops.fused.
    PackedState``, ``opal_tpu/parallel/migrate.py:905-1014``): the head
    and tail windows are whole blocks, ``kb = max(2, ceil(window /
    block))`` of them, the tail's placed on the block that holds the
    alive/dead boundary less half a window, so the boundary lies inside
    it wherever it falls in its block.  The shared :func:`_edges_core`
    runs the exchange on their rows; retired rows get weight 0, the dead
    encoding of the layout.  A state of fewer than ``2 * kb`` blocks is
    exchanged over all its rows (:func:`_edges_packed_full`).

    Returns ``(PackedState, overflow)``."""
    nblk, _, RB, _ = ps.h.shape
    block = RB * 128
    kb = max(2, -(-window // block))
    if nblk < 2 * kb:
        return _edges_packed_full(ps, geom, send_capacity, ring)
    K = kb * block
    cap = int(min(send_capacity, K // 2))
    dev = ps.h.device

    n_alive = torch.sum(ps.weight > 0.0)
    # block-aligned tail window centred on the alive/dead boundary
    b0 = torch.clamp(torch.div(n_alive - K // 2, block, rounding_mode="floor"),
                     kb, nblk - kb)
    ab = torch.arange(kb, device=dev)
    bidx = torch.cat([ab, b0 + ab])
    ar = torch.arange(K, device=dev)
    ridx = torch.cat([ar, b0 * block + ar])
    tot_l, tot_r = _packed_totals(ps, geom)
    W, overflow = _edges_core(_packed_columns(ps, lambda a: a[ridx]), geom,
                              ring, tot_l, tot_r, K, cap)
    return _packed_put(ps, W, bidx, ridx), overflow


def _packed_put(ps, W: dict, bidx, ridx):
    """A copy of ``ps`` with the window columns ``W`` written back into
    the blocks ``bidx`` (rows ``ridx`` of ``tau``)."""
    from ..ops.fused import A_COLS, H_COLS, PackedState

    nb = bidx.shape[0]
    shape = (nb,) + tuple(ps.weight.shape[1:])
    stack = lambda names: torch.stack([W[c].view(shape) for c in names],
                                      dim=1)
    h, aux, weight = ps.h.clone(), ps.aux.clone(), ps.weight.clone()
    h[bidx] = stack(H_COLS)
    aux[bidx] = stack(A_COLS)
    weight[bidx] = W["weight"].view(shape)
    tau = ps.tau
    if tau is not None:
        tau = tau.clone()
        tau[ridx] = W["tau"].to(tau.dtype)
    return PackedState(h=h, aux=aux, weight=weight, tau=tau)


def _edges_packed_full(ps, geom: GridGeometry, send_capacity: int,
                       ring: Ring = SOLO):
    """Whole-state fallback of :func:`migrate_edges_packed`
    (``opal_tpu/parallel/migrate.py:1064-1101``) for states too small
    for block-aligned windows: head = rows [0, n/2), tail = rows [n/2,
    n), so window placement can miss nothing."""
    nblk = ps.h.shape[0]
    n = ps.weight.numel()
    K = n // 2
    cap = int(min(send_capacity, K // 2))
    dev = ps.h.device
    tot_l, tot_r = _packed_totals(ps, geom)
    W, overflow = _edges_core(_packed_columns(ps, lambda a: a), geom,
                              ring, tot_l, tot_r, K, cap)
    return _packed_put(ps, W, torch.arange(nblk, device=dev),
                       torch.arange(n, device=dev)), overflow


def sort_packed(ps, n_loc: int):
    """:func:`sort_state` on the packed layout
    (``opal_tpu/parallel/migrate.py:1017-1061``): alive rows ascending by
    ``2*cell + (ux > 0)``, dead rows (weight <= 0) to the tail under the
    placeholder cell ``n_loc - 1``; gamma is rebuilt, prev_x set to x,
    chi zeroed and gh reset, as :func:`sort_state` does, and tau rides
    at the hot matrix's f32 as in opal_tpu.  Equal keys keep their
    order (a stable sort).  Returns ``(PackedState, cell)``, ``cell`` the
    sorted f32 cell column."""
    from ..ops.fused import PackedState

    nblk, CH, RB, _ = ps.h.shape
    n = nblk * RB * 128
    flat = lambda a: a.reshape(n)
    cell, x, y, z, ux, uy, uz, _, work = (flat(ps.h[:, c])
                                          for c in range(CH))
    weight = flat(ps.weight)
    dead = weight <= 0.0
    cell = torch.where(dead, float(n_loc - 1), cell)
    skey = torch.where(
        dead, _BIG,
        2 * cell.to(torch.int32) + (ux > 0.0).to(torch.int32))
    order = torch.argsort(skey, stable=True)
    cell, x, y, z, ux, uy, uz, work, weight = (
        a[order] for a in (cell, x, y, z, ux, uy, uz, work, weight))
    gamma = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    to4 = lambda a: a.view(nblk, RB, 128)
    h = torch.stack([to4(c) for c in (cell, x, y, z, ux, uy, uz, gamma,
                                      work)], dim=1)
    zero = torch.zeros_like(to4(x))
    aux = torch.stack([to4(x), zero, torch.ones_like(zero), zero], dim=1)
    tau = ps.tau
    if tau is not None:
        tau = tau[order].to(ps.h.dtype).to(tau.dtype)
    return PackedState(h=h, aux=aux, weight=to4(weight), tau=tau), cell


def migrate_compact(state: ParticleState, geom: GridGeometry,
                    send_capacity: int, ring: Ring = SOLO):
    """Migration of an unsorted species over the ring
    (``opal_tpu/parallel/migrate.py:385-491``): leavers and free slots
    are found with one cumulative sum of four masks and its
    ``searchsorted`` index tables, so the data that moves is
    ``send_capacity`` rows a side.  On a non-periodic grid a row whose
    global cell left the interior is deleted instead of sent.  Leavers
    are retired (alive False, cell, weight and momentum 0) and arrivals
    from both sides take the free slots in ascending order, the slots
    just vacated included.

    Returns ``(state, overflow)``: sends beyond the capacity and
    arrivals without a free slot, a 0-d int64 tensor."""
    n_loc = geom.n_loc
    n = state.alive.shape[0]
    cap = int(min(send_capacity, n // 2))
    dev = state.alive.device
    alive, cell = state.alive, state.cell

    deleted = _deleted(alive, cell, geom, ring.rank)
    go_left = alive & (cell < 0) & ~deleted
    go_right = alive & (cell >= n_loc) & ~deleted
    gone = go_left | go_right | deleted
    dead_after = ~alive | gone
    cum = torch.cumsum(
        torch.stack([go_left, go_right, gone, dead_after]).long(), dim=1)
    n_left, n_right, n_free = cum[0, -1], cum[1, -1], cum[3, -1]
    q = torch.arange(1, 2 * cap + 1, device=dev)
    lt = torch.searchsorted(cum[0], q[:cap])
    rt = torch.searchsorted(cum[1], q[:cap])
    gt = torch.searchsorted(cum[2], q)
    ft = torch.searchsorted(cum[3], q)
    lane = torch.arange(cap, device=dev)
    overflow = (torch.clamp(n_left - cap, min=0)
                + torch.clamp(n_right - cap, min=0))

    cols = state.columns()
    send_left = {k: _take(v, lt, n) for k, v in cols.items()}
    send_left["cell"] = send_left["cell"] + n_loc
    send_right = {k: _take(v, rt, n) for k, v in cols.items()}
    send_right["cell"] = send_right["cell"] - n_loc
    from_left, n_arr_l, from_right, n_arr_r = exchange_rows(
        ring, send_right, torch.clamp(n_right, max=cap), send_left,
        torch.clamp(n_left, max=cap))

    # retire leavers and deleted rows: alive False and the fields later
    # passes read through dead rows zeroed (cell in range, weight and
    # momentum 0: inert in the push, the deposit and the energy sums)
    cols = {k: _put(v, gt, torch.zeros((), dtype=v.dtype, device=dev))
            if k in ("alive", "cell", "weight", "ux", "uy", "uz") else v
            for k, v in cols.items()}
    # arrivals land in free slots, the slots just vacated included
    rv = torch.cat([lane < n_arr_l, lane < n_arr_r])
    rrank = torch.cumsum(rv.long(), dim=0) - 1
    ok = rv & (rrank < n_free) & (rrank < 2 * cap)
    dest = torch.where(ok, ft[torch.clamp(rrank, 0, 2 * cap - 1)], n)
    cols = {k: _put(v, dest, torch.cat([from_left[k], from_right[k]]))
            for k, v in cols.items()}
    ins_overflow = rv.sum() - ok.sum()
    return dataclasses.replace(state, **cols), overflow + ins_overflow


def wrap_kill(state: ParticleState, geom: GridGeometry):
    """Migration of an unsorted species of a one-device or
    replicated-field run (``opal_tpu/sim.py::Simulation._wrap_kill``):
    boundary crossings wrap in place on a periodic grid; on a
    non-periodic grid a row whose cell left the interior is deleted
    (alive False, weight, momentum and cell 0), as the reference drops
    leavers at the global edge (``mod.rs:309-329``).  No rows move.

    Returns ``(state, overflow)``; nothing can overflow, so it is 0."""
    n_loc = geom.n_loc
    zero = torch.zeros((), dtype=torch.int64, device=state.cell.device)
    if geom.left_boundary == "periodic":
        cell = (
            state.cell
            + torch.where(state.cell < 0, n_loc, 0)
            - torch.where(state.cell >= n_loc, n_loc, 0)
        ).to(state.cell.dtype)
        return dataclasses.replace(state, cell=cell), zero
    out = _deleted(state.alive, state.cell, geom, 0)
    cols = {k: torch.where(out, 0, getattr(state, k)).to(getattr(state, k).dtype)
            for k in ("weight", "ux", "uy", "uz", "cell")}
    return dataclasses.replace(state, alive=state.alive & ~out, **cols), zero


def wrap_kill_packed(ps, geom: GridGeometry):
    """:func:`wrap_kill` on the packed layout (``opal_tpu/sim.py:
    843-865``), for the fused species of a replicated-field run: the f32
    cell column wraps in place on a periodic grid, and on a non-periodic
    grid a row whose cell left the interior gets weight 0, the dead
    encoding of the layout.  A wrapped row is a kernel misfit until the
    next maintenance sort.  Returns ``(PackedState, 0)``."""
    from ..ops.fused import PackedState

    n_loc = geom.n_loc
    zero = torch.zeros((), dtype=torch.int64, device=ps.h.device)
    cell = ps.h[:, 0]
    if geom.left_boundary == "periodic":
        h = ps.h.clone()
        h[:, 0] = (cell + torch.where(cell < 0.0, float(n_loc), 0.0)
                   - torch.where(cell >= n_loc, float(n_loc), 0.0))
        return PackedState(h=h, aux=ps.aux, weight=ps.weight,
                           tau=ps.tau), zero
    out = (cell < geom.interior_start) | (cell >= geom.interior_end)
    return PackedState(h=ps.h, aux=ps.aux,
                       weight=torch.where(out, 0.0, ps.weight),
                       tau=ps.tau), zero


def insert(state: ParticleState, buf: ParticleState, valid, width=None,
           hi=None):
    """Scatter the ``valid`` rows of ``buf`` into dead slots of
    ``state`` (``opal_tpu/parallel/migrate.py:572-``).

    The slots are those opal_tpu hands out for an insert of ``width``
    rows (default ``len(valid)``): while the buffer has a contiguous dead
    tail of at least ``width`` rows past its high-water mark ``hi`` (one
    past the last alive row; read from the device when not given), the
    consecutive rows ``hi, hi+1, ...``; otherwise the first dead slots
    in ascending order.  Valid rows take them in order.  Returns
    ``(state, overflow)`` with ``overflow`` the valid rows that found no
    free slot (0-d int64)."""
    n = state.alive.shape[0]
    m = len(valid) if width is None else int(width)
    k = valid.shape[0]
    dev = valid.device
    if k == 0:
        return state, torch.zeros((), dtype=torch.int64, device=dev)
    if m < n:
        if hi is None:
            rows = torch.arange(n, device=dev)
            hi = int(torch.max(torch.where(state.alive, rows, -1))) + 1
        if hi + m <= n:
            slots = hi + torch.arange(k, device=dev)
        else:
            slots = _dead_slots(state.alive, k)
    else:
        slots = _dead_slots(state.alive, k)
    rank = torch.cumsum(valid.long(), dim=0) - 1
    in_cap = valid & (rank < m)
    dest = torch.where(in_cap, slots[torch.clamp(rank, 0, k - 1)], n)
    ok = in_cap & (dest < n)
    dest = torch.where(ok, dest, n)
    overflow = valid.sum() - ok.sum()
    cols = {}
    for name, a in state.columns().items():
        b = ok if name == "alive" else getattr(buf, name)
        cols[name] = _put(a, dest, b.to(a.dtype))
    return dataclasses.replace(state, **cols), overflow


def _dead_slots(alive, k):
    """The first ``k`` dead rows, ascending; ``len(alive)`` past the
    dead count (``ops.fused.misfit_compact`` of the dead mask)."""
    cum = torch.cumsum((~alive).long(), dim=0)
    q = torch.arange(1, k + 1, device=alive.device)
    return torch.searchsorted(cum, q)
