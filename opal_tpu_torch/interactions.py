"""QED interactions coupling particle populations
(``opal_tpu/interactions.py``; reference
``src/particle/interactions.rs``).

Photon emission (``emit_radiation``, ``opal_tpu/interactions.py:56-295``;
reference ``interactions.rs:45-107``, ``electron.rs:208-251``): every
electron whose optical depth fell below zero samples the quantum (or
classical) synchrotron spectrum, recoils, draws a new optical depth,
and its photon goes into a dead slot of the photon buffer.  As in
opal_tpu, at most ``emission_active_capacity`` emitters a step are
served, in buffer order (the rest keep their negative depth and emit
later, counted as deferred), and at most ``emission_insert_capacity``
photons a step are inserted (the emitters beyond are deferred too,
without recoil).  The sampler runs on the emitters alone: one host read
a step gives their count (and the photon buffer's high-water mark), and
a step without emitters launches nothing more.

Photon absorption and stimulated emission (``absorb``,
``opal_tpu/interactions.py:321-1096``; reference
``interactions.rs:145-340``): each photon walks the electrons of its
cell, at most ``absorption_candidates`` of them, in blocks of
``absorption_block``, and the first crossing of either optical depth
wins.  The walk runs on the photons that can pair alone (one host read
a step gives their count), and the event space on the events alone.

The random numbers come from a ``torch.Generator``, or, to replay
opal_tpu's draws, from a dict of its per-step arrays: emitter j of the
compacted table takes draw j, and the walk's photon in working slot i
(its rank in opal_tpu's active table, or its buffer row without the
compaction) takes draw i, as there.

In the replicated-field mode every rank holds the whole grid and an
equal-count shard of the particles, so a photon's cell-mates sit on
every rank: ``absorb(..., replicated=True)`` walks a per-cell candidate
table gathered from all the ranks of its ``Ring`` and routes each kick
back to the rank that holds the electron
(``opal_tpu/interactions.py:539-556, 983-1006``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import constants as const
from . import trace
from .grid import HALO
from .ops.absorb_walk import absorb_walk, cell_envelopes
from .ops.fused import misfit_compact
from .parallel.dist import SOLO, Ring
from .parallel.migrate import _put, insert
from .qed import emission
from .species import ParticleState
from .vec3 import orthogonal, rotate_around


#: the per-cell candidate table of the absorption walk, a persistent
#: (cells, ceil(K/B)*B, 7) tensor, up to this many bytes; above it the
#: walk gathers each pass's rows per photon (``opal_tpu/interactions.py:
#: 44, 503-545``).  The replicated mode's gathered table (8 columns, of
#: every rank) has no such fallback: above it ``absorb`` raises
CAND_TABLE_MAX_BYTES = 256 * 2**20
#: photons whose chi over energy is below this never pair
#: (``interactions.rs:176-192``)
PHOTON_E_ECRIT_CUTOFF = 1.0e-8


def _tiny(dtype) -> float:
    """Guard epsilon by dtype: 1e-300 underflows to 0.0 in f32."""
    return 1.0e-37 if dtype == torch.float32 else 1.0e-300


def _draw(rng, name, index, dtype):
    """Draws ``name`` for the rows whose draw index is ``index``: from
    opal_tpu's arrays (a dict: ``r1 r2 r3`` uniform and ``tau``
    exponential over the sampler's rows, ``tau_abs tau_st`` exponential
    over the insert's), or fresh from the generator ``rng``."""
    if isinstance(rng, dict):
        return torch.tensor(rng[name], dtype=dtype, device=index.device)[index]
    n = index.shape[0]
    if name in ("r1", "r2", "r3"):
        return torch.rand(n, generator=rng, dtype=dtype, device=index.device)
    return torch.empty(n, dtype=dtype, device=index.device).exponential_(
        generator=rng)


def emission_widths(options, n: int):
    """(m, mi): the sampler's rows (the active capacity, or the whole
    electron buffer of ``n`` rows without compaction) and the insert's
    rows (the insert capacity when it bounds the sampler's, else m) of
    opal_tpu's emission pass: the lengths of its draw arrays."""
    EC = int(options.emission_active_capacity or 0)
    m = EC if 0 < EC < n else n
    EIC = int(options.emission_insert_capacity or 0)
    if EIC < 0:
        EIC = max(16384, m // 8)
    return m, (EIC if 0 < EIC < m else m)


def emit_radiation(sim, species, t, rng):
    """Emission pass over the electron population; returns ``(species,
    lost, deferred)`` (0-d int64 tensors): ``lost`` counts photons that
    found no free buffer slot, ``deferred`` the emitters beyond the
    active or the insert capacity (a delay, not a loss).  ``sim``
    supplies ``options`` and ``geom``; ``t`` is the step's start time,
    the photons' birth time."""
    opt = sim.options
    e, ph = species["electron"], species["photon"]
    n = e.alive.shape[0]
    dev = e.x.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    emits = e.alive & (e.tau < 0.0)
    m, mi = emission_widths(opt, n)
    compact = m < n

    # the one host read of the step
    n_ph = ph.alive.shape[0]
    ph_top = torch.max(torch.where(
        ph.alive, torch.arange(n_ph, device=dev), -1)) + 1
    total, ph_hi = trace.host_read(torch.stack([emits.sum(), ph_top]))
    if total == 0:
        return species, zero, zero
    n_w = min(total, m)
    eovf = total - n_w
    idx, _ = misfit_compact(emits.to(torch.float32), n_w)
    # the draw index of each emitter: its row of the compacted table, or
    # its buffer row without compaction
    didx = torch.arange(n_w, device=dev) if compact else idx

    dtype = e.x.dtype
    r1, r2, r3 = (_draw(rng, k, didx, dtype) for k in ("r1", "r2", "r3"))
    chi_w, gamma_w = e.chi[idx], e.gamma[idx]
    sampler = emission.sample if opt.radiation_reaction \
        else emission.classical_sample
    with trace.span(trace.EMIT_SAMPLE):
        omega_mc2, theta, cphi = sampler(chi_w, gamma_w, r1, r2, r3)

    u_w = torch.stack([e.ux[idx], e.uy[idx], e.uz[idx]], dim=1)
    u_norm = torch.sqrt(torch.clamp(torch.sum(u_w * u_w, dim=-1),
                                    min=_tiny(u_w.dtype)))
    parallel = u_w / u_norm[:, None]
    perp = rotate_around(orthogonal(parallel), parallel, cphi)
    if opt.beaming:
        k_ph = omega_mc2[:, None] * (
            torch.cos(theta)[:, None] * parallel
            + torch.sin(theta)[:, None] * perp)
    else:
        k_ph = omega_mc2[:, None] * parallel
    formation_length = (
        2.0 * gamma_w ** 2 * theta * const.SPEED_OF_LIGHT
        * const.COMPTON_TIME / torch.clamp(chi_w, min=_tiny(chi_w.dtype))
    )

    # ---- filters (interactions.rs:74-97); a filtered photon's emitter
    # still recoils, the photon is just not tracked ---------------------
    k0 = torch.sqrt(torch.clamp(torch.sum(k_ph * k_ph, dim=-1),
                                min=_tiny(k_ph.dtype)))
    keep = torch.ones(n_w, dtype=torch.bool, device=dev)
    if opt.photon_energy_min is not None:
        keep = keep & (k0 * const.ELECTRON_MASS_MEV >= opt.photon_energy_min)
    if opt.photon_angle_max is not None:
        angle = torch.arccos(torch.clamp(-k_ph[:, 0] / k0, -1.0, 1.0))
        keep = keep & (angle <= opt.photon_angle_max)
    if opt.max_formation_length is not None:
        keep = keep & (formation_length < opt.max_formation_length)

    # ---- insert-bound deferral: kept photons past the insert capacity
    # leave their emitter untouched (negative depth, no recoil) --------
    ins_rank = torch.cumsum(keep.long(), dim=0) - 1
    if mi < m:
        defer = keep & (ins_rank >= mi)
        keep = keep & ~defer
        n_defer = defer.sum()
        apply = ~defer
    else:
        n_defer = zero
        apply = torch.ones_like(keep)

    # ---- electron update: new optical depth and recoil ---------------
    tau_draw = _draw(rng, "tau", didx, dtype)
    if opt.radiation_reaction:
        u_new = u_w - k_ph
        gamma_new = torch.sqrt(1.0 + torch.sum(u_new * u_new, dim=-1))
        chi_new = chi_w * gamma_new / torch.clamp(
            gamma_w, min=_tiny(gamma_w.dtype))
    else:
        u_new, gamma_new, chi_new = u_w, gamma_w, chi_w
    dest = torch.where(apply, idx, n)
    new = dict(ux=u_new[:, 0], uy=u_new[:, 1], uz=u_new[:, 2],
               gamma=gamma_new, chi=chi_new, tau=tau_draw)
    e = dataclasses.replace(e, **{
        k: _put(getattr(e, k), dest, v.to(getattr(e, k).dtype))
        for k, v in new.items()})

    # ---- photon construction (photon.rs:95-116) and insert -----------
    x_w = e.x[idx]
    prev_x = x_w - const.SPEED_OF_LIGHT * k_ph[:, 0] * opt.dt / (
        torch.clamp(k0, min=_tiny(k0.dtype)) * sim.geom.dx)
    # a kept photon's draw index: its rank among the kept ones when the
    # insert is compacted, else its emitter's
    pidx = torch.clamp(ins_rank, 0, mi - 1) if mi < m else didx
    zeros = torch.zeros(n_w, dtype=dtype, device=dev)
    buf = ParticleState(
        cell=e.cell[idx], x=x_w, prev_x=prev_x.to(dtype), y=zeros,
        z=zeros, weight=e.weight[idx],
        ux=k_ph[:, 0].to(dtype), uy=k_ph[:, 1].to(dtype),
        uz=k_ph[:, 2].to(dtype), gamma=k0.to(dtype), chi=zeros, tau=None,
        tau_abs=_draw(rng, "tau_abs", pidx, dtype),
        tau_st=_draw(rng, "tau_st", pidx, dtype), work=None,
        birth_time=torch.full((n_w,), t, dtype=dtype, device=dev),
        alive=keep,
        # unpolarized, basis = [k, k] placeholder (photon.rs:107-108)
        pol=torch.zeros((n_w, 4), dtype=dtype, device=dev),
        basis=torch.cat([k_ph, k_ph], dim=1).to(dtype),
    )
    ph, lost = insert(ph, buf, keep, width=mi, hi=ph_hi)
    return ({**species, "electron": e, "photon": ph}, lost,
            eovf + n_defer)



def _abs_draw(rng, name, index, dtype, lead=()):
    """Absorption draws ``name`` for the rows whose draw index is
    ``index``: from opal_tpu's arrays (a dict: ``abs_r`` (passes, nw)
    uniform, ``abs_exp`` (passes, 2, nw), ``abs_tau_abs`` and
    ``abs_tau_st`` (event capacity,) exponential, over the working
    slots or the event slots), or fresh from the generator ``rng``.
    ``lead`` is the array's leading index (the pass)."""
    dev = index.device
    if isinstance(rng, dict):
        a = torch.tensor(rng[name][lead], dtype=dtype, device=dev)
        return a[..., index]
    n = index.shape[0]
    if name == "abs_r":
        return torch.rand(n, generator=rng, dtype=dtype, device=dev)
    shape = (2, n) if name == "abs_exp" else (n,)
    return torch.empty(shape, dtype=dtype, device=dev).exponential_(
        generator=rng)


def _abs_rotation(rng, n_ph, device):
    """The scan origin of the active-set compaction: opal_tpu's
    ``randint(fold_in(key, 3_000_017), (), 0, n_ph)`` (dict key
    ``abs_rot``), or a generator draw; a 0-d device tensor."""
    if isinstance(rng, dict):
        return torch.tensor(int(rng["abs_rot"]), device=device)
    return torch.randint(0, n_ph, (), generator=rng, device=device)


def absorb_widths(options, n_e: int, n_ph: int, world: int = 1):
    """(nb, nw, EVC): the walk's passes, its working length (the active
    capacity, or the whole photon buffer without the compaction) and the
    event capacity of opal_tpu's absorption pass: the shapes of its draw
    arrays.  In the replicated mode over ``world`` ranks each rank takes
    ``ceil(K / world)`` candidates a cell and the walk makes ``world``
    times its passes (``opal_tpu/interactions.py:359-363, 547-556``)."""
    K = min(options.absorption_candidates, n_e)
    if world > 1:
        K = max(1, -(-K // world))
    B = max(1, min(options.absorption_block, K))
    A = int(options.absorption_active_capacity or 0)
    nw = A if 0 < A < n_ph else n_ph
    evc = min(int(options.absorption_event_capacity or 0) or 4096, nw)
    return world * -(-K // B), nw, evc


def absorb(sim, species, t, rng, presorted=False, bracketed=False,
           axis_index: int = 0, ring: Ring = SOLO, replicated=False):
    """Photon absorption and stimulated emission pass
    (``opal_tpu/interactions.py:321-1096``); on a decomposed grid it
    pairs within the rank's slab, whose index ``axis_index`` places the
    event records' x.  With ``replicated`` (the replicated-field mode:
    every rank of ``ring`` holds the whole grid and a shard of the
    particles) it pairs across the ranks: each rank contributes
    ``ceil(K / world)`` candidates a cell to a gathered table, and each
    kick goes to the rank that holds its electron.

    The electrons are viewed by cell: sorted every step, already sorted
    (``presorted``: alive rows cell-ascending, as after the maintenance
    sort), or, on the nearly sorted state of the fused path
    (``bracketed``), bracketed by monotone envelopes of their cells, each
    candidate masked by exact cell equality.  Each photon walks the first
    ``absorption_candidates`` electrons of its cell (over the halo-
    extended cells) in passes of ``absorption_block``; within a pass the
    optical-depth decrements are cumulative sums, and the first crossing
    of either depth is the photon's event (absorbed when only its
    absorption depth crosses there, stimulated when only the other, and
    by a draw weighted by the two probabilities when both do).  Absorbed
    photons die and kick their electron by (w_ph / w_e) k; a stimulated
    event kicks it by -k and appends a copy of the photon with the
    electron's weight, fresh depths and the seed's polarization.

    Returns ``(species, lost, deferred)``, or ``(species, lost, deferred,
    events)`` with either extra-output feature on: ``lost`` counts the
    stimulated copies that found no free slot; ``deferred`` the photon-
    steps delayed (photons past the active capacity, photons whose cell
    holds more than the candidate bound, events past the event
    capacity, whose depths are restored); ``events`` is ``(rec, want)``,
    the (rows, 14) records ``x t birth_time chi_g k0 k1 k2 k3 chi_e p0
    p1 p2 p3 kind`` (kind 1 absorbed, 2 stimulated) of the walked
    photons in working order and the mask of those to log."""
    opt, geom = sim.options, sim.geom
    e, ph = species["electron"], species["photon"]
    n_e, n_ph = e.alive.shape[0], ph.alive.shape[0]
    dev = e.x.device
    dtype = e.x.dtype
    tiny = _tiny(dtype)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    world = ring.world if replicated else 1
    # the candidates a cell of this rank (of every rank when replicated)
    K = min(opt.absorption_candidates, n_e)
    if replicated:
        K = max(1, -(-K // world))
    B = max(1, min(opt.absorption_block, K))
    nb_loc = -(-K // B)
    nb, nw_len, EVC = absorb_widths(opt, n_e, n_ph, world)
    want_events = (opt.extra_absorption_output
                   or opt.extra_stimulated_emission_output)
    # pairing over the halo-extended cells [-HALO, n_loc + HALO): rows
    # that roam past the domain between exchanges keep their partners
    pad = HALO
    n_cells = geom.n_loc + 2 * pad
    cells = torch.arange(n_cells, dtype=torch.int32, device=dev)

    # the per-cell candidate table's columns [p4 | chi_e | w_e | ok], and
    # when replicated the candidate's buffer row on its rank
    CC = 8 if replicated else 7
    isz = e.x.element_size()
    use_cell_table = (n_cells * nb_loc * B * CC * world * isz
                      <= CAND_TABLE_MAX_BYTES)
    if replicated and not use_cell_table:
        # raised before any collective, so every rank raises alike
        raise ValueError(
            "replicated absorption needs the per-cell candidate table "
            f"to fit {CAND_TABLE_MAX_BYTES >> 20} MB after the "
            f"all-gather (n_cells={n_cells}, K/device={K}, "
            f"devices={world}): lower tpu: absorption_candidates")

    # ---- the electrons by cell ----------------------------------------
    with trace.span(trace.ABSORB_SEGMENTS):
        cols = (e.gamma, e.ux, e.uy, e.uz, e.chi, e.weight)
        order = cell_mask = None  # the identity; no per-candidate cell test
        if bracketed:
            # dead rows keep in-range placeholder cells and weight 0: an
            # admitted dead candidate has zero probability
            cell_mask = (e.cell + pad).to(torch.int32)
            lo_env, hi_env = cell_envelopes(cell_mask)
            seg_start = torch.searchsorted(lo_env, cells)
            seg_end = torch.searchsorted(hi_env, cells, right=True)
        else:
            key = torch.where(e.alive, e.cell + pad, n_cells).to(torch.int32)
            if not presorted:
                order = torch.argsort(key, stable=True)
                key = key[order]
                cols = tuple(c[order] for c in cols)
            seg_start = torch.searchsorted(key, cells)
            seg_end = torch.searchsorted(key, cells, right=True)
        seg_len = seg_end - seg_start
        # (n_e, 6) [p4 | chi | w], with the row's cell when bracketed
        e_table = torch.stack(
            [c.to(dtype) for c in cols]
            + ([cell_mask.to(dtype)] if cell_mask is not None else []), dim=-1)
        unsort = (lambda i: i) if order is None else (lambda i: order[i])

    # ---- which photons can pair (interactions.rs:176-192) -------------
    with trace.span(trace.ABSORB_WORKING_SET):
        energy = ph.gamma * const.ELECTRON_MASS_MEV
        active = ph.alive & (
            ph.chi * const.ELECTRON_MASS_MEV / torch.clamp(energy, min=tiny)
            >= PHOTON_E_ECRIT_CUTOFF)
        if opt.absorption_stop_time is not None:
            active = active & (t - ph.birth_time <= opt.absorption_stop_time)
        if opt.max_displacement is not None:
            active = active & (torch.hypot(ph.y, ph.z) <= opt.max_displacement)
        any_active = True
        if replicated:
            # pairing sees the cells' global lengths (a photon whose mates
            # are all on other ranks still walks, and is deferred past the
            # bound): one sum over the ranks, which also counts the active
            # photons of every rank.  With none, no rank walks or gathers
            both = ring.psum(torch.cat([seg_len, active.sum()[None]]))
            seg_len = both[:-1]
            # the host read before the walk
            any_active = trace.host_read(both[-1]) > 0
        pcell = torch.clamp(ph.cell.long() + pad, 0, n_cells - 1)
        # the cell-mate screen: photons inside the occupied cell range (a
        # superset of those with cell-mates; the rest have an empty segment
        # and can never fire)
        occ = seg_len > 0
        cmin = torch.min(torch.where(occ, cells, n_cells))
        cmax = torch.max(torch.where(occ, cells, -1))
        has_mates = active & (pcell >= cmin) & (pcell <= cmax)

        # ---- the working set ----------------------------------------------
        compact = nw_len < n_ph
        if compact:
            # the first A photons with cell-mates from a random scan origin,
            # so that under sustained overflow none starves
            rot = _abs_rotation(rng, n_ph, dev)
            rows_rot = (torch.arange(n_ph, device=dev) + rot) % n_ph
            R = torch.cumsum(has_mates[rows_rot].long(), dim=0)
            # the one host read before the walk
            total = trace.host_read(R[-1])
            n_w = min(total, nw_len)
            aovf = total - n_w
            sel = torch.searchsorted(R, torch.arange(1, n_w + 1, device=dev))
            # the walked photons in buffer order
            idx = torch.sort((sel + rot) % n_ph).values
            didx = torch.arange(n_w, device=dev)
        else:
            # every photon with cell-mates, in buffer order: the count is
            # the one host read before the walk
            n_w, aovf = trace.host_read(has_mates.sum()), 0
            idx = (misfit_compact(has_mates.to(torch.float32), n_w)[0] if n_w
                   else torch.zeros(0, dtype=torch.int64, device=dev))
            didx = idx
        # a rank of the replicated mode without walkers still joins the
        # table's and the kicks' gathers while another rank walks
        if n_w == 0 and not (replicated and any_active):
            res = (species, zero, zero + aovf)
            return res + ((torch.zeros((0, 14), dtype=dtype, device=dev),
                           torch.zeros(0, dtype=torch.bool, device=dev)),
                          ) if want_events else res

        k4_ph = torch.stack([ph.gamma, ph.ux, ph.uy, ph.uz], dim=1)
        w_k4 = k4_ph[idx].to(dtype)
        w_chi = ph.chi[idx].to(dtype)
        w_tau_abs0, w_tau_st0 = ph.tau_abs[idx], ph.tau_st[idx]
        w_weight = ph.weight[idx]
        w_cell = pcell[idx]
        w_start = seg_start[w_cell]
        # the global length when replicated
        w_end = w_start + seg_len[w_cell]
        # photons whose cell holds more than K electrons (of every rank)
        # walk only those: a delay
        overflow_pairs = torch.sum(w_end - w_start > K * world)

    # ---- the per-cell candidate table: every photon of a cell walks
    # the same first K rows of its segment (of each rank) ----------------
    with trace.span(trace.ABSORB_TABLE):
        if use_cell_table:
            karr = torch.arange(nb_loc * B, device=dev)
            cand_idx = torch.clamp(seg_start[:, None] + karr[None, :], 0,
                                   n_e - 1)
            cand_ok = (karr[None, :] < K) & (
                seg_start[:, None] + karr[None, :] < seg_end[:, None])
            rows = e_table[cand_idx]
            if bracketed:
                # neighbour-cell rows inside a bracket are masked exactly
                cand_ok = cand_ok & (rows[..., 6] == cells[:, None].to(dtype))
            parts = [rows[..., :5],
                     torch.where(cand_ok, rows[..., 5], 0.0)[..., None],
                     cand_ok.to(dtype)[..., None]]
            if replicated:
                # the candidate's buffer row on its rank, where its kick
                # lands (exact in f32 below 2**24 rows, as in opal_tpu)
                parts.append(unsort(cand_idx).to(dtype)[..., None])
            cand = torch.cat(parts, dim=-1)  # (n_cells, nb_loc*B, CC)
            if replicated:
                # every rank's table, rank-major along the candidates: pass
                # bi serves rank bi // nb_loc
                cand = ring.all_gather(cand).transpose(0, 1).reshape(
                    n_cells, nb * B, CC)

    cdt_dx = const.SPEED_OF_LIGHT * opt.dt / geom.dx
    with trace.span(trace.ABSORB_DRAWS):
        # every pass's draws before the walk, in the order the pass-by-
        # pass loop drew them (r, then the two exponentials, pass by
        # pass): the generator's stream and opal_tpu's replayed arrays
        # line up as before
        draws = [(_abs_draw(rng, "abs_r", didx, dtype, bi),
                  _abs_draw(rng, "abs_exp", didx, dtype, bi))
                 for bi in range(nb if n_w else 0)]
        r_all = (torch.stack([d[0] for d in draws]) if draws
                 else torch.empty((nb, 0), dtype=dtype, device=dev))
        exp_all = (torch.stack([d[1] for d in draws]) if draws
                   else torch.empty((nb, 2, 0), dtype=dtype, device=dev))
    with trace.span(trace.ABSORB_WALK):
        source = (dict(cand=cand) if use_cell_table else dict(
            e_table=e_table, end=w_end, K=K, bracketed=bracketed))
        # the walk: every pass's cross sections, running sums, first
        # crossings, event choices and depth updates
        walk = absorb_walk(
            w_k4, w_chi, w_tau_abs0, w_tau_st0, w_cell, w_start, r_all,
            exp_all, B, cdt_dx, opt.stimulated_emission, n_e,
            nb_loc=nb_loc if replicated else 0,
            p4chi=replicated and bool(want_events), **source)
        tau_abs, tau_st, ev_kind, ev_idx = walk[:4]
        ev_dev, ev_we, ev_p4chi = walk[5:]

    # ---- the event capacity: events past EVC are cancelled (depths
    # restored; the photon walks again next step), a counted delay ------
    ev_live = ev_kind > 0
    ev_over = ev_live & (torch.cumsum(ev_live.long(), dim=0) - 1 >= EVC)
    tau_abs = torch.where(ev_over, w_tau_abs0, tau_abs)
    tau_st = torch.where(ev_over, w_tau_st0, tau_st)
    ev_kind = torch.where(ev_over, 0, ev_kind)
    n_ev_deferred = ev_over.sum()
    absorbed, stimulated = ev_kind == 1, ev_kind == 2
    deferred = overflow_pairs + aovf + n_ev_deferred

    events = None
    if want_events:
        want = torch.zeros_like(absorbed)
        if opt.extra_absorption_output:
            want = want | absorbed
        if opt.extra_stimulated_emission_output:
            want = want | stimulated
        # the replicated mode's cells are global
        ai = 0 if replicated else axis_index
        x_glob = geom.xmin + (
            (ai * geom.n_loc + ph.cell[idx] - geom.interior_start).to(dtype)
            + ph.x[idx]
        ) * geom.dx
        if replicated:
            # the partner's columns rode the walk
            chi_ev, p4_ev = ev_p4chi[:, 4:5], ev_p4chi[:, :4]
        else:
            er = unsort(ev_idx)  # the electron's buffer row
            chi_ev = e.chi[er][:, None]
            p4_ev = torch.stack([e.gamma[er], e.ux[er], e.uy[er], e.uz[er]],
                                dim=1)
        rec = torch.cat([
            x_glob[:, None].to(dtype),
            torch.full((n_w, 1), t, dtype=dtype, device=dev),
            ph.birth_time[idx][:, None].to(dtype),
            w_chi[:, None], w_k4, chi_ev.to(dtype), p4_ev.to(dtype),
            ev_kind[:, None].to(dtype),
        ], dim=1)
        events = (rec, want)

    tau_cols = dict(tau_abs=_put(ph.tau_abs, idx, tau_abs),
                    tau_st=_put(ph.tau_st, idx, tau_st))
    # the one host read after the walk
    n_abs, n_st = trace.host_read(
        torch.stack([absorbed.sum(), stimulated.sum()]))
    absorb.events["absorbed"] += n_abs
    absorb.events["stimulated"] += n_st
    n_ev = n_abs + n_st
    if n_ev == 0:
        if replicated:
            # the kicks of the other ranks' events may land here
            e = _route_kicks(ring, e, EVC)
        out = ({**species, "electron": e,
                "photon": dataclasses.replace(ph, **tau_cols)},
               zero, deferred)
        return out + (events,) if want_events else out

    # ---- event space: the events' rows alone ---------------------------
    j, _ = misfit_compact((absorbed | stimulated).to(torch.float32), n_ev)
    abs_j, stim_j = absorbed[j], stimulated[j]
    if replicated:
        tgt = ev_idx[j]  # the electron's buffer row on rank ev_dev[j]
        w_e_j = ev_we[j]
    else:
        tgt = unsort(ev_idx[j])  # the electron's buffer row
        w_e_j = e.weight[tgt]
    k_u_j = w_k4[j, 1:4]
    scale_abs = w_weight[j] / torch.clamp(w_e_j, min=_tiny(w_e_j.dtype))
    du = torch.where(abs_j[:, None], scale_abs[:, None] * k_u_j,
                     torch.where(stim_j[:, None], -k_u_j, 0.0))

    # the kicks (electron.rs:256-262, interactions.rs:322-334): absorbed
    # du = (w_ph / w_e) k, stimulated du = -k; then gamma at the kicked
    # rows (duplicate targets take the same value)
    if replicated:
        e = _route_kicks(ring, e, EVC, du, tgt, ev_dev[j])
    else:
        e = _kick(e, tgt, du)

    # absorbed photons die
    kill = torch.zeros(n_ph, dtype=torch.bool, device=dev)
    kill[idx[absorbed]] = True
    ph = dataclasses.replace(
        ph, **tau_cols, alive=ph.alive & ~kill,
        **{k: torch.where(kill, 0.0, getattr(ph, k)).to(getattr(ph, k).dtype)
           for k in ("weight", "ux", "uy", "uz")},
        cell=torch.where(kill, 0, ph.cell).to(ph.cell.dtype))

    lost = zero
    if opt.stimulated_emission:
        # the copies: the seed's momentum and polarization, the
        # electron's weight, fresh depths
        src = idx[j]
        cidx = torch.arange(n_ev, device=dev)
        buf = ParticleState(
            cell=ph.cell[src], x=ph.x[src], prev_x=ph.prev_x[src],
            y=ph.y[src], z=ph.z[src], weight=w_e_j.to(dtype),
            ux=k_u_j[:, 0], uy=k_u_j[:, 1], uz=k_u_j[:, 2],
            gamma=w_k4[j, 0], chi=w_chi[j], tau=None,
            tau_abs=_abs_draw(rng, "abs_tau_abs", cidx, dtype),
            tau_st=_abs_draw(rng, "abs_tau_st", cidx, dtype), work=None,
            birth_time=torch.full((n_ev,), t, dtype=dtype, device=dev),
            alive=stim_j, pol=ph.pol[src], basis=ph.basis[src],
        )
        ph, lost = insert(ph, buf, stim_j, width=EVC)
    out = ({**species, "electron": e, "photon": ph}, lost, deferred)
    return out + (events,) if want_events else out


#: the events that ``absorb`` applied since the counts were last set to
#: 0, by kind (a diagnostic read by the smoke run on the card)
absorb.events = {"absorbed": 0, "stimulated": 0}


def _kick(e, tgt, du):
    """Add the kicks ``du`` (rows, 3) to the electrons' momenta at rows
    ``tgt`` (a row ``>= len`` is dropped; targets may repeat) and
    recompute gamma there from the summed momenta."""
    n = e.ux.shape[0]
    tgt = torch.clamp(tgt, max=n)
    u = [torch.cat([c, c[:1]]).index_add(0, tgt, du[:, i].to(c.dtype))
         for i, c in enumerate((e.ux, e.uy, e.uz))]
    gx, gy, gz = (c[tgt] for c in u)
    gamma = _put(e.gamma, tgt,
                 torch.sqrt(1.0 + gx * gx + gy * gy + gz * gz).to(
                     e.gamma.dtype))
    return dataclasses.replace(e, ux=u[0][:n], uy=u[1][:n], uz=u[2][:n],
                               gamma=gamma)


def _route_kicks(ring, e, evc, du=None, tgt=None, owner=None):
    """The replicated mode's kicks (``opal_tpu/interactions.py:983-1006``):
    every rank sends its events' records ``[du | row | rank | active]``,
    padded to the event capacity ``evc`` rows, to every rank, and adds
    those addressed to itself.  ``du=None``: this rank has no event, but
    it takes the others'."""
    dtype = e.x.dtype
    rec = torch.zeros((evc, 6), dtype=dtype, device=e.x.device)
    if du is not None:
        n = du.shape[0]
        rec[:n] = torch.cat([du.to(dtype), tgt[:, None].to(dtype),
                             owner[:, None].to(dtype),
                             torch.ones((n, 1), dtype=dtype,
                                        device=e.x.device)], dim=1)
    flat = ring.all_gather(rec).reshape(-1, 6)
    mine = (flat[:, 4] == ring.rank) & (flat[:, 5] > 0.5)
    n_e = e.ux.shape[0]
    return _kick(e, torch.where(mine, flat[:, 3].long(), n_e), flat[:, :3])
