"""QED photon emission: the emission pass of ``opal_tpu/interactions.py``
(``emit_radiation``, ``:56-295``; reference
``src/particle/interactions.rs:45-107``, ``electron.rs:208-251``).

Every electron whose optical depth fell below zero samples the quantum
(or classical) synchrotron spectrum, recoils, draws a new optical depth,
and its photon goes into a dead slot of the photon buffer.  As in
opal_tpu, at most ``emission_active_capacity`` emitters a step are
served, in buffer order (the rest keep their negative depth and emit
later, counted as deferred), and at most ``emission_insert_capacity``
photons a step are inserted (the emitters beyond are deferred too,
without recoil).

The sampler runs on the emitters alone: one host read a step gives their
count (and the photon buffer's high-water mark), and a step without
emitters launches nothing more.  The random numbers come from a
``torch.Generator``, or, to replay opal_tpu's draws, from a dict of its
per-step arrays: emitter j of the compacted table takes draw j, as
there.
"""

from __future__ import annotations

import dataclasses

import torch

from . import constants as const
from .ops.fused import misfit_compact
from .parallel.migrate import _put, insert
from .qed import emission
from .species import ParticleState
from .vec3 import orthogonal, rotate_around


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
    total, ph_hi = torch.stack([emits.sum(), ph_top]).tolist()
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
    with torch.profiler.record_function("emission_sample"):
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

