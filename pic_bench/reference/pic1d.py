"""Plain 1d3v particle-in-cell reference on a periodic grid.

Written from the discrete system of upstream opal (tgblackburn/opal
v1.5.1, ``src/grid/yee.rs`` and ``src/particle/electron.rs``), which the
program under test also follows, in plain PyTorch operations with no
sort, no fused kernel, no migration and no decomposition:

* fields on the Yee staggering: Ex, By, Bz at cell centres, Ey, Ez, Bx
  on the left cell edge; the second-order b-spline gather
  (``yee.rs:499-529``);
* the Vay leapfrog push of electrons (``electron.rs:268-330``), positions
  as an integer cell and an offset in [0, 1), wrapped on the periodic
  grid every step;
* the charge-conserving deposit: jx from the flux of the triangle
  shape across each cell boundary, jy and jz with b-spline weights
  (``yee.rs:551-641``);
* the Yee advance B(dt/2), E(dt), B(dt/2) on a slab of the grid with
  ``HALO`` periodic ghost cells a side, whose currents are zero, as the
  upstream overlay does (``yee.rs:97-113, 345-349, 839-867``).

Every array is in the precision it is given (``dtype``): float32 is the
decks' stated precision, and bfloat16 is the control that
``pic_bench/tests`` and ``PERF.md`` hold the comparison against.
"""

from __future__ import annotations

import torch

C = 2.997925e8
C2 = 89875517873681764.0
EPS0 = 8.854188e-12
ELECTRON_CHARGE = -1.602177e-19
ELECTRON_MASS = 9.109383e-31
#: ghost cells a side of the field slab
HALO = 4
#: copies of the current grid that the longitudinal deposit spreads its
#: additions over (particle i adds into copy i % LANES), so that the
#: electrons of one cell, which sit in consecutive rows, do not all add
#: into one address; the copies are summed once a step
LANES = 64


def bspline(xi):
    """Second-order b-spline weight (``yee.rs:140-149``)."""
    a = torch.abs(xi)
    inner = 0.75 - a * a
    outer = 1.125 - 1.5 * a + 0.5 * (a * a)
    return torch.where(a > 1.5, 0.0, torch.where(a < 0.5, inner, outer))


def flux(x_i, x_f):
    """The share of a triangle-shaped particle that crosses a boundary
    while its displacement from the boundary goes from ``x_i`` to
    ``x_f`` (``yee.rs:185-204``); positive for left-to-right motion."""
    ai, af = torch.abs(x_i), torch.abs(x_f)
    hi = 0.5 * ((1.0 - ai) * (1.0 - ai))
    hf = 0.5 * ((1.0 - af) * (1.0 - af))
    out_in = torch.copysign(hi, -x_i)
    same = torch.copysign(hf - hi, x_i - x_f)
    across = torch.copysign(ai * (1.0 - 0.5 * ai) + af * (1.0 - 0.5 * af), x_i)
    in_out = torch.copysign(hf, x_f)
    return torch.where(
        ai < 1.0,
        torch.where(af >= 1.0, out_in, torch.where(x_i * x_f >= 0.0, same,
                                                   across)),
        torch.where(af < 1.0, in_out, torch.zeros_like(in_out)))


def gather(E, B, cell, x):
    """(Ep, Bp), (N, 3) each: the fields at the particles, with the
    grid's neighbours taken periodically."""
    nx = E.shape[0]
    rows = [torch.remainder(cell + k, nx) for k in (-1, 0, 1, 2)]
    wc = [bspline(0.5 + x), bspline(0.5 - x), bspline(1.5 - x)]
    we = [bspline(1.0 + x), bspline(x), bspline(1.0 - x), bspline(2.0 - x)]

    def centred(F, c):
        return sum(w * F[r, c] for w, r in zip(wc, rows[:3]))

    def edge(F, c):
        return sum(w * F[r, c] for w, r in zip(we, rows))

    Ep = torch.stack([centred(E, 0), edge(E, 1), edge(E, 2)], dim=1)
    Bp = torch.stack([B[rows[1], 0], centred(B, 1), centred(B, 2)], dim=1)
    return Ep, Bp


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def vay(u, gamma, E, B, dt):
    """The Vay push of electrons: (u_new, gamma_new) from the momentum
    ``u`` = p / (m c), (N, 3), its Lorentz factor and the fields at the
    particle."""
    v = C * u / gamma[:, None]
    alpha = ELECTRON_CHARGE * dt / (2.0 * ELECTRON_MASS * C)
    u_half = u + alpha * (E + _cross(v, B))
    u_prime = u_half + alpha * E
    gp2 = 1.0 + _dot(u_prime, u_prime)
    tau = alpha * C * B
    u_star = _dot(u_prime, tau)
    t2 = _dot(tau, tau)
    sigma = gp2 - t2
    gamma_new = torch.sqrt(
        0.5 * sigma + torch.sqrt(0.25 * sigma * sigma + t2 + u_star * u_star))
    t = tau / gamma_new[:, None]
    s = 1.0 / (1.0 + _dot(t, t))
    u_new = s[:, None] * (u_prime + _dot(u_prime, t)[:, None] * t
                          + _cross(u_prime, t))
    return u_new, gamma_new


def deposit(nx, cell, x, prev_x, q, vy, vz, dx, dt):
    """(nx, 3) currents of one step: jx by the flux across the five
    boundaries around each particle, jy and jz by b-spline weights, each
    tap added at its cell modulo ``nx``."""
    idx, vals = [], []
    for off in (-2, -1, 0, 1, 2):
        b = off + 0.5
        idx.append(3 * torch.remainder(cell + off, nx))
        vals.append(q * flux(b - prev_x, b - x) / dt)
    w = {-1: bspline(1.0 + x), 0: bspline(x), 1: bspline(1.0 - x)}
    for comp, v in ((1, vy), (2, vz)):
        for off, wo in w.items():
            idx.append(3 * torch.remainder(cell + off, nx) + comp)
            vals.append(q * v * wo / dx)
    J = torch.zeros(3 * nx, dtype=x.dtype, device=x.device)
    J.index_add_(0, torch.cat(idx), torch.cat(vals))
    return J.view(nx, 3)


def advance_b(E, B, h, dx):
    dEy = E[1:, 1] - E[:-1, 1]
    dEz = E[1:, 2] - E[:-1, 2]
    B = B.clone()
    B[:-1, 1] = B[:-1, 1] + h * dEz / dx
    B[:-1, 2] = B[:-1, 2] - h * dEy / dx
    return B


def advance_e(E, B, J, dt, dx):
    """The E advance of the slab; its first row, a ghost cell, takes the
    Silver-Mueller outgoing update, as upstream's stencil does."""
    kappa = 2.0 * C * dt / (C * dt + dx)
    sigma = 1.0 - kappa
    B_left = torch.roll(B, 1, dims=0)
    Ex = E[:, 0] - dt * J[:, 0] / EPS0
    Ey = E[:, 1] + dt * C2 * (B_left[:, 2] - B[:, 2]) / dx - dt * J[:, 1] / EPS0
    Ez = E[:, 2] + dt * C2 * (B[:, 1] - B_left[:, 1]) / dx - dt * J[:, 2] / EPS0
    out = torch.stack([Ex, Ey, Ez], dim=-1)
    out[0] = torch.stack([torch.zeros_like(E[0, 0]),
                          sigma * E[0, 1] - C * kappa * B[0, 2],
                          sigma * E[0, 2] + C * kappa * B[0, 1]])
    return out


def advance_fields(E, B, J, dt, dx):
    """One Yee step of the periodic grid through a ghosted slab."""
    ext = lambda F: torch.cat([F[-HALO:], F, F[:HALO]])
    Es, Bs = ext(E), ext(B)
    Js = torch.nn.functional.pad(J, (0, 0, HALO, HALO))
    Bs = advance_b(Es, Bs, 0.5 * dt, dx)
    Es = advance_e(Es, Bs, Js, dt, dx)
    Bs = advance_b(Es, Bs, 0.5 * dt, dx)
    return Es[HALO:-HALO], Bs[HALO:-HALO]


def tsc_near(X):
    """(m, (w[m-1], w[m], w[m+1])): the nearest integer point to each
    position ``X`` (in cells) and the b-spline weights of the points
    around it, in the closed form of the nearest-point offset."""
    m = torch.round(X)
    d = X - m
    return m, (0.5 * (0.5 - d) * (0.5 - d), 0.75 - d * d,
               0.5 * (0.5 + d) * (0.5 + d))


def charge_change(x, prev_x):
    """(base, (N, 4) taps): how each electron's b-spline charge on the
    integer points base - 1 .. base + 2 (relative to its cell) changed
    from ``prev_x`` to ``x``, both offsets in its new cell; the old and
    the new nearest points differ by at most one (CFL)."""
    mn, wn = tsc_near(x)
    mo, wo = tsc_near(prev_x)
    base = torch.minimum(mn, mo)
    zero = torch.zeros_like(x)

    def at(m, w):
        # the three weights on the four taps, shifted by m - base
        low = m == base
        return (torch.where(low, w[0], zero), torch.where(low, w[1], w[0]),
                torch.where(low, w[2], w[1]), torch.where(low, zero, w[2]))

    new, old = at(mn, wn), at(mo, wo)
    return base, torch.stack([a - b for a, b in zip(new, old)], dim=1)


def run_longitudinal(cell, x, ux, weight, E, dx, dt, steps, allreduce=None):
    """:func:`run_electrons` where the start state has no transverse
    momentum and no field but Ex.  The equations keep uy, uz, Ey, Ez and
    B at exactly zero then (no jy or jz is deposited, and no transverse
    force arises), so only ux, Ex and jx are advanced.  The Vay push
    without B is u += 2 alpha Ex.  The charge-conserving jx is written
    through the continuity equation it satisfies: the change of each
    electron's b-spline charge on the integer points, summed from the
    left, gives jx at the half-integer points, and the one constant a
    periodic grid leaves open is fixed by the electrons' total
    displacement; the grid sums run in float64.  ``allreduce`` (see
    :func:`run_electrons`) sums them over the processes that share the
    electrons.  Returns (cell, x, ux, Ex)."""
    nx = E.shape[0]
    alpha = ELECTRON_CHARGE * dt / (2.0 * ELECTRON_MASS * C)
    # one macroparticle weight (as the decks draw it) scales the grid;
    # otherwise each electron's taps
    w0 = weight[:1]
    uniform = bool(torch.all(weight == w0))
    qw = float(w0) * ELECTRON_CHARGE if uniform else None
    q = None if uniform else weight * ELECTRON_CHARGE
    cell = cell.int()
    lane = torch.remainder(torch.arange(x.numel(), device=x.device,
                                        dtype=torch.int32), LANES)
    for _ in range(steps):
        # Ex at the cell centres c - 1/2, c + 1/2, c + 3/2 of cell c
        Ee = torch.cat([E[-1:], E, E[:1]])
        Ex = (0.5 * (1.0 - x) * (1.0 - x) * Ee[cell]
              + (0.75 - (x - 0.5) * (x - 0.5)) * Ee[cell + 1]
              + 0.5 * x * x * Ee[cell + 2])
        ux = (ux + alpha * Ex) + alpha * Ex
        gamma = torch.sqrt(1.0 + ux * ux)
        x_new = x + C * ux * dt / (dx * gamma)
        fl = torch.floor(x_new)
        cell = torch.remainder(cell + torch.sign(fl).int(), nx)
        prev_x, x = x - fl, x_new - fl
        base, taps = charge_change(x, prev_x)
        if q is not None:
            taps = taps * q[:, None]
        rho = torch.zeros((nx * LANES, 4), dtype=x.dtype, device=x.device)
        rho.index_add_(0, torch.remainder(cell + base.int() - 1, nx) * LANES
                       + lane, taps)
        A = rho.view(nx, LANES, 4).sum(dim=1, dtype=torch.float64)
        moved = torch.sum(x - prev_x if q is None else q * (x - prev_x),
                          dtype=torch.float64)
        if allreduce is not None:
            both = allreduce(torch.cat([A.view(-1), moved.view(1)]))
            A, moved = both[:-1].view(nx, 4), both[-1]
        drho = sum(torch.roll(A[:, j], j) for j in range(4))
        flux = -torch.cumsum(drho, dim=0)
        flux = flux + (moved - flux.sum()) / nx
        if qw is not None:
            flux = flux * qw
        E = E - (flux / EPS0).to(E.dtype)
    return cell, x, ux, E


def run_electrons(cell, x, u, weight, E, B, dx, dt, steps,
                  dtype=torch.float32, allreduce=None):
    """Advance electrons and fields ``steps`` steps on the periodic grid
    of ``E.shape[0]`` cells.

    ``cell`` (N,) integer cells in [0, nx), ``x`` (N,) offsets in
    [0, 1), ``u`` (N, 3) momenta p / (m c), ``weight`` (N,) real
    electrons a macroparticle; ``E``, ``B`` (nx, 3).  Every array is
    cast to ``dtype``.  With ``allreduce`` (a function that returns the
    sum of a tensor over several processes) the electrons are this
    process's share of the deck, every process holds the whole grid, and
    each step's currents are summed over the shares.  Returns (cell, x,
    u, E, B) after the last step.
    """
    nx = E.shape[0]
    cell = cell.long()
    x, u, E, B = (a.to(dtype) for a in (x, u, E, B))
    if not (bool(u[:, 1:].any()) or bool(E[:, 1:].any()) or bool(B.any())):
        cell, x, ux, Ex = run_longitudinal(cell, x, u[:, 0], weight.to(dtype),
                                           E[:, 0], dx, dt, steps, allreduce)
        u = torch.stack([ux, u[:, 1], u[:, 2]], dim=1)
        return cell, x, u, torch.stack([Ex, E[:, 1], E[:, 2]], dim=1), B
    q = weight.to(dtype) * ELECTRON_CHARGE
    gamma = torch.sqrt(1.0 + _dot(u, u))
    for _ in range(steps):
        Ep, Bp = gather(E, B, cell, x)
        u_new, gamma = vay(u, gamma, Ep, Bp, dt)
        prev_x = x
        x_new = x + C * u_new[:, 0] * dt / (dx * gamma)
        u = u_new
        fl = torch.floor(x_new)
        cell = torch.remainder(cell + torch.sign(fl).long(), nx)
        x, prev_x = x_new - fl, prev_x - fl
        v = C * u / gamma[:, None]
        J = deposit(nx, cell, x, prev_x, q, v[:, 1], v[:, 2], dx, dt)
        if allreduce is not None:
            J = allreduce(J)
        E, B = advance_fields(E, B, J, dt, dx)
    return cell, x, u, E, B
