"""Simulation output: grid dumps, energy ledger, particle histograms.

File formats and naming mirror the reference so post-processing
pipelines carry over unchanged:

* ``{i}_grid.dat`` — 11 columns (x rho jx jy jz Ex Ey Ez Bx By Bz),
  all quantities interpolated to the cell left edge
  (``src/grid/yee.rs:749-781,815-835``).
* ``{i}_energy.dat`` — em_field / electrons / ions / photons totals in
  joules (``src/main.rs:23-42``).
* ``{i}_{species}_{spec}[.][_weight][_log].fits`` — distribution
  functions per output-spec string (``src/particle/mod.rs:383-568``),
  grammar ``f[:g][:(bspec;weight)]``.
* the absorption and stimulated-emission events, one line each on a
  stream (standard error in the CLI), from the event ring
  (``interactions.rs:267-289``).

The writers read host numpy copies of the port's tensors: particle
columns come as a dict of numpy arrays by column name
(``convert.to_numpy`` of a ``ParticleState``).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from .. import constants as const
from ..grid import GridGeometry
from ..species import SpeciesSpec
from . import fits
from .hgram import AUTO, BinSpec, generate_1d, generate_2d

_UNITS = {
    "x": "m", "r": "m", "energy": "MeV",
    "px": "MeV/c", "py": "MeV/c", "pz": "MeV/c", "p_perp": "MeV/c",
    "theta": "rad", "phi": "rad", "longitude": "rad", "latitude": "rad",
    "work": "J", "chi": "1", "helicity": "1",
}


def particle_quantity(
    name: str, spec: SpeciesSpec, st: dict, geom: GridGeometry,
    capacity_per_device: int, replicated: bool = False,
):
    """Host-side accessor for one output quantity over all alive
    particles (``mod.rs:388-449``); ``st`` maps column names to numpy
    arrays of the ranks' blocks of ``capacity_per_device`` rows, each
    with its rank's local cells, or with global cells when
    ``replicated``."""
    alive = st["alive"]
    u = np.stack([st["ux"], st["uy"], st["uz"]], axis=1)[alive]
    gamma = st["gamma"][alive]

    if spec.kind == "ion":
        p_unit = (spec.mass / const.ELECTRON_MASS) * const.ELECTRON_MASS_MEV
    else:
        p_unit = const.ELECTRON_MASS_MEV
    p = u * p_unit
    pmag = np.sqrt(np.sum(p * p, axis=-1))

    if name == "x":
        g = st["cell"][alive]
        if not replicated:
            dev = np.flatnonzero(alive) // capacity_per_device
            g = dev * geom.n_loc + g
        return geom.xmin + (g - geom.left_pad + st["x"][alive]) * geom.dx
    if name == "r":
        return np.hypot(st["y"][alive], st["z"][alive])
    if name == "energy":
        if spec.kind == "ion":
            # gamma - 1 cancellation-free, times the ion's rest energy
            u2 = np.sum(u * u, axis=-1)
            return u2 / (1.0 + np.sqrt(1.0 + u2)) * p_unit
        return gamma * const.ELECTRON_MASS_MEV
    if name == "px":
        return p[:, 0]
    if name == "py":
        return p[:, 1]
    if name == "pz":
        return p[:, 2]
    if name == "p_perp":
        return np.hypot(p[:, 1], p[:, 2])
    if name == "theta":
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.arccos(p[:, 0] / pmag)
    if name == "phi":
        return np.arctan2(p[:, 2], p[:, 1])
    if name == "longitude":
        return np.arctan2(p[:, 1], -p[:, 0])
    if name == "latitude":
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.arcsin(p[:, 2] / pmag)
    if name == "work":
        if "work" not in st:
            return np.zeros(alive.sum())
        return st["work"][alive]
    if name == "chi":
        return st["chi"][alive]
    if name == "helicity":
        # the photon spin_state (photon.rs:141-147,299-302), an
        # extension of the output grammar
        if "pol" not in st:
            return np.zeros(alive.sum())
        pol = st["pol"][alive]
        re = pol[:, 0] + pol[:, 3]
        im = pol[:, 1] - pol[:, 2]
        return 0.5 * (re * re + im * im)
    return None


def parse_output_spec(o: str):
    """Parse one output-spec string into (axes, bspec, weight)
    (``mod.rs:452-467``); returns None if not recognised."""
    ss = o.split(":")
    bspec, weight = AUTO, "weight"
    if len(ss) >= 2 and ss[-1].startswith("(") and ss[-1].endswith(")"):
        last = ss.pop()[1:-1]
        parts = last.split(";")
        if len(parts) == 1:
            weight = parts[0]
        elif len(parts) == 2:
            bspec, weight = BinSpec.parse(parts[0]), parts[1]
    if len(ss) not in (1, 2):
        return None
    if any(s not in _UNITS for s in ss):
        return None
    if weight not in ("weight", "auto", "energy"):
        return None
    return ss, bspec, weight


def write_particle_outputs(
    directory, index: int, spec: SpeciesSpec, st: dict,
    geom: GridGeometry, capacity_per_device: int, replicated: bool = False,
):
    """Generate and write every requested distribution for a species
    (``mod.rs:451-566``)."""
    directory = Path(directory)
    for o in spec.output:
        parsed = parse_output_spec(o)
        if parsed is None:
            continue
        axes, bspec, weight = parsed

        values = [
            particle_quantity(a, spec, st, geom, capacity_per_device,
                              replicated)
            for a in axes
        ]
        weights = st["weight"][st["alive"]]
        if weight == "energy":
            weights = weights * particle_quantity(
                "energy", spec, st, geom, capacity_per_device, replicated
            )

        if len(axes) == 1:
            h = generate_1d(values[0], weights, axes[0], _UNITS[axes[0]], bspec)
            stem = f"{index}_{spec.name}_{axes[0]}"
        else:
            h = generate_2d(
                values[0], values[1], weights, axes, [_UNITS[a] for a in axes],
                [bspec, bspec],
            )
            stem = f"{index}_{spec.name}_{axes[0]}-{axes[1]}"
        if weight != "weight":
            stem += f"_{weight}"
        if bspec.kind == "log":
            stem += "_log"
        if h is not None:
            fits.write_histogram(directory / f"{stem}.fits", h)


def interpolate_grid(E, B, J, rho, geom: GridGeometry):
    """Interpolate all grid quantities to the cell left edge over the
    interior, host-side (``yee.rs:815-835``).

    Centred quantities (jx, Ex, By, Bz) average cells g-1 and g; edge
    quantities pass through.  For the first interior cell the left
    neighbour is the boundary-zone cell (non-periodic) or the wrapped
    last cell (periodic).
    """
    E = np.asarray(E)
    B = np.asarray(B)
    J = np.asarray(J)
    rho = np.asarray(rho)
    s, e = geom.interior_start, geom.interior_end

    def left(a):
        return np.roll(a, 1, axis=0)[s:e]

    out = np.zeros((geom.nx, 11))
    out[:, 0] = geom.interior_x()
    out[:, 1] = rho[s:e]
    out[:, 2] = 0.5 * (J[s:e, 0] + left(J)[:, 0])
    out[:, 3] = J[s:e, 1]
    out[:, 4] = J[s:e, 2]
    out[:, 5] = 0.5 * (E[s:e, 0] + left(E)[:, 0])
    out[:, 6] = E[s:e, 1]
    out[:, 7] = E[s:e, 2]
    out[:, 8] = B[s:e, 0]
    out[:, 9] = 0.5 * (B[s:e, 1] + left(B)[:, 1])
    out[:, 10] = 0.5 * (B[s:e, 2] + left(B)[:, 2])
    return out


def write_grid_data(directory, index: int, E, B, J, rho, geom: GridGeometry):
    rows = interpolate_grid(E, B, J, rho, geom)
    path = Path(directory) / f"{index}_grid.dat"
    from .. import native

    if native.write_text_table(path, rows):
        return
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(f"{v:.17e}" for v in row) + "\n")


def write_energies(
    directory, index: int, field_energy: float, electron_energy: float,
    ion_energy: float, photon_energy: float,
):
    path = Path(directory) / f"{index}_energy.dat"
    with open(path, "w") as f:
        f.write(f"em_field {field_energy:.6e}\n")
        f.write(f"electrons {electron_energy:.6e}\n")
        f.write(f"ions {ion_energy:.6e}\n")
        f.write(f"photons {photon_energy:.6e}\n")


def write_event_log(stream, events, options) -> int:
    """Drain the event ring ``events = (ring, count)`` (host arrays of
    ``Simulation.zero_events``'s shapes, or the ranks' rings stacked:
    ``count`` then holds one count a rank) to ``stream`` in the
    reference's dump format (``interactions.rs:267-289``;
    ``opal_tpu/diagnostics/output.py:172-206``), rank by rank: ``x t
    birth_time chi_g k0 k1 k2 k3 chi_e p0 p1 p2 p3 abs|stim``.  Events
    past a ring's capacity are counted in a closing warning line, never
    dropped silently.  Returns the number of rows written."""
    counts = np.atleast_1d(np.asarray(events[1]))
    rings = np.asarray(events[0]).reshape(counts.size, -1, 14)
    cap = rings.shape[1]
    written = dropped = 0
    for ring, count in zip(rings, counts):
        count = int(count)
        dropped += max(0, count - cap)
        for r in ring[:min(count, cap)]:
            kind = "abs" if r[13] == 1.0 else "stim"
            if kind == "abs" and not options.extra_absorption_output:
                continue
            if kind == "stim" and not options.extra_stimulated_emission_output:
                continue
            head = " ".join(f"{v:.6e}" for v in r[:3])
            body = " ".join(f"{v:.3e}" for v in r[3:13])
            stream.write(f"{head} {body} {kind}\n")
            written += 1
    if dropped:
        stream.write(
            f"# WARNING: event ring overflow: {dropped} events dropped "
            f"(capacity {cap}/device; raise control:event_log_capacity)\n"
        )
    return written
