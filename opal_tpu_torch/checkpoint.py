"""Checkpoint / resume in ``opal_tpu``'s format (``opal_tpu/checkpoint.py``).

A snapshot is one ``checkpoint.npz``: the fields ``E B J rho``, every
column of every species as ``{species}/{field}``, the loss counters as
``counter/{name}`` and a JSON ``manifest`` (format version, output
index, time, species, and the device layout it was written on).  The
arrays have opal_tpu's names, shapes and dtypes, and the counters its
``(2,)`` int32 ``[hi, lo]`` base-2**30 pairs, so the port resumes a run
that opal_tpu wrote, on any device count or sharding mode: ``load``
re-buckets the particle rows onto the port's one device.

The random draws differ.  opal_tpu stores its threefry key under
``key``; the port stores its ``torch.Generator``'s state and the device
type it draws on (:data:`RNG_STATE`, :data:`RNG_DEVICE`), and a resumed
run draws exactly what the continuous run would have.  A file without
them (opal_tpu's) is accepted only by a deck without QED, which draws
nothing after initialisation.
"""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import torch

from .convert import fields_from_numpy, state_from_numpy, to_numpy
from .species import ParticleState, dead_default

FORMAT_VERSION = 1
FILENAME = "checkpoint.npz"
#: the generator's ``get_state()`` bytes and its device type ("cuda" or
#: "cpu"): a state of one device type cannot seed the other's generator
RNG_STATE, RNG_DEVICE = "rng/state", "rng/device"
_LO = (1 << 30) - 1


def save(directory, step_index: int, t: float, E, B, J, rho, species,
         rng: torch.Generator, counters, n_loc: int) -> Path:
    """Snapshot the simulation state of one device (``n_loc`` cells) at
    output ``step_index``.  The tensors (or host copies of them) are
    written with ``np.savez_compressed``, atomically: to a tmp file, then
    renamed."""
    arrays: dict[str, np.ndarray] = {
        k: to_numpy(a) for k, a in zip(("E", "B", "J", "rho"), (E, B, J, rho))
    }
    arrays[RNG_STATE] = rng.get_state().numpy()
    arrays[RNG_DEVICE] = np.array(rng.device.type)
    for name, st in species.items():
        for fname, a in to_numpy(st).items():
            if a is not None:
                arrays[f"{name}/{fname}"] = a
    for name, c in counters.items():
        v = int(c)
        arrays[f"counter/{name}"] = np.array([v >> 30, v & _LO], np.int32)

    manifest = json.dumps(
        {
            "version": FORMAT_VERSION,
            "step": int(step_index),
            "t": float(t),
            "species": sorted(species.keys()),
            "n_devices": 1,
            "n_loc": int(n_loc),
            "replicated": False,
        }
    )
    arrays["manifest"] = np.frombuffer(manifest.encode(), dtype=np.uint8)

    directory = Path(directory)
    tmp = directory / (FILENAME + ".tmp")
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tmp.write_bytes(buf.getvalue())
    path = directory / FILENAME
    tmp.replace(path)
    return path


def load(directory, sim):
    """Restore a snapshot onto ``sim``'s device.

    Returns ``(step_index, t, E, B, J, rho, species, rng, counters)``,
    ``rng`` a ``torch.Generator`` on ``sim.device`` that continues the
    saved stream (seeded from the deck for a file of opal_tpu's).
    Raises FileNotFoundError when there is no snapshot and ValueError
    when it does not fit ``sim``: another format version, other
    species, another grid, no recorded layout where one is needed, an
    opal_tpu key for a QED deck, or a generator of another device
    type."""
    path = Path(directory) / FILENAME
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}

    manifest = json.loads(bytes(arrays.pop("manifest").tobytes()).decode())
    if manifest["version"] != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{manifest['version']} != v{FORMAT_VERSION}"
        )
    if sorted(sim.specs.keys()) != manifest["species"]:
        raise ValueError(
            f"checkpoint species {manifest['species']} do not match the "
            f"configured {sorted(sim.specs.keys())}"
        )
    if arrays["E"].shape[0] != sim.geom.n_ext:
        raise ValueError(
            f"checkpoint grid has {arrays['E'].shape[0]} cells; "
            f"configuration expects {sim.geom.n_ext}"
        )
    ckpt_ndev = manifest.get("n_devices")
    ckpt_nloc = manifest.get("n_loc")
    was_replicated = bool(manifest.get("replicated", False))
    # another device count, or a replicated snapshot (whose cell column
    # is global): the particle rows are re-bucketed
    reshard = (ckpt_ndev is not None and ckpt_ndev != 1) or was_replicated
    if reshard and (ckpt_nloc is None or ckpt_ndev is None):
        raise ValueError(
            "checkpoint lacks the recorded device layout "
            f"(n_devices={ckpt_ndev}, n_loc={ckpt_nloc}); cannot "
            "reshard onto 1 device"
        )
    rng = _generator(arrays, sim)

    E, B, J, rho = fields_from_numpy(
        *(arrays[k] for k in ("E", "B", "J", "rho")), device=sim.device)
    species = {}
    for name in manifest["species"]:
        fields = {
            f.name: arrays.get(f"{name}/{f.name}")
            for f in dataclasses.fields(ParticleState)
        }
        if reshard:
            fields = _reshard_species(fields, ckpt_ndev, ckpt_nloc,
                                      sim.options, was_replicated)
        species[name] = state_from_numpy(fields, device=sim.device)

    # every saved counter, as a [hi, lo] pair or a legacy scalar; the
    # counters the deck expects but the file lacks start at zero
    counters = sim.zero_counters()
    for k, a in arrays.items():
        if k.startswith("counter/"):
            a = np.asarray(a)
            v = int(a) if a.ndim == 0 else (int(a[0]) << 30) + int(a[1])
            counters[k[len("counter/"):]] = torch.tensor(
                v, dtype=torch.int64, device=sim.device)
    return (
        manifest["step"], manifest["t"], E, B, J, rho, species, rng, counters
    )


def _generator(arrays, sim) -> torch.Generator:
    """The run's generator on ``sim.device``, restored from the file."""
    rng = torch.Generator(device=sim.device)
    if RNG_STATE not in arrays:
        if sim._qed_on:
            raise ValueError(
                "checkpoint holds opal_tpu's threefry key, and the port "
                "draws from a torch.Generator: the draw streams differ, so "
                "a QED run cannot resume from it"
            )
        return rng.manual_seed(sim.options.seed)
    saved = str(arrays[RNG_DEVICE])
    if saved != sim.device.type:
        raise ValueError(
            f"checkpoint's generator state is of a {saved} generator; this "
            f"run draws on {sim.device.type}"
        )
    rng.set_state(torch.from_numpy(arrays[RNG_STATE]))
    return rng


def _reshard_species(fields, old_ndev, old_nloc, options,
                     was_replicated=False):
    """Re-bucket one species of a snapshot written on ``old_ndev``
    devices (or in replicated mode) onto one device, host-side:
    ``opal_tpu/checkpoint.py`` ``_reshard_species`` with one new device
    in domain mode.

    Every alive row is lifted to its global extended cell (``g =
    old_dev * old_nloc + cell``, or ``cell`` when the snapshot was
    replicated), which on one device is its cell.  The capacity is 1.25x
    the alive rows, plus 128 and rounded to 128, and to whole fused
    blocks once it reaches one; a species that comes out below a block
    leaves the fused path, as in opal_tpu.  Dead rows take the dead
    defaults."""
    alive = np.asarray(fields["alive"])
    n_old = alive.shape[0]
    old_cap = n_old // max(old_ndev, 1)
    old_dev = np.arange(n_old) // max(old_cap, 1)
    cell = np.asarray(fields["cell"])
    is_photon = fields.get("tau_abs") is not None

    g = cell if was_replicated else old_dev * old_nloc + cell
    rows = np.flatnonzero(alive)
    cap = max(-(-rows.size * 5 // 4) // 128 * 128 + 128, 128)
    if options.fused_pusher and cap >= options.fused_block:
        blk = options.fused_block
        cap = -(-cap // blk) * blk

    out = {}
    for fname, a in fields.items():
        if a is None:
            out[fname] = None
            continue
        a = np.asarray(a)
        new = np.full((cap,) + a.shape[1:], dead_default(fname, is_photon),
                      a.dtype)
        src = g.astype(cell.dtype) if fname == "cell" else a
        new[: rows.size] = src[rows]
        out[fname] = new
    return out
