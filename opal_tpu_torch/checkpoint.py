"""Checkpoint / resume in ``opal_tpu``'s format (``opal_tpu/checkpoint.py``).

A snapshot is one ``checkpoint.npz``: the fields ``E B J rho`` of the
whole grid, every column of every species as ``{species}/{field}`` in
opal_tpu's per-device block layout (one block of rows a rank), the loss
counters as ``counter/{name}`` and a JSON ``manifest`` (format version,
output index, time, species, and the layout it was written on: the
rank count ``n_devices``, the cells a rank ``n_loc`` and whether the
run was ``replicated``).  The arrays have opal_tpu's names, shapes and
dtypes, and the counters its ``(2,)`` int32 ``[hi, lo]`` base-2**30
pairs, so either package resumes the other's run, on any rank count
and in either mode: ``load`` re-buckets the particle rows when the
count or the mode differs, and each rank takes its block.

The random draws differ.  opal_tpu stores its threefry key under
``key``; the port stores its ``torch.Generator``'s state, one row a
rank, and the device type it draws on (:data:`RNG_STATE`,
:data:`RNG_DEVICE`), and a resumed run on as many ranks draws exactly
what the continuous run would have.  A file without them (opal_tpu's),
or with the states of another rank count, is accepted only by a deck
without QED, which draws nothing after initialisation.  The port also
writes ``key``, the threefry key data of the deck's seed, so that
opal_tpu resumes the port's files (a QED run then draws a fresh stream
of that seed).
"""

from __future__ import annotations

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import torch

from .convert import fields_from_numpy, state_from_numpy, to_numpy
from .species import ParticleState, dead_default, rank_seed

FORMAT_VERSION = 1
FILENAME = "checkpoint.npz"
#: the generator's ``get_state()`` bytes and its device type ("cuda" or
#: "cpu"): a state of one device type cannot seed the other's generator
RNG_STATE, RNG_DEVICE = "rng/state", "rng/device"
_LO = (1 << 30) - 1


def save(directory, step_index: int, t: float, E, B, J, rho, species,
         rng, counters, n_loc: int, n_devices: int = 1,
         replicated: bool = False, seed: int = 0) -> Path:
    """Snapshot the simulation state at output ``step_index``: the
    fields of the whole grid and the species of every rank (gathered by
    the caller), written on ``n_devices`` ranks of ``n_loc`` cells, or
    ``replicated``.  ``rng`` is the run's ``torch.Generator``, or for
    several ranks ``(states, device_type)``, the ranks' generator states
    stacked (:func:`gather_rng`); ``seed`` the deck's ``tpu: seed``,
    whose threefry key data is written as ``key`` for opal_tpu.  The tensors (or host copies of them)
    are written with ``np.savez_compressed``, atomically: to a tmp file,
    then renamed."""
    arrays: dict[str, np.ndarray] = {
        k: to_numpy(a) for k, a in zip(("E", "B", "J", "rho"), (E, B, J, rho))
    }
    if isinstance(rng, torch.Generator):
        states, device_type = rng.get_state().numpy(), rng.device.type
    else:
        states, device_type = rng
    arrays[RNG_STATE] = np.asarray(states)
    arrays[RNG_DEVICE] = np.array(device_type)
    # jax.random.key_data(jax.random.key(seed)): the seed's high and low
    # 32 bits
    arrays["key"] = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                             np.uint32)
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
            "n_devices": int(n_devices),
            "n_loc": int(n_loc),
            "replicated": bool(replicated),
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


def gather_rng(rng: torch.Generator, ring):
    """``(states, device_type)`` of the generators of every rank of
    ``ring`` (``parallel.dist.Ring``), for :func:`save` on rank 0: a
    (world, L) uint8 array; ``None`` on the other ranks.  Every rank
    must call it."""
    states = ring.gather(rng.get_state().to(ring.device))
    return None if states is None else (to_numpy(states), rng.device.type)


def load(directory, sim):
    """Restore a snapshot onto ``sim``'s rank (``sim.ring``) and mode.

    Returns ``(step_index, t, E, B, J, rho, species, rng, counters)``:
    the rank's slab of the fields (the whole grid in the replicated
    mode), its block of every species, ``rng`` a ``torch.Generator`` on
    ``sim.device`` that continues the rank's saved stream (seeded from
    the deck for a file of opal_tpu's), and the counters of the whole
    run.  Raises FileNotFoundError when there is no snapshot and
    ValueError when it does not fit ``sim``: another format version,
    other species, another grid, no recorded layout where one is
    needed, an opal_tpu key or another rank count's generators for a
    QED deck, or a generator of another device type."""
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
    geom, ring = sim.geom, sim.ring
    replicated = sim.options.replicate_fields
    n_ext = geom.n_ext if replicated else geom.n_devices * geom.n_loc
    if arrays["E"].shape[0] != n_ext:
        raise ValueError(
            f"checkpoint grid has {arrays['E'].shape[0]} cells; "
            f"configuration expects {n_ext}"
        )
    ckpt_ndev = manifest.get("n_devices")
    ckpt_nloc = manifest.get("n_loc")
    was_replicated = bool(manifest.get("replicated", False))
    # another rank count, or a mode flip (the cell column is rank-local
    # in the domain mode and global in the replicated one): the particle
    # rows are re-bucketed
    reshard = ((ckpt_ndev is not None and ckpt_ndev != ring.world)
               or was_replicated != replicated)
    if reshard and (ckpt_nloc is None or ckpt_ndev is None):
        raise ValueError(
            "checkpoint lacks the recorded device layout "
            f"(n_devices={ckpt_ndev}, n_loc={ckpt_nloc}); cannot "
            f"reshard onto {ring.world} devices (replicated={replicated})"
        )
    rng = _generator(arrays, sim)

    if replicated:
        cells = slice(None)
    else:
        cells = slice(ring.rank * geom.n_loc, (ring.rank + 1) * geom.n_loc)
    E, B, J, rho = fields_from_numpy(
        *(arrays[k][cells] for k in ("E", "B", "J", "rho")),
        device=sim.device)
    species = {}
    for name in manifest["species"]:
        fields = {
            f.name: arrays.get(f"{name}/{f.name}")
            for f in dataclasses.fields(ParticleState)
        }
        if reshard:
            fields = _reshard_species(fields, ckpt_ndev, ring.world,
                                      ckpt_nloc, geom.n_loc, sim.options,
                                      was_replicated, replicated)
        cap = fields["alive"].shape[0] // ring.world
        rows = slice(ring.rank * cap, (ring.rank + 1) * cap)
        species[name] = state_from_numpy(
            {k: None if a is None else a[rows] for k, a in fields.items()},
            device=sim.device)

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
    """The rank's generator on ``sim.device``, restored from the file."""
    rng = torch.Generator(device=sim.device)
    ring = sim.ring
    states = arrays.get(RNG_STATE)
    if states is not None and states.ndim == 1:
        states = states[None]
    if states is None or states.shape[0] != ring.world:
        if sim._qed_on:
            raise ValueError(
                "checkpoint holds opal_tpu's threefry key, and the port "
                "draws from a torch.Generator: the draw streams differ, so "
                "a QED run cannot resume from it" if states is None else
                f"checkpoint holds the generators of {states.shape[0]} "
                f"ranks; a QED run on {ring.world} cannot continue their "
                "streams")
        return rng.manual_seed(rank_seed(sim.options.seed, ring.rank))
    saved = str(arrays[RNG_DEVICE])
    if saved != sim.device.type:
        raise ValueError(
            f"checkpoint's generator state is of a {saved} generator; this "
            f"run draws on {sim.device.type}"
        )
    rng.set_state(torch.from_numpy(states[ring.rank].copy()))
    return rng


def _reshard_species(fields, old_ndev, new_ndev, old_nloc, new_nloc,
                     options, was_replicated=False, now_replicated=False):
    """Re-bucket one species of a snapshot written on ``old_ndev``
    ranks (or in the replicated mode) onto ``new_ndev`` ranks in the
    domain or the replicated mode, host-side
    (``opal_tpu/checkpoint.py`` ``_reshard_species``).

    Every alive row is lifted to its global extended cell (``g =
    old_dev * old_nloc + cell``, or ``cell`` when the snapshot was
    replicated), then bucketed: by owning slab (``g // new_nloc``,
    local cell) in the domain mode, or into equal-count contiguous
    chunks with global cells in the replicated mode.  The capacity a
    rank is 1.25x the largest bucket, plus 128 and rounded to 128, and
    to whole fused blocks once it reaches one; a species that comes out
    below a block leaves the fused path, as in opal_tpu.  Dead rows take
    the dead defaults."""
    alive = np.asarray(fields["alive"])
    n_old = alive.shape[0]
    old_cap = n_old // max(old_ndev, 1)
    old_dev = np.arange(n_old) // max(old_cap, 1)
    cell = np.asarray(fields["cell"])
    is_photon = fields.get("tau_abs") is not None

    g = cell if was_replicated else old_dev * old_nloc + cell
    alive_idx = np.flatnonzero(alive)
    if now_replicated:
        chunk = -(-alive_idx.size // new_ndev) if alive_idx.size else 0
        dev_of = np.arange(alive_idx.size) // max(chunk, 1)
        new_cell = g.astype(cell.dtype)
    else:
        dev_all = np.clip(g // new_nloc, 0, new_ndev - 1)
        new_cell = (g - dev_all * new_nloc).astype(cell.dtype)
        dev_of = dev_all[alive_idx]

    counts = np.bincount(dev_of, minlength=new_ndev)
    cap = int(counts.max()) if counts.size else 1
    cap = max(-(-cap * 5 // 4) // 128 * 128 + 128, 128)
    if options.fused_pusher and cap >= options.fused_block:
        blk = options.fused_block
        cap = -(-cap // blk) * blk

    # rows keep their order within a bucket
    order = np.argsort(dev_of, kind="stable")
    rows = alive_idx[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dev_sorted = dev_of[order]
    dest = dev_sorted * cap + np.arange(rows.size) - starts[dev_sorted]

    out = {}
    for fname, a in fields.items():
        if a is None:
            out[fname] = None
            continue
        a = np.asarray(a)
        new = np.full((new_ndev * cap,) + a.shape[1:],
                      dead_default(fname, is_photon), a.dtype)
        src = new_cell if fname == "cell" else a
        new[dest] = src[rows]
        out[fname] = new
    return out
