"""Checkpoints between the packages across rank counts and modes.

A two_stream deck at nx 96 and f64 (periodic: the domain and the
replicated modes step alike) is run some steps and snapshotted by one
package, then continued by the other from the file:

* opal_tpu's snapshot of 4 devices onto 2 port ranks;
* the port's snapshot of 2 ranks into opal_tpu at 2 and 4 devices, and
  into opal_tpu's replicated-field mode at 2 devices (a mode flip).

Each continuation's energies (summed over the ranks) must agree within
1e-12 of their scale with the writer's own continuation, with equal
alive counts and no loss.

A run with photon absorption in the replicated-field mode (the mini
colliding-beams deck of ``tests/test_torch_absorption.py`` with ``tpu:
replicate_fields: 1``, f64, 2 ranks, the ranks' generators) snapshotted
after 80 of 120 steps:

* the port resumed from its own file on 2 ranks is bitwise the
  continuous run (energies, counters, alive counts), its generators
  restored rank by rank;
* opal_tpu loads the port's file at 2 devices in the same mode: every
  species' energy at the snapshot within 1e-12 of the port's; it then
  continues on a fresh draw stream of the deck's seed, with the same
  alive electrons, no loss and the field energy within 1e-12 of the
  port's continuation (no deposition: the fields are the laser's);
* opal_tpu's snapshot of the same run is refused by each of the port's
  ranks, naming its threefry key: a QED run cannot continue opal_tpu's
  draws (``opal_tpu_torch/checkpoint.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import checkpoint as jckpt
from opal_tpu import cli as jcli
from opal_tpu.sim import counter_total
from opal_tpu_torch import checkpoint as tckpt
from opal_tpu_torch import cli as tcli
from opal_tpu_torch.parallel.dist import Ring
from tests.test_torch_absorption import MINI as ABS_MINI
from tests.test_torch_dist_ranks import run_ranks

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
STEPS, EVERY = 20, 10


def _deck(path: Path, replicate=None):
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", "nx: 96").replace("npc: 100", "npc: 10")
    if replicate is not None:
        src += f"tpu:\n replicate_fields: {int(replicate)}\n"
    path.mkdir(parents=True, exist_ok=True)
    (path / "deck.yaml").write_text(src)
    return path / "deck.yaml"


def _jax(deck, n, calls, load=False, save_at=None):
    """opal_tpu at n devices from the deck (or from the checkpoint
    beside it): the energies after each call of EVERY steps, alive
    counts and counters; ``save_at`` snapshots after that many calls."""
    sim, sp, rp = jcli.build(deck, n_devices=n, dtype=jnp.float64,
                             field_dtype=jnp.float64)
    st = (*sim.init_fields(), sp, rp["tstart"])
    c = sim.zero_counters()
    if load:
        _, t, E, B, J, rho, sp, _, c = jckpt.load(deck.parent, sim)
        st = (E, B, J, rho, sp, t)
    curve = []
    for i in range(calls):
        out = sim.run(*st, jax.random.key(0), c, EVERY)
        st, c = out[:6], out[6]
        curve.append([sim.em_field_energy(st[0], st[1]),
                      sim.total_kinetic_energy("electron", st[4]["electron"])])
        if save_at == i + 1:
            jckpt.save(deck.parent, i + 1, float(st[5]), *st[:4], st[4],
                       jax.random.key(0), c, n_devices=n,
                       n_loc=sim.geom.n_loc,
                       replicated=sim.options.replicate_fields)
    alive = int(np.asarray(st[4]["electron"].alive).sum())
    return np.asarray(curve), alive, {k: counter_total(v)
                                      for k, v in c.items()}


def _close(got, want, what):
    err = np.abs(np.asarray(got) - want) / np.abs(want).max(axis=0)
    assert err.max() < 1e-12, (what, err.max(axis=0))


def test_opal_tpus_four_devices_onto_two_ranks(tmp_path):
    deck = _deck(tmp_path / "j4")
    whole, alive, _ = _jax(deck, 4, 2 * STEPS // EVERY,
                           save_at=STEPS // EVERY)
    got = run_ranks(tmp_path, 2, "run", deck=str(deck), steps=STEPS,
                    every=EVERY, resume=True)[0]
    assert got["counters"] == {"electron": 0}
    assert got["alive"]["electron"] == alive
    _close(got["curve"], whole[STEPS // EVERY:], "port from opal_tpu's 4")


def test_ports_two_ranks_into_opal_tpu(tmp_path):
    deck = _deck(tmp_path / "t2")
    got = run_ranks(tmp_path, 2, "run", deck=str(deck), steps=2 * STEPS,
                    every=EVERY, save_at=STEPS // EVERY)[0]
    after = got["curve"][STEPS // EVERY:]
    for n, replicate in ((2, None), (4, None), (2, True)):
        d = _deck(tmp_path / f"j{n}{replicate}", replicate)
        (d.parent / "checkpoint.npz").write_bytes(
            (deck.parent / "checkpoint.npz").read_bytes())
        curve, alive, counters = _jax(d, n, STEPS // EVERY, load=True)
        assert counters == {"electron": 0}
        assert alive == got["alive"]["electron"]
        _close(curve, after, f"opal_tpu at {n}, replicated={replicate}")


def _absorption_deck(path: Path):
    path.mkdir(parents=True, exist_ok=True)
    (path / "deck.yaml").write_text(ABS_MINI.format(
        steps=120, outputs=1, tpu=" replicate_fields: 1\n"))
    return path / "deck.yaml"


_ABS = {}


def _port_absorption_run(tmp_path):
    """The port's continuous run on 2 ranks (3 calls of 40 steps, the
    snapshot after the second), once for the tests below."""
    if not _ABS:
        deck = _absorption_deck(tmp_path / "abs_whole")
        _ABS["deck"] = deck
        _ABS["whole"] = run_ranks(tmp_path, 2, "run", deck=str(deck),
                                  steps=120, every=40, save_at=2)[0]
    return _ABS["deck"], _ABS["whole"]


def test_replicated_absorption_resumes_bitwise(tmp_path):
    deck, whole = _port_absorption_run(tmp_path)
    assert whole["replicated"] and whole["applied"]["absorbed"] > 0
    got = run_ranks(tmp_path, 2, "run", deck=str(deck), steps=40, every=40,
                    resume=True)[0]
    np.testing.assert_array_equal(got["curve"], whole["curve"][2:])
    assert got["counters"] == whole["counters"]
    assert got["alive"] == whole["alive"]
    assert got["applied"]["absorbed"] > 0  # events after the resume


def test_replicated_absorption_checkpoint_between_packages(tmp_path):
    deck, whole = _port_absorption_run(tmp_path)
    # the port's file into opal_tpu at 2 devices, replicated
    sim, _, _ = jcli.build(deck, n_devices=2, dtype=jnp.float64,
                           field_dtype=jnp.float64)
    assert sim.options.replicate_fields
    _, t, E, B, J, rho, sp, key, c = jckpt.load(deck.parent, sim)
    at_save = [sim.em_field_energy(E, B)] + [
        sim.total_kinetic_energy(s, sp[s]) for s in sim.specs]
    _close([at_save], whole["curve"][1:2], "opal_tpu's load of the port's")
    out = sim.run(E, B, J, rho, sp, t, key, c, 40,
                  events=sim.zero_events())
    st, c = out[:6], out[6]
    assert all(counter_total(c[k]) == 0 for k in ("electron", "photon"))
    assert int(np.asarray(st[4]["electron"].alive).sum()) == \
        whole["alive"]["electron"]
    assert sim.em_field_energy(st[0], st[1]) == pytest.approx(
        whole["curve"][-1][0], rel=1e-12)
    # its own draws move the photons on
    assert sim.total_kinetic_energy("photon", st[4]["photon"]) != at_save[-1]
    # opal_tpu's own snapshot of the run refused by the port's ranks
    jdeck = _absorption_deck(tmp_path / "abs_jax")
    sim, sp, rp = jcli.build(jdeck, n_devices=2, dtype=jnp.float64,
                             field_dtype=jnp.float64)
    out = sim.run(*sim.init_fields(), sp, rp["tstart"], jax.random.key(3),
                  sim.zero_counters(), 40, events=sim.zero_events())
    jckpt.save(jdeck.parent, 1, float(out[5]), *out[:4], out[4],
               jax.random.key(3), out[6], n_devices=2, n_loc=sim.geom.n_loc,
               replicated=True)
    for rank in (0, 1):
        # a rank of two, whose group the load never reaches
        tsim, _, _ = tcli.build(jdeck, dtype=torch.float64,
                                field_dtype=torch.float64,
                                ring=Ring(rank=rank, world=2, group=object()))
        with pytest.raises(ValueError, match="threefry key"):
            tckpt.load(jdeck.parent, tsim)
