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
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opal_tpu import checkpoint as jckpt
from opal_tpu import cli as jcli
from opal_tpu.sim import counter_total
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
