"""Whole runs of the port on several ``gloo`` ranks against opal_tpu on as
many virtual devices, and against the port's own world of 1.

Both packages build the deck with their CLI's ``build`` and step it in
``Simulation.run`` calls, the port on N processes
(``tests/test_torch_dist_ranks.py``), opal_tpu under its ``shard_map``;
the energies (summed over the ranks) are compared after every call:

* f64 (the unfused ops, the compact migration between ranks): a
  two_stream deck at nx 96 at N = 2 and 4, and a hole_boring deck (a
  laser, absorbing edges, deletion at the domain's edges, a slab that
  straddles the ranks' boundary) at N = 2 in the domain mode and in the
  replicated-field mode, over 100 and 200 steps: within 1e-12 of each
  curve's scale of opal_tpu at the same N and mode, and of the port's
  world of 1, except for the hole_boring deck in the domain mode:
  there opal_tpu's own two-device run parts from its one-device run
  (the last owned cell's B takes the halo's E, which each rank
  advances without its neighbour's current), and the port's parts
  alike, so that the first step's fields differ from the world of 1's
  in that cell alone;
* mixed precision on the packed layout (the plain kernels on the CPU,
  opal_tpu's Pallas kernel in interpret mode) at N = 2: within f32
  tolerance;
* QED emission at N = 2 at f64 with opal_tpu's draws replayed rank by
  rank (each device's key folded with its index, ``opal_tpu/sim.py:
  1176``): energies within 1e-10 and equal photon counts.

No package may count a loss.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import cli as jcli
from opal_tpu.sim import counter_total
from opal_tpu_torch import cli as tcli
from opal_tpu_torch.interactions import emission_widths
from tests.test_torch_dist_ranks import run_ranks
from tests.test_torch_hole_boring import MINI as HB_MINI
from tests.test_torch_qed import MINI as QED_MINI
from tests.test_torch_qed import _jax_draws

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
_J = {"f32": jnp.float32, "f64": jnp.float64}
_T = {"f32": torch.float32, "f64": torch.float64}


def _two_stream(tmp_path, name, extra=""):
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", "nx: 96").replace("npc: 100", "npc: 10")
    path = tmp_path / name
    path.mkdir()
    (path / "deck.yaml").write_text(src + extra)
    return path / "deck.yaml"


def _hole_boring(tmp_path, name, replicate):
    # nx 400: the ranks' boundary (interior cell 298, x = 0.98 um) lies
    # inside the slab (-0.5 .. 1.5 um), which the pulse reaches near
    # step 150
    src = HB_MINI.replace("nx: 800", "nx: 400")
    src += f" replicate_fields: {int(replicate)}\n"
    path = tmp_path / name
    path.mkdir()
    (path / "deck.yaml").write_text(src)
    return path / "deck.yaml"


def _jax_curve(deck, n, steps, every, dtype="f64", field_dtype="f64",
               keys=None):
    """opal_tpu's energies after each call (field, then each species),
    its counters and alive counts; ``keys(i)`` gives call i's key."""
    jsim, jsp, rp = jcli.build(deck, n_devices=n, dtype=_J[dtype],
                               field_dtype=_J[field_dtype])
    st = (*jsim.init_fields(), jsp, rp["tstart"])
    jc = jsim.zero_counters()
    curve = []
    for i in range(steps // every):
        key = keys(i) if keys else jax.random.key(0)
        out = jsim.run(*st, key, jc, every)
        st, jc = out[:6], out[6]
        curve.append([jsim.em_field_energy(st[0], st[1])] + [
            jsim.total_kinetic_energy(s, st[4][s]) for s in jsim.specs])
    alive = {s: int(np.asarray(st[4][s].alive).sum()) for s in jsim.specs}
    return (np.asarray(curve), {k: counter_total(v) for k, v in jc.items()},
            alive, jsim, rp)


def _port_solo(deck, steps, every, dtype="f64", field_dtype="f64"):
    """The port's world of 1, in this process."""
    sim, sp, rp = tcli.build(deck, dtype=_T[dtype],
                             field_dtype=_T[field_dtype], device="cpu")
    st = (*sim.init_fields(), sp, rp["tstart"])
    c = sim.zero_counters()
    curve = []
    for _ in range(steps // every):
        out = sim.run(*st, c, every)
        st, c = out[:6], out[6]
        curve.append([sim.em_field_energy(st[0], st[1])] + [
            sim.total_kinetic_energy(s, st[4][s]) for s in sim.specs])
    return np.asarray(curve)


def _close(got, want, rel, what):
    """Each column within ``rel`` of its curve's largest magnitude."""
    err = np.abs(got - want) / np.abs(want).max(axis=0)
    assert err.max() < rel, (what, err.max(axis=0))


@pytest.mark.parametrize("n", [2, 4])
def test_two_stream_f64_matches_opal_tpu(n, tmp_path):
    deck = _two_stream(tmp_path, f"ts{n}")
    steps, every = 100, 20
    want, jc, jalive, jsim, _ = _jax_curve(deck, n, steps, every)
    got = run_ranks(tmp_path, n, "run", deck=str(deck), steps=steps,
                    every=every)[0]
    assert not got["replicated"] and not jsim.options.replicate_fields
    assert got["n_loc"] == jsim.geom.n_loc == 96 // n
    assert got["counters"] == jc == {"electron": 0}
    assert got["alive"] == jalive
    assert want[-1, 0] > 10 * want[0, 0]  # the instability grows
    _close(got["curve"], want, 1e-12, "opal_tpu")
    _close(got["curve"], _port_solo(deck, steps, every), 1e-12, "world of 1")


@pytest.mark.parametrize("mode", ["domain", "replicated"])
def test_hole_boring_f64_matches_opal_tpu(mode, tmp_path):
    n, steps, every = 2, 200, 20
    deck = _hole_boring(tmp_path, mode, mode == "replicated")
    want, jc, jalive, jsim, rp = _jax_curve(deck, n, steps, every)
    got = run_ranks(tmp_path, n, "run", deck=str(deck), steps=steps,
                    every=every)[0]
    assert got["replicated"] == jsim.options.replicate_fields \
        == (mode == "replicated")
    assert got["capacities"] == rp["capacities"]
    assert got["counters"] == jc == {"electron": 0, "ion": 0}
    assert got["alive"] == jalive
    assert want[-1, 1] > 1.01 * want[0, 1]  # the laser heats
    _close(got["curve"], want, 1e-12, "opal_tpu")
    if mode == "replicated":
        _close(got["curve"], _port_solo(deck, steps, every), 1e-12,
               "world of 1")
        return
    # one step: the fields of the two ranks, gathered, against the world
    # of 1's; they part in B at the last cell of rank 0 and nowhere else
    one = run_ranks(tmp_path, n, "run", deck=str(deck), steps=1, every=1,
                    fields=True)[0]["fields"]
    sim, sp, rp = tcli.build(deck, dtype=torch.float64,
                             field_dtype=torch.float64, device="cpu")
    solo = sim.run(*sim.init_fields(), sp, rp["tstart"],
                   sim.zero_counters(), 1)
    for i, name in enumerate(("E", "B", "J", "rho")):
        a = solo[i].numpy().reshape(len(one[i]), -1)
        d = np.abs(one[i].reshape(a.shape) - a).max(axis=1)
        bad = np.flatnonzero(d > 1e-12 * np.abs(a).max())
        assert list(bad) == ([got["n_loc"] - 1] if name == "B" else []), \
            (name, bad)


def test_packed_mixed_precision_matches_opal_tpu(tmp_path):
    """The packed layout at N = 2 under mixed precision, blocks of 128
    rows, 24 steps with the sort and exchange cadences pinned short so
    that both run: energies within f32 tolerance of opal_tpu's."""
    tpu = ("tpu:\n packed_fused: 1\n fused_block: 128\n fused_window: 16\n"
           " fused_subblocks: 1\n fused_resort_every: 8\n"
           " migration_every: 4\n")
    deck = _two_stream(tmp_path, "packed", tpu)
    n, steps, every = 2, 24, 12
    want, jc, jalive, jsim, _ = _jax_curve(deck, n, steps, every, "f32",
                                           "f64")
    got = run_ranks(tmp_path, n, "run", deck=str(deck), steps=steps,
                    every=every, dtype="f32", field_dtype="f64")[0]
    assert got["fused"] == ["electron"] and jsim.options.packed_fused
    assert got["counters"] == jc == {"electron": 0}
    assert got["alive"] == jalive
    _close(got["curve"][:, 1:], want[:, 1:], 1e-5, "kinetic")
    np.testing.assert_allclose(got["curve"][:, 0], want[:, 0], rtol=1e-4)


def test_qed_emission_f64_replayed(tmp_path):
    """The QED burst deck at f64 with its electron beam straddling the
    ranks' boundary (x 1.98 um at nx 400), stepped at N = 2 with
    opal_tpu's draws of each device replayed on its rank: energies
    within 1e-10 of opal_tpu's, equal photon counts."""
    n, steps, every = 2, 200, 40
    src = QED_MINI.format(steps=steps, tpu="").replace(
        "xmin: 0.2 * micro", "xmin: 1.7 * micro").replace(
        "xmax: 0.7 * micro", "xmax: 2.2 * micro")
    path = tmp_path / "qed"
    path.mkdir()
    deck = path / "deck.yaml"
    deck.write_text(src)
    keys = lambda i: jax.random.key(100 + i)
    want, jc, jalive, jsim, rp = _jax_curve(deck, n, steps, every,
                                            keys=keys)
    n_e = rp["capacities"]["electron"]
    tsim, _, _ = tcli.build(deck, dtype=torch.float64,
                            field_dtype=torch.float64, device="cpu")
    m, mi = emission_widths(tsim.options, n_e)
    # step s of call i: split(key_i, every)[s], its second split, folded
    # with the device index (opal_tpu/sim.py:1171-1177, 1344)
    draws = [[], []]
    for i in range(steps // every):
        for k in jax.random.split(keys(i), every):
            sub = jax.random.split(k)[1]
            for r in range(n):
                draws[r].append(_jax_draws(jax.random.fold_in(sub, r), m, mi,
                                           np.float64))
    for r in range(n):
        (path / f"draws{r}.pkl").write_bytes(pickle.dumps(draws[r]))
    got = run_ranks(tmp_path, n, "run", deck=str(deck), steps=steps,
                    every=every, draws=str(path / "draws{rank}.pkl"))[0]
    assert got["counters"] == jc
    assert got["alive"] == jalive
    assert jalive["photon"] > 50
    _close(got["curve"], want, 1e-10, "opal_tpu")
