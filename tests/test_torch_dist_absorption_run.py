"""A run with photon absorption in the replicated-field mode on two
``gloo`` ranks against opal_tpu on two virtual devices: the mini
colliding-beams crossing of ``tests/test_torch_absorption.py`` (its beam
density raised so that events fire, 8 candidates a photon, the event
log on) with ``tpu: replicate_fields: 1``, built by both CLIs' ``build``
and stepped 120 steps in ``Simulation.run`` calls of 40, with opal_tpu's
emission and absorption draws of each device replayed on its rank:

* at f64 (the unfused push, absorption over the per-step sort): the
  field, electron and photon energies after each call within 1e-10 of
  their scale, equal counters and alive counts, each rank's event ring
  equal in count and within 1e-10 in its records;
* at ``--f32`` with blocks of 128 rows (the kernel's full Vay form
  without the deposit, opal_tpu's Pallas kernel in interpret mode, the
  port's plain version; absorption over the brackets of the nearly
  sorted state): the field and electron energies within 1e-5 of their
  scale, and the photons at the distribution level, as
  ``tests/test_torch_qed.py``'s f32 slice holds them: each rank's events,
  the photons alive and the deferred work within 5%, the photons' energy
  within 1e-3 of its scale.  f32 rounding (XLA contracts multiply-adds
  that the port rounds) flips single emissions and events, at one device
  as at two.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import cli as jcli
from opal_tpu.sim import counter_total
from opal_tpu_torch import cli as tcli
from opal_tpu_torch import interactions as I
from opal_tpu_torch.parallel.dist import Ring
from tests.test_torch_absorption import MINI, _absorb_draws, _assert_close
from tests.test_torch_dist_ranks import run_ranks
from tests.test_torch_qed import _jax_draws

pytestmark = pytest.mark.unit

N, STEPS, EVERY = 2, 120, 40
_J = {"f32": jnp.float32, "f64": jnp.float64}
_T = {"f32": torch.float32, "f64": torch.float64}


def _rank_draws(keys, every, em_w, abs_w, n_ph, dtype):
    """Each rank's list of per-step draw dicts for calls with
    ``keys``: step s of a call takes split(key, every)[s]; absorption
    its first split's second key, emission the second key of the first
    key's split, each folded with the device index (opal_tpu/sim.py:
    1138-1177, 1344)."""
    draws = [[] for _ in range(N)]
    for key in keys:
        for k in jax.random.split(key, every):
            k_rest, sub = jax.random.split(k)
            sub2 = jax.random.split(k_rest)[1]
            for r in range(N):
                d = _absorb_draws(jax.random.fold_in(sub, r), *abs_w, n_ph,
                                  dtype)
                d.update(_jax_draws(jax.random.fold_in(sub2, r), *em_w,
                                    dtype))
                draws[r].append(d)
    return draws


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_replicated_absorption_run_matches_opal_tpu(precision, tmp_path):
    f32 = precision == "f32"
    tpu = " replicate_fields: 1\n" + (" fused_block: 128\n" if f32 else "")
    deck = tmp_path / "deck.yaml"
    deck.write_text(MINI.format(steps=STEPS, outputs=1, tpu=tpu))
    dt = _J[precision]
    jsim, jsp, rp = jcli.build(deck, n_devices=N, dtype=dt, field_dtype=dt)
    assert jsim.options.replicate_fields
    keys = [jax.random.key(200 + i) for i in range(STEPS // EVERY)]
    jst = (*jsim.init_fields(), jsp, rp["tstart"])
    jc, jev = jsim.zero_counters(), jsim.zero_events()
    want = []
    for key in keys:
        out = jsim.run(*jst, key, jc, EVERY, events=jev)
        jst, jc, jev = out[:6], out[6], out[7]
        want.append([jsim.em_field_energy(jst[0], jst[1])] + [
            jsim.total_kinetic_energy(s, jst[4][s]) for s in jsim.specs])
    want = np.asarray(want)
    jalive = {s: int(np.asarray(jst[4][s].alive).sum()) for s in jsim.specs}

    # the port's sizes at two ranks (build issues no collective)
    tsim, _, trp = tcli.build(deck, dtype=_T[precision],
                              field_dtype=_T[precision],
                              ring=Ring(rank=0, world=N, group=object()))
    assert trp["capacities"] == rp["capacities"]
    n_e, n_ph = (rp["capacities"][k] for k in ("electron", "photon"))
    draws = _rank_draws(keys, EVERY, I.emission_widths(tsim.options, n_e),
                        I.absorb_widths(tsim.options, n_e, n_ph, world=N),
                        n_ph, np.float32 if f32 else np.float64)
    for r in range(N):
        (tmp_path / f"draws{r}.pkl").write_bytes(pickle.dumps(draws[r]))
    got = run_ranks(tmp_path, N, "run", deck=str(deck), steps=STEPS,
                    every=EVERY, dtype=precision, field_dtype=precision,
                    draws=str(tmp_path / "draws{rank}.pkl"))
    g = got[0]
    assert g["replicated"]
    assert g["fused"] == (["electron"] if f32 else [])
    jcounters = {k: counter_total(v) for k, v in jc.items()}
    assert all(v == 0 for k, v in g["counters"].items()
               if k != "qed_deferred")
    assert jalive["photon"] > 50
    cap = tsim.options.event_log_capacity
    jring, jcount = np.asarray(jev[0]), np.asarray(jev[1])
    applied = {k: sum(res["applied"][k] for res in got)
               for k in ("absorbed", "stimulated")}
    assert applied["absorbed"] > 10 and applied["stimulated"] > 10, applied
    err = np.abs(g["curve"] - want) / np.abs(want).max(axis=0)
    counts = [int(res["events"][1]) for res in got]
    if f32:
        # f32 rounding flips single emissions and events (at one device
        # too), so the photons are held at the distribution level
        np.testing.assert_allclose(counts, jcount, rtol=0.05)
        np.testing.assert_allclose(g["alive"]["photon"], jalive["photon"],
                                   rtol=0.05)
        np.testing.assert_allclose(g["counters"]["qed_deferred"],
                                   jcounters["qed_deferred"], rtol=0.05)
        assert g["alive"]["electron"] == jalive["electron"]
        assert err[:, :2].max() < 1e-5 and err[:, 2].max() < 1e-3, \
            err.max(axis=0)
        return
    assert g["counters"] == jcounters and g["alive"] == jalive
    # the events of each rank: its ring against the device's
    for r, (ring, count) in enumerate(res["events"] for res in got):
        assert int(count) == int(jcount[r]), (r, int(count), jcount)
        n = min(int(count), cap)
        ref = jring[r * cap:r * cap + n]
        np.testing.assert_array_equal(ring[:n, 13], ref[:, 13])
        _assert_close(ring[:n], ref, f"rank {r} event ring", rtol=1e-10)
    assert err.max() < 1e-10, err.max(axis=0)
