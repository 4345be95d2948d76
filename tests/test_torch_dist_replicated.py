"""The replicated-field mode at mixed precision on two ``gloo`` ranks
against opal_tpu on two virtual devices: the path that the shipped
nonuniform decks (hole_boring, colliding_beams) take by default on
several devices.

A mini hole_boring deck with ``tpu: replicate_fields: 1`` whose slab
reaches the grid's right edge, so that electrons leave the grid and are
deleted there, is stepped with f32 particles on the fused kernel and f64
fields, on the row layout and on the packed one (the plain kernels on
the CPU, opal_tpu's Pallas kernel in interpret mode).  Between the
maintenance sorts a row that crossed a cell boundary stays where it is
(a kernel misfit), and a leaver is marked dead in place
(``wrap_kill`` / ``wrap_kill_packed``).  Energies after each call are
held within f32 tolerance of opal_tpu's, and the alive counts and loss
counters must be equal.
"""

import pytest

from tests.test_torch_dist_ranks import run_ranks
from tests.test_torch_dist_sim import _close, _jax_curve
from tests.test_torch_hole_boring import MINI as HB_MINI

pytestmark = pytest.mark.unit


def _deck(tmp_path, packed):
    # nx 400: the grid ends at x = 2 um, inside the slab (-0.5 .. 2.5 um)
    src = (HB_MINI.replace("nx: 800", "nx: 400")
           .replace("xmax: 1.5 * micro", "xmax: 2.5 * micro"))
    src += " replicate_fields: 1\n" + (" packed_fused: 1\n" if packed else "")
    path = tmp_path / ("packed" if packed else "rows")
    path.mkdir()
    (path / "deck.yaml").write_text(src)
    return path / "deck.yaml"


@pytest.mark.parametrize("layout", ["rows", "packed"])
def test_replicated_mixed_precision_matches_opal_tpu(layout, tmp_path):
    n, steps, every = 2, 64, 16
    deck = _deck(tmp_path, layout == "packed")
    want, jc, jalive, jsim, rp = _jax_curve(deck, n, steps, every, "f32",
                                            "f64")
    got = run_ranks(tmp_path, n, "run", deck=str(deck), steps=steps,
                    every=every, dtype="f32", field_dtype="f64")[0]
    assert got["replicated"] and jsim.options.replicate_fields
    assert jsim.options.packed_fused == (layout == "packed")
    assert got["fused"] == ["electron", "ion"]
    assert got["capacities"] == rp["capacities"]
    assert got["counters"] == jc == {"electron": 0, "ion": 0}
    assert got["alive"] == jalive
    # electrons left the grid at its right edge and were deleted
    assert jalive["electron"] < got["alive0"]["electron"]
    _close(got["curve"], want, 1e-5, "opal_tpu")
