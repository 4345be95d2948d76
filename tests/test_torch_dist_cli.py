"""The port's entry points on several ranks: ``python -m opal_tpu_torch
deck.yaml --devices N --device cpu`` and ``python -m
opal_tpu_torch.bench --devices N --device cpu`` (``gloo`` ranks, one
process each), against opal_tpu's CLI at ``--devices N`` on as many
virtual devices:

* a two_stream deck (the domain mode) and a hole_boring deck whose
  slab lies on one of the two slabs, which opal_tpu's rule runs in the
  replicated-field mode: the same banner, and every output file of
  rank 0 equal to opal_tpu's within round-off (energies within 1e-12,
  the grid within 1e-12 of its scale, the histograms' totals within
  1e-12);
* an absorption deck that the rule runs replicated (its pairing across
  the ranks): the same banner and outputs, to the same tolerances;
* more ranks than cards is an error before any rank starts;
* the bench twin on two ranks prints one loss-free JSON line.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from opal_tpu import cli as jcli
from opal_tpu.diagnostics import fits as jfits
from opal_tpu_torch import bench as tbench
from opal_tpu_torch import cli as tcli
from opal_tpu_torch.parallel import dist
from tests.test_torch_hole_boring import MINI as HB_MINI
from tests.test_torch_qed import MINI as QED_MINI

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _ranks_time_out(monkeypatch):
    """The entry points start their ranks without a time limit: here
    each start gets one, so a hang fails the test.  Each rank takes one
    thread: the test workers already share the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    real = dist.launch
    monkeypatch.setattr(dist, "launch",
                        lambda *a, **kw: real(*a, **{**kw, "timeout": 300}))


def _deck(tmp_path, name, src):
    path = tmp_path / name
    path.mkdir(parents=True)
    (path / "deck.yaml").write_text(src)
    return path / "deck.yaml"


def _two_stream():
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    return (src.replace("nx: 1000", "nx: 96").replace("npc: 100", "npc: 10")
            .replace("end: 0.1", "end: 6.0e-5")
            .replace("n_outputs: 20", "n_outputs: 2"))


def _energies(path):
    return {k: float(v) for k, v in
            (line.split() for line in path.read_text().splitlines())}


def _run_both(tmp_path, capfd, src):
    """The deck through both CLIs at ``--devices 2 --f64`` (the port on
    two ``gloo`` ranks): the port's banner, after checking that it is
    opal_tpu's, that the port printed no warning and rank 0 alone
    printed, and that every output file of the two runs agrees."""
    t = _deck(tmp_path, "torch", src)
    j = _deck(tmp_path, "jax", src)
    assert tcli.main([str(t), "--devices", "2", "--device", "cpu",
                      "--f64"]) == 0
    tout = capfd.readouterr()
    assert jcli.main([str(j), "--devices", "2", "--f64"]) == 0
    jout = capfd.readouterr()
    banner = tout.out.splitlines()[0]
    assert banner.replace("cpu", "") == jout.out.splitlines()[0].replace(
        "cpu", ""), (banner, jout.out)
    assert "warning" not in tout.err
    # the other rank prints nothing: one banner, one line an output
    assert tout.out.count("Running 2 tasks") == 1
    files = sorted(p.name for p in j.parent.iterdir() if p.name[0].isdigit())
    assert files and files == sorted(
        p.name for p in t.parent.iterdir() if p.name[0].isdigit())
    for name in files:
        a, b = t.parent / name, j.parent / name
        if name.endswith("_energy.dat"):
            ea, eb = _energies(a), _energies(b)
            assert ea.keys() == eb.keys()
            for k in ea:
                assert ea[k] == pytest.approx(eb[k], rel=1e-12, abs=1e-300), k
        elif name.endswith("_grid.dat"):
            ga, gb = np.loadtxt(a), np.loadtxt(b)
            np.testing.assert_allclose(ga, gb, rtol=0,
                                       atol=1e-12 * np.abs(gb).max())
        else:
            ha, hb = jfits.read_image(a), jfits.read_image(b)
            np.testing.assert_allclose(ha[0].sum(), hb[0].sum(), rtol=1e-12)
    return banner


@pytest.mark.parametrize("deck", ["two_stream", "hole_boring"])
def test_cli_matches_opal_tpu(deck, tmp_path, capfd):
    src = _two_stream() if deck == "two_stream" else HB_MINI.replace(
        "end: -0.1e-6/c", "end: -1.4e-6/c")
    banner = _run_both(tmp_path, capfd, src)
    assert ("replicated fields" in banner) == (deck == "hole_boring")


def test_replicated_absorption_deck_is_refused(tmp_path, capfd):
    """No more: the 4-step QED burst deck with absorption, which the rule
    runs replicated, runs on the two ranks with its pairing across them
    and matches opal_tpu's run."""
    src = QED_MINI.format(steps=4, tpu="").replace(
        "photon_absorption: false", "photon_absorption: true")
    assert "replicated fields" in _run_both(tmp_path, capfd, src)


def test_more_ranks_than_cards_is_an_error(tmp_path, capsys):
    deck = _deck(tmp_path, "ts", _two_stream())
    assert tcli.main([str(deck), "--devices", "2"]) == 1
    err = capsys.readouterr().err
    assert "2 ranks need 2 CUDA devices and this machine has" in err
    assert tcli.main([str(deck), "--coordinator", "localhost:1"]) == 1
    assert "--coordinator requires" in capsys.readouterr().err
    assert tbench.main(["--devices", "2"]) == 1


def test_bench_twin_on_two_ranks(capfd):
    assert tbench.main(["--device", "cpu", "--particles", "8192", "--nx",
                        "64", "--fused-block", "256", "--steps", "8",
                        "--devices", "2"]) == 0
    lines = [l for l in capfd.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    res = json.loads(lines[0])
    assert "error" not in res and res["value"] > 0 and res["device"] == "cpu"
