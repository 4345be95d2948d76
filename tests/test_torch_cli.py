"""The CLI: a mini two_stream deck through ``opal_tpu.cli.main`` and
``opal_tpu_torch.cli.main``, in two directories, at the default mixed
precision.  The deck (nx 128, npc 16, 40 steps, 2 outputs) makes both
builds pick the fused kernel at block 1024, capacity 3072 and window
80, with the resort, migration and misfit capacities auto-sized alike.

Both runs differ by f32 rounding of the particle push (see
test_torch_sim.py), so the grid columns agree within 1e-5 of each
column's largest magnitude; the energies, printed to 7 digits, within
rtol 1e-5.  In the x:px histograms a particle sitting on a bin edge
may land in either bin, and a particle at an extreme may fall on either
side of the auto-ranged histogram's edge: the images' L1 distance is at
most two particles moving (4 particle quanta, a quantum being one
particle's share of the total), the image extrema within 2 quanta, and
the other header values within rtol 1e-6.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import opal_tpu.cli as jcli
import opal_tpu_torch.cli as tcli
from opal_tpu_torch.diagnostics.fits import read_image

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
N_PARTICLES = 128 * 16


def _mini_deck(path: Path):
    src = (EXAMPLES / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", "nx: 128").replace("npc: 100", "npc: 16")
    src = src.replace("end: 0.1", "end: 6.4e-5")
    src = src.replace("n_outputs: 20", "n_outputs: 2")
    path.mkdir()
    (path / "deck.yaml").write_text(src)
    return path / "deck.yaml"


def _energies(path):
    return {k: float(v) for k, v in
            (line.split() for line in path.read_text().splitlines())}


def test_two_stream_outputs_match(tmp_path, capsys):
    jdeck = _mini_deck(tmp_path / "jax")
    tdeck = _mini_deck(tmp_path / "torch")
    assert jcli.main([str(jdeck), "--devices", "1"]) == 0
    jout = capsys.readouterr()
    assert tcli.main([str(tdeck), "--device", "cpu"]) == 0
    tout = capsys.readouterr()
    for o in (jout, tout):
        assert "[fused pusher: electron]" in o.out
        assert "Output    2 at t =" in o.out
        assert "warning" not in o.err
    jd, td = jdeck.parent, tdeck.parent
    for i in range(3):
        g_j = np.loadtxt(jd / f"{i}_grid.dat")
        g_t = np.loadtxt(td / f"{i}_grid.dat")
        assert g_t.shape == (128, 11)
        for c in range(11):
            np.testing.assert_allclose(
                g_t[:, c], g_j[:, c], rtol=0,
                atol=1e-5 * np.abs(g_j[:, c]).max(),
                err_msg=f"{i}_grid.dat column {c}",
            )
        e_j = _energies(jd / f"{i}_energy.dat")
        e_t = _energies(td / f"{i}_energy.dat")
        assert e_t.keys() == e_j.keys() and e_t["electrons"] > 0
        for k in e_j:
            np.testing.assert_allclose(e_t[k], e_j[k], rtol=1e-5, err_msg=k)
        im_j, h_j = read_image(jd / f"{i}_electron_x-px.fits")
        im_t, h_t = read_image(td / f"{i}_electron_x-px.fits")
        quantum = im_j.sum() / N_PARTICLES
        assert np.abs(im_t - im_j).sum() <= 4 * quantum
        assert h_t.keys() == h_j.keys()
        for k, v in h_j.items():
            if k in ("DATAMIN", "DATAMAX"):
                assert abs(h_t[k] - v) <= 2 * quantum, k
            elif isinstance(v, float):
                np.testing.assert_allclose(h_t[k], v, rtol=1e-6, err_msg=k)
            else:
                assert h_t[k] == v, k


@pytest.mark.parametrize("deck,args,what", [
    ("colliding_beams.yaml", [], "QED"),
    ("two_stream.yaml", ["initialise_fields"], "electrostatic"),
    ("two_stream.yaml", ["--devices", "2"], "2-device"),
])
def test_refuses_unported_decks(deck, args, what, tmp_path, capsys):
    path = EXAMPLES / deck
    if args == ["initialise_fields"]:
        # the electrostatic field set-up, asked for by the deck
        path = tmp_path / deck
        path.write_text(
            (EXAMPLES / deck).read_text().replace(
                "control:\n", "control:\n initialise_fields: true\n", 1)
        )
        args = []
    assert tcli.main([str(path), *args, "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("opal_tpu_torch: ") and "not yet ported" in err
    assert what in err


def test_no_card_exits_without_running(tmp_path, capsys):
    """Without ``--device cpu`` the CLI runs on the CUDA device; with no
    card it exits 1 and names the missing device, writing no output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    deck = _mini_deck(tmp_path / "run")
    assert tcli.main([str(deck)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("opal_tpu_torch: no CUDA device")
    assert "--device cpu" in err
    assert not list(deck.parent.glob("*_energy.dat"))


def test_profile_writes_table_and_keeps_outputs(tmp_path, capsys):
    """``--profile DIR`` profiles the last output block: it writes the
    operator table and changes no output."""
    plain, prof = _mini_deck(tmp_path / "plain"), _mini_deck(tmp_path / "prof")
    assert tcli.main([str(plain), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert tcli.main([str(prof), "--device", "cpu",
                      "--profile", str(tmp_path / "trace")]) == 0
    err = capsys.readouterr().err
    assert "profile: " in err and "s wall" in err
    assert "aten::" in (tmp_path / "trace" / "profile.txt").read_text()
    for name in ("2_energy.dat", "2_grid.dat"):
        assert (prof.parent / name).read_text() == \
            (plain.parent / name).read_text(), name


def test_port_imports_no_jax():
    """Every module of the port imports without JAX or opal_tpu."""
    code = (
        "import importlib, pkgutil, sys, opal_tpu_torch\n"
        "for m in pkgutil.walk_packages(opal_tpu_torch.__path__,"
        " 'opal_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'opal_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('opal_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20
