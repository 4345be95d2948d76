"""The misfit fallback on the CPU: the port's plain version
(``ops.fused.misfit_fallback_reference``, which the step takes on CPU
tensors and which the CUDA kernel is held against on a card) against
opal_tpu's ``_fallback`` (``opal_tpu/sim.py:628-708``, and its packed
twin at ``:760-827``) on the same host state.

Both ``Simulation`` push methods run from the same kernel outputs: the
port's plain kernel computes them, and opal_tpu's kernel call is
replaced by those outputs, so that the fallback is all that differs.
The table has a fixed capacity with unused entries (and in one case
fewer entries than misfit rows), the state rows outside their window,
rows past the deposit reach on both sides and dead rows.  Losses and
cells must be equal; the float columns within 1e-6 of each column's
largest magnitude and the folded currents within 1e-5 of theirs, the
tolerances of ``tests/test_torch_fused.py`` for the same reason (XLA's
CPU backend contracts multiply-adds, the port's CPU ops do not; the
deposit adds in another order).

The plain version's own cases (an empty table, a table over capacity, a
row past the deposit reach) follow, as the CUDA kernel's tests hold
them on a card (``tests/test_torch_misfit_cuda.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import constants as const
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.ops import fused as JF
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.sim import Simulation as JSim
from opal_tpu.species import ParticleState as JState
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu_torch.convert import state_from_numpy
from opal_tpu_torch.grid import HALO, GridGeometry
from opal_tpu_torch.ops import fused as TF
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec

pytestmark = pytest.mark.unit

NX = 40
N_SLAB = NX + 2 * HALO
BS, NBLK, W = 256, 3, 16
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
FLOATS = ("x", "y", "z", "ux", "uy", "uz", "gamma")

#: (species, field dtype, field scale): electrons push with Vay (with
#: f64 fields the work column is f64 and the kernel outputs its
#: increment), carbon ions with Boris in fields 1000x the electrons'
SPECIES = {
    "vay": ("electron", np.float32, 1.0),
    "vay_work_inc": ("electron", np.float64, 1.0),
    "boris": ("carbon", np.float32, 1e3),
}


def _specs(species):
    if species == "electron":
        return JSpec.electron(), SpeciesSpec.electron()
    return JSpec.ion("carbon", 6, 12), SpeciesSpec.ion("carbon", 6, 12)


def _host(species, work_dtype, seed=5):
    """A cell-sorted state of 3 blocks with rows moved out of their
    block's window (misfits), two alive rows past the deposit reach
    (one on each side), dead rows (one of them out of its window) and
    momenta that move some rows across cells."""
    rng = np.random.default_rng(seed)
    n = BS * NBLK
    cell = np.sort(rng.integers(0, NX, n)).astype(np.int32)
    anchors_cell = cell.copy()
    for r in (5, 6, 7, 290, 291, 600):
        cell[r] += 20 if cell[r] < NX // 2 else -20
    cell[300] = -3                  # past the deposit reach, low side
    cell[301] = NX + HALO - 1       # past it, high side
    u = rng.normal(0.0, 0.4, (3, n))
    weight = np.full(n, 1e7)
    weight[-20:] = 0.0
    weight[8] = 0.0                 # dead, and out of its window
    cell[8] += 20
    f32 = lambda a: np.asarray(a, np.float32)
    cols = dict(
        cell=cell, x=f32(rng.random(n)), y=f32(rng.normal(0, 1, n)),
        z=f32(rng.normal(0, 1, n)), ux=f32(u[0]), uy=f32(u[1]),
        uz=f32(u[2]), gamma=f32(np.sqrt(1.0 + (u ** 2).sum(0))),
        weight=f32(weight), alive=weight > 0, prev_x=f32(rng.random(n)),
        chi=np.zeros(n, np.float32),
    )
    if species == "electron":
        cols["work"] = rng.normal(0.0, 1e-20, n).astype(work_dtype)
    return cols, anchors_cell


def _sims(species, field_dtype, capacity):
    kw = dict(dt=DT, fused_pusher=True, fused_block=BS, fused_window=W,
              fused_misfit_capacity=capacity, max_drift_cells_per_step=0.45)
    jspec, tspec = _specs(species)
    jsim = JSim(JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                JOptions(**kw), {species: jspec}, dtype=jnp.float32,
                field_dtype=jnp.dtype(field_dtype))
    tsim = Simulation(GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1),
                      SimOptions(**kw), {species: tspec}, device="cpu",
                      dtype=torch.float32,
                      field_dtype=getattr(torch, np.dtype(field_dtype).name))
    return jsim, tsim


def _jstate(cols):
    fields = {f.name: None for f in dataclasses.fields(JState)}
    fields.update({k: jnp.asarray(v) for k, v in cols.items()})
    return JState(**fields)


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


def _fields(field_dtype, scale):
    rng = np.random.default_rng(9)
    E = (rng.normal(0.0, 100.0, (N_SLAB, 3)) * scale).astype(field_dtype)
    B = (rng.normal(0.0, 1e-6, (N_SLAB, 3)) * scale).astype(field_dtype)
    return E, B


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree.numpy())


def _expected_losses(miss, cell, capacity):
    """The table's overflow, and the rows it holds whose cell lies past
    the deposit reach."""
    rows = np.flatnonzero(np.asarray(miss) > 0.5)
    held = cell[rows[:capacity]]
    past = (held < 2 - HALO) | (held > NX + HALO - 3)
    return max(0, rows.size - capacity) + int(past.sum())


#: (form, layout, capacity): each form in both layouts (the packed layout
#: accumulates the work in f32 in its hot matrix, so it has no work
#: increment), with a table of fixed capacity holding every misfit row
#: and one of 4 entries
CASES = [
    pytest.param(form, layout, cap, id=f"{form}-{layout}-{tag}")
    for form in SPECIES for layout in ("column", "packed")
    for cap, tag in ((64, "fixed"), (4, "over"))
    if not (layout == "packed" and form == "vay_work_inc")
]


@pytest.mark.parametrize("form,layout,capacity", CASES)
def test_fallback_matches_opal_tpu(form, layout, capacity, monkeypatch):
    species, field_dtype, scale = SPECIES[form]
    jsim, tsim = _sims(species, field_dtype, capacity)
    host, anchors_cell = _host(species, field_dtype)
    E, B = _fields(field_dtype, scale)
    tspec = tsim._fused_spec(species)
    anchors = TF.block_anchors(tspec, torch.from_numpy(anchors_cell))
    tst = state_from_numpy(host, device="cpu")
    jst = _jstate(host)
    Et, Bt = torch.from_numpy(E), torch.from_numpy(B)
    eb = TF.make_eb_rows(Et, Bt)

    if layout == "column":
        kernel = TF.fused_push_deposit(
            tspec, anchors, tst.cell, tst.x, tst.y, tst.z, tst.ux, tst.uy,
            tst.uz, tst.gamma, tst.weight,
            tst.work if tspec.work_out and not tspec.work_inc else None, eb)
        monkeypatch.setattr(JF, "fused_push_deposit", lambda *a, **k: tuple(
            _as_jax(t) for t in kernel))
        tout, out_slab, losses, _ = tsim._fused_push_deposit(
            species, tst, Et, Bt, anchors)
        jout, Jj, rj, movf, _ = jsim._fused_push_deposit(
            species, jst, jnp.asarray(E), jnp.asarray(B),
            jnp.asarray(anchors.numpy()))
        miss = kernel[1]
        got = {k: getattr(tout, k).numpy() for k in FLOATS + ("cell",)}
        want = {k: np.asarray(getattr(jout, k)) for k in got}
        if species == "electron":
            got["work"], want["work"] = tout.work.numpy(), np.asarray(jout.work)
    else:
        tps, jps = TF.pack_fused(tst, BS), JF.pack_fused(jst, BS)
        kernel = TF.fused_push_deposit_packed(tspec, anchors, tps.h,
                                              tps.weight, eb)
        monkeypatch.setattr(JF, "fused_push_deposit_packed",
                            lambda *a, **k: tuple(_as_jax(t) for t in kernel))
        tout, out_slab, losses, _ = tsim._packed_push_deposit(
            species, tps, Et, Bt, anchors)
        jout, Jj, rj, movf, _ = jsim._packed_push_deposit(
            species, jps, jnp.asarray(E), jnp.asarray(B),
            jnp.asarray(anchors.numpy()))
        miss = kernel[1][:, TF.A_COLS.index("miss")].reshape(-1)
        got = {c: tout.h[:, k].reshape(-1).numpy()
               for k, c in enumerate(TF.H_COLS)}
        want = {c: np.asarray(jout.h[:, k]).reshape(-1)
                for k, c in enumerate(TF.H_COLS)}
        for k, c in enumerate(TF.A_COLS):
            got["aux_" + c] = tout.aux[:, k].reshape(-1).numpy()
            want["aux_" + c] = np.asarray(jout.aux[:, k]).reshape(-1)

    assert int(miss.sum()) >= 8  # the moved rows, both past the reach
    assert int(losses) == int(movf) == _expected_losses(
        miss, host["cell"], capacity)
    np.testing.assert_array_equal(got.pop("cell"), want.pop("cell"))
    for k in got:
        if not np.abs(want[k]).max():
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            continue
        _close(got[k], want[k], 1e-6, k)
    Jt, rt = TF.fold_out_slab(out_slab)
    _close(Jt.numpy(), Jj, 1e-5, "J")
    _close(rt.numpy(), rj, 1e-5, "rho")


def _outputs(table):
    """A lite Vay kernel's outputs for the state of :func:`_host`, as the
    fallback's column-layout rows, with the misfit table ``table`` makes
    of its miss flags and what else the fallback takes."""
    host, anchors_cell = _host("electron", np.float32)
    E, B = (torch.from_numpy(a) for a in _fields(np.float32, 1.0))
    spec = TF.FusedSpec(block=BS, window=W, n_rows=N_SLAB + 2 * TF.PAD,
                        dx=DX, dt=DT, charge=const.ELECTRON_CHARGE,
                        mass=const.ELECTRON_MASS, row_off=HALO + TF.PAD)
    st = state_from_numpy(host, device="cpu")
    eb = TF.make_eb_rows(E, B)
    cols, miss, out, _ = TF.fused_push_deposit(
        spec, TF.block_anchors(spec, torch.from_numpy(anchors_cell)),
        st.cell, st.x, st.y, st.z, st.ux, st.uy, st.uz, st.gamma, st.weight,
        st.work, eb)
    mtab, losses = table(miss)
    return dict(spec=spec, mtab=mtab, rows=TF.column_rows(cols, BS),
                weight=st.weight, eb=eb, E=E, B=B, out=out, losses=losses,
                miss=miss, cell=host["cell"])


#: tables of the plain version's own cases, from a state's miss flags:
#: none of its entries used; more misfit rows than entries (the
#: compaction counts the overflow); one entry, the row past the deposit
#: reach on the low side, and unused entries after it
TABLES = {
    "empty": lambda miss: (torch.full((16,), miss.numel()),
                           torch.zeros((), dtype=torch.int64)),
    "over_capacity": lambda miss: TF.misfit_compact(miss, 3),
    "past_reach": lambda miss: (torch.tensor([300] + [miss.numel()] * 7),
                                torch.zeros((), dtype=torch.int64)),
}


@pytest.mark.parametrize("case", list(TABLES))
def test_fallback_reference_cases(case):
    o = _outputs(TABLES[case])
    rows, out, losses = o["rows"], o["out"], o["losses"]
    before = {c: v.clone() for c, v in rows.items()}
    out0, losses0 = out.clone(), int(losses)
    counts = torch.zeros(2, dtype=torch.int64)
    TF.misfit_fallback(o["spec"], o["mtab"], rows, o["weight"], o["eb"],
                       o["E"], o["B"], out, losses, counts)
    used = o["mtab"][o["mtab"] < o["weight"].numel()].tolist()
    assert counts.tolist() == [len(used), int(len(used) > 0)]
    # the table's rows move, each of them, and no other
    moved = set()
    for c, v in rows.items():
        moved |= set(torch.nonzero((v != before[c]).reshape(-1))[:, 0]
                     .tolist())
    assert moved == set(used)
    if case == "empty":
        assert torch.equal(out, out0) and int(losses) == losses0 == 0
    elif case == "over_capacity":
        assert len(used) == 3 and not torch.equal(out, out0)
        assert int(losses) == _expected_losses(o["miss"], o["cell"], 3)
        assert int(losses) == int((o["miss"] > 0.5).sum()) - 3
    else:
        # no taps, one loss
        assert torch.equal(out, out0) and int(losses) == 1
