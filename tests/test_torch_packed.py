"""The packed fused path: opal_tpu's packed layout, its Pallas kernel
(``fused_push_deposit_packed``, run in interpret mode as opal_tpu's own
tests run it on the CPU), its sort and edge migration and its
``Simulation`` path against the port's, on the same seeded inputs.

Tolerances:

* ``pack_fused``/``unpack_fused``, ``sort_packed`` (as multisets, but
  gamma) and ``migrate_edges_packed`` move values without arithmetic:
  bitwise equal.  ``sort_packed`` rebuilds gamma as sqrt(1 + |u|^2) in
  f32, which XLA contracts into multiply-adds on the CPU and PyTorch
  does not: within rtol 1e-6.  ``lax.sort`` is not stable, so sorted
  states are compared as multisets (lexsorted), each ordered by its key.
* The packed kernel against the Pallas kernel: the cell column, the
  miss column and the next anchors are equal; every float column is
  held within 1e-6 of its largest magnitude (~8 f32 ulps) and the
  deposit slab within 1e-5 of its largest entry, the tolerances of
  ``tests/test_torch_fused.py``, for the same reason (XLA's CPU backend
  contracts multiply-adds, the port's CPU ops do not; the slab adds in
  another order).  Bitwise equality of the packed kernel is held where
  both sides round alike: the packed plain version against the column
  plain version here, and the CUDA kernel against the packed plain
  version on a card (the ``cuda``-marked test, and ``chip_smoke.py``).
* ``Simulation.run`` with ``packed_fused`` against opal_tpu's packed
  run, one device: fields, currents and particle columns within 1e-5
  of each array's largest magnitude, energies within rtol 1e-5 (the
  f32 rounding above, carried over the steps), as
  ``tests/test_torch_sim.py`` holds the column path.
"""

import collections
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import opal_tpu.cli as jcli
import opal_tpu_torch.cli as tcli
from opal_tpu import constants as const
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.ops import fused as JF
from opal_tpu.parallel import migrate as JM
from opal_tpu.sim import SimOptions as JOptions
from opal_tpu.sim import Simulation as JSim
from opal_tpu.sim import counter_total
from opal_tpu.species import ParticleState as JState
from opal_tpu.species import SpeciesSpec as JSpec
from opal_tpu.species import initialize as jinit
from opal_tpu_torch.convert import fields_from_numpy, state_from_numpy, to_numpy
from opal_tpu_torch.diagnostics.fits import read_image
from opal_tpu_torch.grid import HALO, GridGeometry
from opal_tpu_torch.ops import fused as TF
from opal_tpu_torch.parallel import migrate as TM
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize
from tests.test_torch_fused import ORDERS, _order_rows

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
NX = 40
N_SLAB = NX + 2 * HALO
N_ROWS = N_SLAB + 2 * TF.PAD
BS, NBLK, RB = 256, 3, 2
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
_ELECTRON = (const.ELECTRON_CHARGE, const.ELECTRON_MASS, 1.0)
_CARBON = (6.0 * const.ELEMENTARY_CHARGE, 12.0 * const.PROTON_MASS, 1e3)
#: the packed forms: (pusher, dep_skip, charge, mass, field scale); the
#: ion fields are 1000x the electron ones, so that the Boris rotation
#: turns a carbon ion as far as the Vay push turns an electron
FORMS = {
    "vay_packed": ("vay", False, *_ELECTRON),
    "vay_packed_dep_skip": ("vay", True, *_ELECTRON),
    "boris_packed": ("boris", False, *_CARBON),
    "boris_packed_dep_skip": ("boris", True, *_CARBON),
}


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _jstate(cols):
    fields = {f.name: None for f in dataclasses.fields(JState)}
    fields.update({k: jnp.asarray(v) for k, v in cols.items()})
    return JState(**fields)


def _one_device(fn, *args):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(),) * len(args), out_specs=P(),
        check_vma=False,
    ))(*args)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of each packed kernel form, and of the column
    kernel as ``column``, that ``Simulation`` makes (on the CPU the
    wrappers run the plain versions and count no launch)."""
    calls = collections.Counter()
    packed, column = TF.fused_push_deposit_packed, TF.fused_push_deposit

    def packed_spy(spec, *args):
        calls[TF.packed_form_name(spec)] += 1
        return packed(spec, *args)

    def column_spy(spec, *args):
        calls["column"] += 1
        return column(spec, *args)

    monkeypatch.setattr(TF, "fused_push_deposit_packed", packed_spy)
    monkeypatch.setattr(TF, "fused_push_deposit", column_spy)
    return calls


# ---------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------


def _species_cols(kind, work_dtype, seed=5):
    """A 512-row electron or carbon state at f32 with dead rows, some of
    them with a stale non-zero weight that packing must zero, and
    non-zero work, prev_x and chi columns."""
    geom = GridGeometry(nx=32, dx=DX, xmin=0.0, n_devices=1)
    spec = (SpeciesSpec.electron() if kind == "electron"
            else SpeciesSpec.ion("carbon", 6.0, 12.0))
    st = initialize(
        spec, geom, 12,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.2 * nr, uy=lambda x, u, nr: 0.05 * nr,
        uz=lambda x, u, nr: 0.01 * nr, dt=DT, capacity_per_device=512,
        seed=seed, dtype=np.float32, work_dtype=work_dtype, device="cpu",
    )
    cols = to_numpy(st)
    rng = np.random.default_rng(seed)
    n = cols["x"].shape[0]
    cols["weight"][-7:] = 3.0  # dead rows (the tail) with a weight
    cols["prev_x"] = rng.random(n).astype(np.float32)
    cols["chi"] = rng.random(n).astype(np.float32)
    if cols.get("work") is not None:
        cols["work"] = rng.normal(0.0, 1e-17, n).astype(work_dtype)
    return cols


@pytest.mark.parametrize("kind,work_dtype", [
    ("electron", np.float32), ("ion", np.float32), ("electron", np.float64),
], ids=["electron-f32", "ion", "electron-mixed"])
def test_pack_unpack_matches_opal_tpu(kind, work_dtype):
    """The packed matrices, and the state unpacked from them, bitwise
    equal to opal_tpu's: with the work and tau columns (electrons),
    without them (ions: a zero work column, no tau), and with an f64
    work column (mixed precision), which the layout carries at f32."""
    cols = _species_cols(kind, work_dtype)
    alive = cols["alive"]
    assert (cols["weight"][~alive] != 0).any()
    jst, tst = _jstate(cols), state_from_numpy(cols, device="cpu")
    jps, tps = JF.pack_fused(jst, 256), TF.pack_fused(tst, 256)
    assert tps.h.shape == (2, len(TF.H_COLS), 2, 128)
    assert tps.aux.shape == (2, len(TF.A_COLS), 2, 128)
    for name in ("h", "aux", "weight"):
        np.testing.assert_array_equal(getattr(tps, name).numpy(),
                                      np.asarray(getattr(jps, name)),
                                      err_msg=name)
    assert (tps.weight.numpy().reshape(-1)[~alive] == 0).all()
    if kind == "ion":
        assert tps.tau is None and jps.tau is None
        assert not tps.h[:, 8].any()
    else:
        np.testing.assert_array_equal(tps.tau.numpy(), np.asarray(jps.tau))
    jback, tback = JF.unpack_fused(jps, jst), TF.unpack_fused(tps, tst)
    got = to_numpy(tback)
    assert got.keys() == cols.keys()
    for k, v in got.items():
        want = np.asarray(getattr(jback, k))
        assert v.dtype == want.dtype == cols[k].dtype, k
        np.testing.assert_array_equal(v, want, err_msg=k)
    np.testing.assert_array_equal(got["alive"], alive)
    if work_dtype == np.float64:
        # the f64 work column went through f32
        np.testing.assert_array_equal(
            got["work"], cols["work"].astype(np.float32).astype(np.float64))
        assert (got["work"] != cols["work"]).any()


# ---------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------


def _inputs(seed=0, order="sorted"):
    """A cell-sorted f32 state of 3 blocks of 256 (or the rows of another
    of ``tests/test_torch_fused.py``'s ``ORDERS``) with dead tail rows,
    rows outside their block's window (misses), rows past the deposit
    reach, momenta that move some rows across cells, and non-zero E and
    B tables; as column arrays and as the packed (H, weight)."""
    rng = np.random.default_rng(seed)
    n = BS * NBLK
    cell = np.sort(rng.integers(0, NX, n)).astype(np.int32)
    cell, perm = _order_rows(order, cell, BS, rng)
    cell[5] = cell[5] + 25          # beyond any window of block 0
    cell[300] = -3                  # outside the deposit reach
    cell[301] = NX + HALO - 1
    u = rng.normal(0.0, 0.4, (3, n))
    weight = np.full(n, 1e7, np.float32)
    weight[-20:] = 0.0              # dead rows
    f32 = lambda a: np.asarray(a, np.float32)
    st = dict(
        cell=cell, x=f32(rng.random(n)), y=f32(rng.normal(0, 1, n)),
        z=f32(rng.normal(0, 1, n)), ux=f32(u[0]), uy=f32(u[1]),
        uz=f32(u[2]), gamma=f32(np.sqrt(1.0 + (u ** 2).sum(0))),
        weight=weight, work=f32(rng.normal(0.0, 1e-20, n)),
    )
    E = rng.normal(0.0, 100.0, (N_SLAB, 3))
    B = rng.normal(0.0, 1e-6, (N_SLAB, 3))
    if perm is not None:
        p = perm()
        st = {k: v[p] for k, v in st.items()}
    H = np.stack([st[c].astype(np.float32).reshape(NBLK, RB, 128)
                  for c in TF.H_COLS], axis=1)
    return st, H, st["weight"].reshape(NBLK, RB, 128), E, B


def _packed_specs(form, window=16):
    pusher, dep_skip, charge, mass, _ = FORMS[form]
    kw = dict(block=BS, window=window, n_rows=N_ROWS, dx=DX, dt=DT,
              charge=charge, mass=mass, pusher=pusher,
              row_off=HALO + TF.PAD, dep_skip=dep_skip)
    return JF.FusedSpec(**kw), TF.FusedSpec(**kw)


def _tables(form, E, B):
    scale = FORMS[form][-1]
    return (JF.make_eb_rows(jnp.asarray(E * scale), jnp.asarray(B * scale)),
            TF.make_eb_rows(_t(E * scale), _t(B * scale)))


#: (form, order) cases: every form on sorted rows (named by the form
#: alone, as before the other orders), and ``vay_packed`` on the orders
#: that break the CUDA deposit's fast path
CASES = [pytest.param(form, "sorted", id=form) for form in FORMS] + [
    pytest.param("vay_packed", order, id=f"vay_packed-{order}")
    for order in ORDERS[1:]]


@pytest.mark.parametrize("form,order", CASES)
def test_packed_kernel_matches_pallas(form, order):
    st, H, W, E, B = _inputs(order=order)
    jspec, tspec = _packed_specs(form)
    assert TF.packed_form_name(tspec) == form
    eb_j, eb_t = _tables(form, E, B)
    anch = np.asarray(JF.block_anchors(jspec, jnp.asarray(st["cell"])))
    Hj, Aj, oj, aj = JF.fused_push_deposit_packed(
        jspec, jnp.asarray(anch), jnp.asarray(H), jnp.asarray(W), eb_j,
        interpret=True,
    )
    Ht, At, ot, at = TF.fused_push_deposit_packed(
        tspec, _t(anch), _t(H), _t(W), eb_t)
    Hj, Aj = np.asarray(Hj), np.asarray(Aj)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj),
                                  err_msg="anchors_next")
    assert Ht.shape == H.shape and At.shape == (NBLK, 4, RB, 128)
    miss = Aj[:, 3]
    assert 0 < miss.sum() < miss.size / 2  # misses exercised
    np.testing.assert_array_equal(At[:, 3].numpy(), miss, err_msg="miss")
    np.testing.assert_array_equal(Ht[:, 0].numpy(), Hj[:, 0], err_msg="cell")
    assert (Hj[:, 0] != H[:, 0]).any()  # cells shift
    for mat_t, mat_j, names in ((Ht, Hj, TF.H_COLS[1:]),
                                (At, Aj, TF.A_COLS[:3])):
        for name in names:
            c = (TF.H_COLS if mat_t is Ht else TF.A_COLS).index(name)
            want = mat_j[:, c]
            np.testing.assert_allclose(
                mat_t[:, c].numpy(), want, rtol=0,
                atol=1e-6 * np.abs(want).max(), err_msg=name)
    # rows not updated: prev_x = x, gh 1, chi 0 (:997-1000)
    upd = (miss == 0) & (W > 0)
    for mat in (At.numpy(), Aj):
        assert (mat[:, 2][~upd] == 1).all() and (mat[:, 1][~upd] == 0).all()
        np.testing.assert_array_equal(mat[:, 0][~upd], H[:, 1][~upd])
    if FORMS[form][0] == "boris":
        # ions: chi 0, the work column passed through
        assert not At[:, 1].any()
        np.testing.assert_array_equal(Ht[:, 8].numpy(), H[:, 8])
    else:
        assert (At[:, 1].numpy()[upd] > 0).all()
    oj = np.asarray(oj)
    if tspec.dep_skip:
        assert ot is None and not oj.any()
        return
    assert np.abs(oj).max() > 0
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-5 * np.abs(oj).max(), err_msg="out")


@pytest.mark.parametrize("pusher", ["vay", "boris"])
def test_packed_plain_matches_column_plain(pusher):
    """The packed plain version against the column plain version on the
    same rows (``tests/test_fused_packed.py:68`` in opal_tpu): the full
    Vay form with the work column, and lite Boris; every shared output
    bitwise equal.  Packed Boris also writes chi 0, its own gamma as gh
    and passes the work column through."""
    st, H, W, E, B = _inputs(1)
    form = pusher + "_packed"
    _, pspec = _packed_specs(form)
    cspec = pspec._replace(work_out=pusher == "vay", lite=pusher == "boris")
    _, eb = _tables(form, E, B)
    cell = _t(st["cell"])
    anch = TF.block_anchors(cspec, cell)
    cols, miss, out, anext = TF.fused_push_deposit_reference(
        cspec, anch, cell, *(_t(st[c]) for c in TF.H_COLS[1:8]),
        _t(st["weight"]), _t(st["work"]) if pusher == "vay" else None, eb)
    Hn, An, out_p, anext_p = TF.fused_push_deposit_packed_reference(
        pspec, anch, _t(H), _t(W), eb)
    flat = lambda a: a.reshape(-1)
    assert torch.equal(anext_p, anext) and torch.equal(out_p, out)
    assert torch.equal(flat(An[:, 3]), miss)
    assert torch.equal(flat(Hn[:, 0]), cols["cell"].to(torch.float32))
    for c, name in enumerate(TF.H_COLS[1:8], start=1):
        assert torch.equal(flat(Hn[:, c]), cols[name]), name
    if pusher == "vay":
        assert torch.equal(flat(Hn[:, 8]), cols["work"])
        for c, name in enumerate(("prev_x", "chi", "gh")):
            assert torch.equal(flat(An[:, c]), cols[name]), name
    else:
        assert torch.equal(Hn[:, 8], _t(H[:, 8]))
        assert not An[:, 1].any()
        # gh, the gamma after the first half of the electric kick, on
        # the updated rows: > 1 there, and 1 elsewhere
        upd = (miss == 0) & (_t(st["weight"]) > 0)
        assert (flat(An[:, 2])[upd] > 1).all()
        assert (flat(An[:, 2])[~upd] == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form,order", CASES)
def test_cuda_packed_kernel_matches_plain(form, order):
    """On a card: the packed CUDA kernel reproduces the packed plain
    version's hot and aux matrices and anchors bit for bit, counts one
    launch of its form, and the slab within 1e-5 of its largest entry
    (float atomics add in no fixed order); without the deposit there is
    no slab."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st, H, W, E, B = _inputs(order=order)
    _, spec = _packed_specs(form)
    scale = FORMS[form][-1]
    eb = TF.make_eb_rows(_t(E * scale, "cuda"), _t(B * scale, "cuda"))
    anch = TF.block_anchors(spec, _t(st["cell"], "cuda"))
    args = (spec, anch, _t(H, "cuda"), _t(W, "cuda"), eb)
    before = dict(TF.fused_push_deposit_packed.launches)
    Hk, Ak, ok, ak = TF.fused_push_deposit_packed(*args)
    before[form] += 1
    assert TF.fused_push_deposit_packed.launches == before
    Hr, Ar, orf, ar = TF.fused_push_deposit_packed_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(Hk, Hr) and torch.equal(Ak, Ar) and torch.equal(ak, ar)
    if spec.dep_skip:
        assert ok is None and orf is None
        return
    assert (ok - orf).abs().max().item() <= 1e-5 * orf.abs().max().item()


# ---------------------------------------------------------------------
# sort and edge migration
# ---------------------------------------------------------------------

SNX = 32


def _packed_of(cols, block=256):
    """(opal_tpu's, the port's) PackedState of one host state."""
    return (JF.pack_fused(_jstate(cols), block),
            TF.pack_fused(state_from_numpy(cols, device="cpu"), block))


def _flat_packed(ps):
    """A PackedState's rows as host columns by name."""
    h, aux, w = (np.asarray(a) for a in (ps.h, ps.aux, ps.weight))
    n = w.size
    cols = {c: h[:, i].reshape(n) for i, c in enumerate(TF.H_COLS)}
    cols.update({c: aux[:, i].reshape(n) for i, c in enumerate(TF.A_COLS)})
    cols["weight"] = w.reshape(n)
    if ps.tau is not None:
        cols["tau"] = np.asarray(ps.tau)
    return cols


def _electrons(npc, cap, seed):
    geom = GridGeometry(nx=SNX, dx=DX, xmin=0.0, n_devices=1)
    st = initialize(
        SpeciesSpec.electron(), geom, npc,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.2 * np.sign(u - 0.5) + 0.05 * nr,
        uy=lambda x, u, nr: 0.05 * nr, uz=lambda x, u, nr: 0.01 * nr,
        dt=DT, capacity_per_device=cap, seed=seed, dtype=np.float32,
        device="cpu",
    )
    return to_numpy(st)


def test_sort_packed_matches_opal_tpu():
    cols = _electrons(12, 512, seed=3)
    perm = np.random.default_rng(1).permutation(512)
    cols = {k: v[perm] for k, v in cols.items()}
    jps, tps = _packed_of(cols)
    js, jcell = jax.jit(lambda p: JM.sort_packed(p, SNX))(jps)
    ts, tcell = TM.sort_packed(tps, SNX)
    jc, tc = _flat_packed(js), _flat_packed(ts)
    np.testing.assert_array_equal(tcell.numpy(), tc["cell"])
    np.testing.assert_array_equal(np.asarray(jcell), jc["cell"])
    n_alive = int(cols["alive"].sum())
    for c in (jc, tc):
        alive = c["weight"] > 0
        assert alive[:n_alive].all() and not alive[n_alive:].any()
        key = np.where(alive, 2 * c["cell"].astype(np.int64)
                       + (c["ux"] > 0), 2**30)
        assert (np.diff(key) >= 0).all()
        np.testing.assert_array_equal(c["cell"][~alive], SNX - 1)
        np.testing.assert_array_equal(c["prev_x"], c["x"])
        assert not c["chi"].any() and not c["miss"].any()
        assert (c["gh"] == 1).all()

    def lexsorted(c):
        a = c["weight"] > 0
        order = np.lexsort((c["ux"][a], c["x"][a], c["cell"][a]))
        return {k: v[a][order] for k, v in c.items()}

    js_, ts_ = lexsorted(jc), lexsorted(tc)
    for k in jc:
        if k == "gamma":
            np.testing.assert_allclose(ts_[k], js_[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(ts_[k], js_[k], err_msg=k)


#: (nblk, npc): 8 blocks with the alive/dead boundary (1280) on a block
#: edge, 8 with it in the upper half of its block (1728 = 6 * 256 +
#: 192), and 3 blocks, too few for two windows of kb = 2 blocks
EDGE_CASES = {"windowed": (8, 40), "upper-half-block": (8, 54),
              "whole-array": (3, 16)}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_migrate_edges_packed_matches_opal_tpu(case):
    """Leavers at both ends of a sorted packed state (cells -1 and SNX,
    as a push leaves them) through both packages' packed edge
    exchange, at one periodic device: the state bitwise equal, the
    overflow equal and zero, every leaver back inside."""
    nblk, npc = EDGE_CASES[case]
    cap = nblk * 256
    st = TM.sort_state(state_from_numpy(_electrons(npc, cap, seed=4),
                                        device="cpu"), SNX)
    cols = to_numpy(st)
    alive = cols["alive"]
    left = np.flatnonzero(alive & (cols["cell"] == 0))[:6]
    right = np.flatnonzero(alive & (cols["cell"] == SNX - 1))[-5:]
    cols["cell"][left] = -1
    cols["cell"][right] = SNX
    jps, tps = _packed_of(cols)
    kb = max(2, -(-256 // 256))
    assert (nblk < 2 * kb) == (case == "whole-array")
    if case == "upper-half-block":
        assert alive.sum() % 256 >= 128
    jg = JGeom(nx=SNX, dx=DX, xmin=0.0, n_devices=1)
    tg = GridGeometry(nx=SNX, dx=DX, xmin=0.0, n_devices=1)
    js, jovf = _one_device(
        lambda p: JM.migrate_edges_packed(p, jg, "x", 0, 64, 256), jps)
    ts, tovf = TM.migrate_edges_packed(tps, tg, 64, 256)
    assert int(tovf) == int(jovf) == 0
    jc, tc = _flat_packed(js), _flat_packed(ts)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    a = tc["weight"] > 0
    assert a.sum() == alive.sum()
    assert ((tc["cell"] >= 0) & (tc["cell"] < SNX))[a].all()


# ---------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------


def close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


def _by_tau(cols):
    """Alive rows ordered by tau, which names each electron (the non-QED
    step never changes it)."""
    a = cols["alive"]
    order = np.argsort(cols["tau"][a])
    return {k: v[a][order] for k, v in cols.items()}


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_packed_run_matches_opal_tpu(precision, kernel_calls):
    """A periodic two-stream run at npc 1 (unique sort keys) through
    both packages' packed path at one device, 24 steps: maintenance
    sorts every 4 steps, exchanges every 3 and drift enough that rows
    cross the periodic edge.  At mixed precision the work column rides
    the packed matrix at f32 and comes back as f64 holding an f32 value,
    equal to opal_tpu's within the f32 tolerance."""
    nx, npc, cap, nsteps = 32, 1, 512, 24
    mixed = precision == "mixed"
    kw = dict(dt=DT, fused_pusher=True, packed_fused=True, fused_block=256,
              fused_window=40, fused_resort_every=4,
              fused_misfit_capacity=128, migration_every=3,
              migration_window=512, migration_capacity=64)
    fdt = dict(jax=jnp.float64 if mixed else jnp.float32,
               torch=torch.float64 if mixed else torch.float32)
    jgeom = JGeom(nx=nx, dx=DX, xmin=0.0, n_devices=1)
    jsim = JSim(jgeom, JOptions(**kw), {"electron": JSpec.electron()},
                dtype=jnp.float32, field_dtype=fdt["jax"])
    host = jinit(
        JSpec.electron(), jgeom, npc,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.2 * np.sign(u - 0.5),
        uy=lambda x, u, nr: 0.05 * nr, uz=lambda x, u, nr: np.zeros_like(x),
        dt=DT, capacity_per_device=cap, seed=0, dtype=np.float32,
        work_dtype=np.float64 if mixed else np.float32,
    )
    E, B, J, rho = (np.array(a) for a in jsim.init_fields())
    B[:, 2] = 1e-7  # a gyrating orbit: every push term is non-zero
    jout = jsim.run(
        *(jnp.asarray(a) for a in (E, B, J, rho)),
        {"electron": jsim.shard_particles(host)}, 0.0, jax.random.key(0),
        jsim.zero_counters(), nsteps,
    )
    tsim = Simulation(GridGeometry(nx=nx, dx=DX, xmin=0.0, n_devices=1),
                      SimOptions(**kw), {"electron": SpeciesSpec.electron()},
                      device="cpu", dtype=torch.float32,
                      field_dtype=fdt["torch"])
    tout = tsim.run(*fields_from_numpy(E, B, J, rho, device="cpu"),
                    {"electron": state_from_numpy(host, device="cpu")}, 0.0,
                    tsim.zero_counters(), nsteps)
    assert kernel_calls == {"vay_packed": nsteps}
    assert counter_total(jout[6]["electron"]) == 0
    assert int(tout[6]["electron"]) == 0
    for i, name in enumerate(("E", "B", "J", "rho")):
        close(to_numpy(tout[i]), jout[i], 1e-5, name)
    names = ("alive", "tau", "cell", "x", "ux", "uy", "uz", "gamma", "work",
             "y", "weight")
    jp = _by_tau({k: np.asarray(getattr(jout[4]["electron"], k))
                  for k in names})
    tp = _by_tau(to_numpy(tout[4]["electron"]))
    assert len(tp["tau"]) == nx * npc
    np.testing.assert_array_equal(tp["tau"], jp["tau"])
    np.testing.assert_array_equal(tp["weight"], jp["weight"])
    dpos = (tp["cell"] + tp["x"].astype(np.float64)) \
        - (jp["cell"] + jp["x"].astype(np.float64))
    assert np.abs((dpos + nx / 2) % nx - nx / 2).max() < 1e-5
    moved = (jp["cell"] + jp["x"]) - (host.cell + host.x)[host.alive][
        np.argsort(host.tau[host.alive])]
    assert np.abs(moved).max() > nx / 2  # rows crossed the periodic edge
    for k in ("ux", "uy", "uz", "gamma", "y", "work"):
        close(tp[k], jp[k], 1e-5, k)
    work = tp["work"]
    assert work.dtype == (np.float64 if mixed else np.float32)
    assert np.abs(work).max() > 0
    np.testing.assert_array_equal(work.astype(np.float32).astype(work.dtype),
                                  work)


#: the mini hole_boring deck of tests/test_torch_hole_boring.py, with the
#: packed layout and 60 steps (the thermal slab before the pulse)
HB_PACKED = """\
control:
 dx: micro / 100
 nx: 800
 xmin: -2*micro
 start: -2.0e-6/c
 end: -1.425e-6/c
 current_deposition: true
 n_outputs: 1
qed:
 photon_emission: false
 photon_absorption: false
electrons:
 npc: 10
 ne: density * critical(omega) * step(x,xmin,xmax)
 ux: sqrt(kT/(m*c^2)) * nrand
 uy: sqrt(kT/(m*c^2)) * nrand
 uz: sqrt(kT/(m*c^2)) * nrand
 output: [x:px]
ions:
 name: carbon
 npc: 10
 Z: Z
 A: A
 ni: density * critical(omega) * step(x,xmin,xmax) / Z
 ux: sqrt(kT/(A*mp*c^2)) * nrand
 uy: sqrt(kT/(A*mp*c^2)) * nrand
 uz: sqrt(kT/(A*mp*c^2)) * nrand
 output: [x:px]
laser:
 Ey: (a0*me*c*omega/e) * gauss_pulse_re(t,x,omega,sigma)
 Ez: (a0*me*c*omega/e) * gauss_pulse_im(t,x,omega,sigma)
constants:
 density: 4.0
 a0: 10.0
 omega: 2*pi*c/0.8e-6
 sigma: pi * 2.0 / sqrt(ln(2.0))
 kT: 500 * eV
 Z: 6.0
 A: 12.0
 xmin: -0.5 * micro
 xmax: 1.5 * micro
tpu:
 fused_block: 128
 fused_window: 40
 fused_resort_every: 8
 fused_subblocks: 1
 packed_fused: 1
"""


def test_packed_hole_boring_matches_opal_tpu(tmp_path, kernel_calls):
    """A small hole_boring deck with ``tpu: packed_fused: 1`` built by
    both CLIs at mixed precision and run through ``Simulation.run``:
    electrons through the packed Vay form, carbon ions through packed
    Boris, the non-periodic packed edge exchange; the fields and each
    species' energy within the f32 tolerance, no loss."""
    deck = tmp_path / "deck.yaml"
    deck.write_text(HB_PACKED)
    jsim, jsp, rp = jcli.build(deck, n_devices=1, dtype=jnp.float32,
                               field_dtype=jnp.float64)
    tsim, tsp, _ = tcli.build(deck, device="cpu")
    assert jsim.options.packed_fused and tsim.options.packed_fused
    steps = rp["total_steps"]
    assert steps == 60
    jout = jsim.run(*jsim.init_fields(), jsp, rp["tstart"],
                    jax.random.key(0), jsim.zero_counters(), steps)
    tout = tsim.run(*tsim.init_fields(), tsp, rp["tstart"],
                    tsim.zero_counters(), steps)
    assert kernel_calls == {"vay_packed": steps, "boris_packed": steps}
    for name in ("electron", "ion"):
        assert counter_total(jout[6][name]) == 0 and int(tout[6][name]) == 0
        assert isinstance(tout[4][name].cell, torch.Tensor)
        ke_j = jsim.total_kinetic_energy(name, jout[4][name])
        ke_t = tsim.total_kinetic_energy(name, tout[4][name])
        np.testing.assert_allclose(ke_t, ke_j, rtol=1e-5, err_msg=name)
        assert int(tout[4][name].alive.sum()) == int(jout[4][name].alive.sum())
    for i, name in enumerate(("E", "B", "J", "rho")):
        close(to_numpy(tout[i]), jout[i], 1e-5, name)
    assert np.abs(to_numpy(tout[2])).max() > 0


def _dep_off_run(packed, calls):
    """Electrons gyrating in a uniform B_z with deposition off (J stays
    0, so the field advance preserves B): ``tests/test_fused_dep_off.py``
    at one device."""
    dx = 1.0e-6
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    nx, npc = 32, 64
    geom = GridGeometry(nx=nx, dx=dx, xmin=0.0, n_devices=1)
    opts = SimOptions(
        dt=dt, current_deposition=False, migration_capacity=512,
        fused_pusher=packed, packed_fused=packed, fused_block=256,
        fused_window=32, fused_misfit_capacity=512, fused_resort_every=3,
    )
    sim = Simulation(geom, opts, {"electron": SpeciesSpec.electron()},
                     device="cpu", dtype=torch.float32)
    state = initialize(
        SpeciesSpec.electron(), geom, npc,
        density=lambda x: np.full_like(x, 1.0e6),
        ux=lambda x, u, n: np.full_like(x, 2.0) * np.sign(u - 0.5),
        uy=lambda x, u, n: 0.1 * n, uz=lambda x, u, n: np.zeros_like(x),
        dt=dt, capacity_per_device=2 * nx * npc, seed=7, dtype=np.float32,
        device="cpu",
    )
    E, B, J, rho = sim.init_fields()
    B[:, 2] = 2.0 * const.ELECTRON_MASS / (const.ELEMENTARY_CHARGE * 50 * dt)
    n0 = int(state.alive.sum())
    calls.clear()
    E, B, J, rho, species, t, counters = sim.run(
        E, B, J, rho, {"electron": state}, 0.0, sim.zero_counters(), 60)
    assert calls == ({"vay_packed_dep_skip": 60} if packed else {})
    st = species["electron"]
    assert int(st.alive.sum()) == n0 and int(counters["electron"]) == 0
    assert not J.any() and not rho.any()
    w = torch.where(st.alive, st.weight, 0.0).double()
    mom = lambda a: float((w * a.double()).sum())
    return dict(ke=sim.total_kinetic_energy("electron", st),
                sux=mom(st.ux), suy=mom(st.uy),
                sx=mom(st.x.double() + st.cell.double()))


def test_packed_dep_off_matches_unfused(kernel_calls):
    """Deposition off, the packed path (``vay_packed_dep_skip``) against
    the unfused ops, with ``tests/test_fused_dep_off.py``'s tolerances:
    kinetic energy and the weighted position sum within rtol 1e-5, the
    momentum sums within 2e-4 of their scale."""
    ref = _dep_off_run(False, kernel_calls)
    got = _dep_off_run(True, kernel_calls)
    assert got["ke"] == pytest.approx(ref["ke"], rel=1e-5)
    scale = max(abs(ref["sux"]), abs(ref["suy"]), 1e-30)
    assert got["sux"] == pytest.approx(ref["sux"], abs=2e-4 * scale)
    assert got["suy"] == pytest.approx(ref["suy"], abs=2e-4 * scale)
    assert got["sx"] == pytest.approx(ref["sx"], rel=1e-5)


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------


def _cli_deck(path: Path):
    """tests/test_torch_cli.py's mini two_stream deck (nx 128, npc 16,
    40 steps, 2 outputs), with the packed layout."""
    src = (ROOT / "examples" / "two_stream.yaml").read_text()
    src = src.replace("nx: 1000", "nx: 128").replace("npc: 100", "npc: 16")
    src = src.replace("end: 0.1", "end: 6.4e-5")
    src = src.replace("n_outputs: 20", "n_outputs: 2")
    path.mkdir()
    (path / "deck.yaml").write_text(src + "\ntpu:\n packed_fused: 1\n")
    return path / "deck.yaml"


def _energies(path):
    return {k: float(v) for k, v in
            (line.split() for line in path.read_text().splitlines())}


def test_cli_packed_outputs_match(tmp_path, capsys, kernel_calls):
    """The mini two_stream deck with ``tpu: packed_fused: 1`` through
    ``opal_tpu.cli.main`` and ``opal_tpu_torch.cli.main --device cpu``:
    the same banner, every step through the packed Vay form and none
    through the column kernel, and the outputs within the tolerances of
    ``tests/test_torch_cli.py`` (grid columns within 1e-5 of their
    scale, energies within rtol 1e-5, the x:px images within four
    particle quanta)."""
    jdeck, tdeck = _cli_deck(tmp_path / "jax"), _cli_deck(tmp_path / "torch")
    assert jcli.main([str(jdeck), "--devices", "1"]) == 0
    jout = capsys.readouterr()
    assert tcli.main([str(tdeck), "--device", "cpu"]) == 0
    tout = capsys.readouterr()
    for o in (jout, tout):
        assert "[fused pusher: electron]" in o.out
        assert "Output    2 at t =" in o.out
        assert "warning" not in o.err
    assert tout.out.splitlines()[1:3] == jout.out.splitlines()[1:3]
    steps = int(6.4e-5 / DT) // 2 * 2
    assert kernel_calls == {"vay_packed": steps}
    jd, td = jdeck.parent, tdeck.parent
    for i in range(3):
        g_j = np.loadtxt(jd / f"{i}_grid.dat")
        g_t = np.loadtxt(td / f"{i}_grid.dat")
        assert g_t.shape == (128, 11)
        for c in range(11):
            close(g_t[:, c], g_j[:, c], 1e-5, f"{i}_grid.dat column {c}")
        e_j = _energies(jd / f"{i}_energy.dat")
        e_t = _energies(td / f"{i}_energy.dat")
        assert e_t.keys() == e_j.keys() and e_t["electrons"] > 0
        for k in e_j:
            np.testing.assert_allclose(e_t[k], e_j[k], rtol=1e-5, err_msg=k)
        im_j, _ = read_image(jd / f"{i}_electron_x-px.fits")
        im_t, _ = read_image(td / f"{i}_electron_x-px.fits")
        assert np.abs(im_t - im_j).sum() <= 4 * im_j.sum() / (128 * 16)
