"""The misfit fallback's CUDA kernel (``ops.fused.misfit_fallback`` on
CUDA tensors) against its plain version, on a card; every test skips
without one.

After the fused kernel (B1, column layout) or the packed one (B2) on a
state with rows outside their window, the fallback kernel and the plain
version push the same table into clones of the same outputs, in each
form the step reaches.  The kernel pushes with B1's own arithmetic and
gathers from B1's field table, the plain version with the unfused ops
(``fields_at``, ``vay_push``/``boris_push``, ``deposit_into_slab``): the
same f32 physics in another association.  Cells and losses must be
equal; the float columns within 1e-6 of each column's largest magnitude
and the slab within 1e-5 of its largest entry, the tolerances of
``tests/test_torch_fused.py`` (float atomics add in no fixed order).
Also: an empty table writes nothing in one launch, a table over
capacity leaves the overflow to the compaction's losses, a row past the
deposit reach adds no tap and one loss, and a small fused deck runs
under ``torch.cuda.set_sync_debug_mode("error")`` (no read of the
device inside ``Simulation.run``) to the same live count and losses.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from opal_tpu_torch import constants as const
from opal_tpu_torch.grid import HALO, GridGeometry
from opal_tpu_torch.ops import fused as F
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize

pytestmark = [pytest.mark.unit, pytest.mark.cuda]

NX = 40
N_SLAB = NX + 2 * HALO
BS, NBLK, W = 256, 3, 16
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
_ELECTRON = (const.ELECTRON_CHARGE, const.ELECTRON_MASS, 1.0)
_CARBON = (6.0 * const.ELEMENTARY_CHARGE, 12.0 * const.PROTON_MASS, 1e3)
#: the forms: (layout, pusher, work_inc, lite, dep_skip, charge, mass,
#: field scale)
FORMS = {
    "vay": ("column", "vay", False, True, False, *_ELECTRON),
    "vay_work_inc": ("column", "vay", True, True, False, *_ELECTRON),
    "vay_full": ("column", "vay", False, False, False, *_ELECTRON),
    "vay_full_work_inc_dep_skip": ("column", "vay", True, False, True,
                                   *_ELECTRON),
    "vay_dep_skip": ("column", "vay", False, True, True, *_ELECTRON),
    "boris": ("column", "boris", False, True, False, *_CARBON),
    "boris_dep_skip": ("column", "boris", False, True, True, *_CARBON),
    "vay_packed": ("packed", "vay", False, False, False, *_ELECTRON),
    "vay_packed_dep_skip": ("packed", "vay", False, False, True,
                            *_ELECTRON),
    "boris_packed": ("packed", "boris", False, False, False, *_CARBON),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(dev, seed=5):
    """A cell-sorted state of 3 blocks with rows moved out of their
    block's window, two alive rows past the deposit reach (one on each
    side) and dead rows; and the window bases of the sorted cells."""
    rng = np.random.default_rng(seed)
    n = BS * NBLK
    cell = np.sort(rng.integers(0, NX, n)).astype(np.int32)
    spec = F.FusedSpec(block=BS, window=W, n_rows=N_SLAB + 2 * F.PAD, dx=DX,
                       dt=DT, charge=1.0, mass=1.0, row_off=HALO + F.PAD)
    anchors = F.block_anchors(spec, torch.from_numpy(cell).to(dev))
    for r in (5, 6, 7, 290, 291, 600, 601):
        cell[r] += 20 if cell[r] < NX // 2 else -20
    cell[300] = -3
    cell[301] = NX + HALO - 1
    u = rng.normal(0.0, 0.4, (3, n))
    weight = np.full(n, 1e7)
    weight[-20:] = 0.0
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    st = dict(cell=torch.from_numpy(cell).to(dev), x=t(rng.random(n)),
              y=t(rng.normal(0, 1, n)), z=t(rng.normal(0, 1, n)),
              ux=t(u[0]), uy=t(u[1]), uz=t(u[2]),
              gamma=t(np.sqrt(1.0 + (u ** 2).sum(0))), weight=t(weight),
              work=t(rng.normal(0.0, 1e-20, n)))
    E = rng.normal(0.0, 100.0, (N_SLAB, 3))
    B = rng.normal(0.0, 1e-6, (N_SLAB, 3))
    return st, anchors, E, B


def _outputs(form, dev, capacity=64):
    """The kernel's outputs for the form, as the fallback's rows, the
    misfit table of ``capacity`` entries and what else the fallback
    takes."""
    layout, pusher, work_inc, lite, dep_skip, charge, mass, scale = \
        FORMS[form]
    st, anchors, E, B = _state(dev)
    spec = F.FusedSpec(block=BS, window=W, n_rows=N_SLAB + 2 * F.PAD, dx=DX,
                       dt=DT, charge=charge, mass=mass, pusher=pusher,
                       row_off=HALO + F.PAD, work_out=pusher == "vay",
                       work_inc=work_inc, lite=lite, dep_skip=dep_skip)
    E = torch.from_numpy(E * scale).float().to(dev)
    B = torch.from_numpy(B * scale).float().to(dev)
    eb = F.make_eb_rows(E, B)
    if layout == "column":
        work = st["work"] if spec.work_out and not work_inc else None
        cols, miss, out, _ = F.fused_push_deposit(
            spec, anchors, *(st[c] for c in (
                "cell", "x", "y", "z", "ux", "uy", "uz", "gamma", "weight")),
            work, eb)
        rows = F.column_rows(cols, BS)
        weight = st["weight"]
    else:
        if pusher == "boris":
            st["work"] = torch.zeros_like(st["x"])
        ps = F.pack_fused(_Columns(st), BS)
        h, aux, out, _ = F.fused_push_deposit_packed(spec, anchors, ps.h,
                                                     ps.weight, eb)
        miss = aux[:, F.A_COLS.index("miss")].reshape(-1)
        rows = F.packed_rows(h, aux)
        weight = ps.weight
    mtab, losses = F.misfit_compact(miss, capacity)
    return dict(spec=spec, mtab=mtab, rows=rows, weight=weight, eb=eb, E=E,
                B=B, out=out, losses=losses, miss=miss, cell=st["cell"])


class _Columns:
    """A state's columns as ``pack_fused`` reads them."""

    def __init__(self, st):
        self.__dict__.update(st)
        self.alive = st["weight"] > 0
        self.prev_x = st["x"]
        self.chi = self.tau = None


def _clone(o):
    """A copy of the fallback's in-place arguments; the rows are views
    into one buffer in the packed layout, so the copies are too."""
    bases = {}
    rows = {}
    for c, v in o["rows"].items():
        base = v._base if v._base is not None else v
        if id(base) not in bases:
            bases[id(base)] = (base, base.clone())
        src, dst = bases[id(base)]
        rows[c] = dst.as_strided(v.shape, v.stride(),
                                 v.storage_offset() - src.storage_offset())
    return dict(o, rows=rows, out=None if o["out"] is None else
                o["out"].clone(), losses=o["losses"].clone(),
                counts=torch.zeros(2, dtype=torch.int64,
                                   device=o["mtab"].device))


def _run(o, plain=False):
    fn = F.misfit_fallback_reference if plain else F.misfit_fallback
    args = (o["spec"], o["mtab"], o["rows"], o["weight"])
    rest = (o["E"], o["B"], o["out"], o["losses"], o["counts"])
    if plain:
        fn(*args, *rest)
    else:
        fn(*args, o["eb"], *rest)
    torch.cuda.synchronize()
    return o


def _assert_close(k, p, what):
    for c in p["rows"]:
        got, want = k["rows"][c], p["rows"][c]
        if c == "cell":
            assert torch.equal(got, want), (what, c)
            continue
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-6 * scale, (what, c)
    if p["out"] is not None:
        scale = p["out"].abs().max().item()
        assert (k["out"] - p["out"]).abs().max().item() <= 1e-5 * scale
    assert int(k["losses"]) == int(p["losses"]), what
    assert k["counts"].tolist() == p["counts"].tolist(), what


@pytest.mark.parametrize("capacity", [64, 3], ids=["fixed", "over"])
@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_matches_plain(form, capacity, dev):
    o = _outputs(form, dev, capacity)
    n_miss = int((o["miss"] > 0.5).sum())
    assert n_miss >= 9
    before = dict(F.misfit_fallback.launches)
    k = _run(_clone(o))
    p = _run(_clone(o), plain=True)
    layout = FORMS[form][0]
    name = (F.packed_form_name if layout == "packed" else F.form_name)(
        o["spec"])
    before[name] += 1
    assert F.misfit_fallback.launches == before
    _assert_close(k, p, form)
    used = min(n_miss, capacity)
    assert k["counts"].tolist() == [used, 1]
    # the table's rows moved
    held = o["mtab"][:used]
    for c in ("x", "ux"):
        flat = o["rows"][c]
        blk, pin = held // BS, held % BS
        assert (k["rows"][c][blk, pin] != flat[blk, pin]).all(), c
    if capacity < n_miss:
        assert int(o["losses"]) == n_miss - capacity


@pytest.mark.parametrize("form", ["vay", "vay_packed"])
def test_empty_table_writes_nothing_in_one_launch(form, dev):
    o = _outputs(form, dev)
    n = o["weight"].numel()
    o["mtab"] = torch.full((2048,), n, dtype=torch.int64, device=dev)
    k = _clone(o)
    rows0 = {c: v.clone() for c, v in k["rows"].items()}
    out0 = k["out"].clone()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(k)
    launched = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]
    assert len(launched) == 1 and "misfit_fallback" in launched[0], launched
    for c, v in k["rows"].items():
        assert torch.equal(v, rows0[c]), c
    assert torch.equal(k["out"], out0)
    assert int(k["losses"]) == int(o["losses"])
    assert k["counts"].tolist() == [0, 0]


@pytest.mark.parametrize("form", ["vay", "boris_packed"])
def test_row_past_the_reach_adds_no_tap_and_one_loss(form, dev):
    o = _outputs(form, dev)
    n = o["weight"].numel()
    o["mtab"] = torch.tensor([300] + [n] * 7, dtype=torch.int64, device=dev)
    assert int(o["cell"][300]) == -3 and float(o["miss"][300]) == 1.0
    k = _run(_clone(o))
    p = _run(_clone(o), plain=True)
    _assert_close(k, p, form)
    assert torch.equal(k["out"], o["out"])
    assert int(k["losses"]) == int(o["losses"]) + 1
    assert float(k["rows"]["ux"].reshape(-1)[300]) != float(
        o["rows"]["ux"].reshape(-1)[300])


def _deck(dev, packed):
    geom = GridGeometry(nx=64, dx=DX, xmin=0.0, n_devices=1)
    sim = Simulation(
        geom, SimOptions(dt=DT, fused_pusher=True, fused_block=128,
                         fused_window=12, fused_resort_every=8,
                         migration_every=4, max_drift_cells_per_step=0.45,
                         migration_window=256, migration_capacity=64,
                         fused_misfit_capacity=256, packed_fused=packed),
        {"electron": SpeciesSpec.electron()}, device=dev,
        dtype=torch.float32, field_dtype=torch.float32)
    st = initialize(
        SpeciesSpec.electron(), geom, 16,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.25 * np.sign(u - 0.5) * (1.0 + 0.2 * nr),
        uy=lambda x, u, nr: 0.05 * nr, uz=lambda x, u, nr: np.zeros_like(x),
        dt=DT, capacity_per_device=1536, seed=3, dtype=np.float32,
        work_dtype=np.float32, device=dev)
    return sim, st


@pytest.mark.parametrize("packed", [False, True], ids=["column", "packed"])
def test_run_reads_nothing_back(packed, dev):
    sim, st = _deck(dev, packed)

    def inputs():
        E, B, J, rho = sim.init_fields()
        B[:, 2] = 1e-7  # a gyrating orbit: rows leave their windows
        return (E, B, J, rho, {"electron": st}, 0.0, sim.zero_counters(), 24)

    def run(args):
        return sim.run(*args)

    tables = []
    real = F.misfit_compact

    def spy(miss, capacity, counts=None):
        mtab, losses = real(miss, capacity, counts)
        tables.append(mtab)
        return mtab, losses

    # the wrapper counts its launches on the name it is called by
    spy.launches = 0
    F.misfit_compact = spy
    try:
        plain = run(inputs())
    finally:
        F.misfit_compact = real
    assert sum(int((m < st.x.numel()).sum()) for m in tables) > 0, \
        "the deck's window should make misfits"
    args = inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        strict = run(args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for out in (plain, strict):
        assert int(out[6]["electron"]) == 0
    assert int(plain[4]["electron"].alive.sum()) == int(
        strict[4]["electron"].alive.sum())
