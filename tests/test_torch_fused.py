"""The fused gather + push + deposit: opal_tpu's Pallas kernel (run in
interpret mode, as opal_tpu's own tests run it on the CPU) against the
port's plain PyTorch version, at f32 in every form the step reaches:
lite Vay (electrons) with the work increment on and off, full Vay (the
QED outputs prev_x, gh and chi as well) and lite Boris (carbon ions, Z
6, A 12, no work column), each with the deposit on and skipped
(``dep_skip``); lite Vay also on rows in the orders that break the CUDA
deposit's fast path (shuffled within each block, one cell a block, two
cells alternating).  Also the host helpers around the kernel.

Tolerances: cells, miss flags and next-step anchors must be equal.
The float columns (prev_x, gh and chi too) agree within 1e-6 of each
column's largest magnitude
(~8 f32 ulps): both evaluate the same f32 operation sequence, but XLA's
CPU backend contracts multiply-adds into FMAs and the port's CPU ops do
not, which moves results by a few ulps of the operands' magnitude, also
on components that cancel toward zero.  The deposit slab sums particles
in another order (a one-hot matmul against a scatter-add): within 1e-5
of its largest entry.  Without the deposit the Pallas kernel returns a
zero slab and the port none.

The CUDA kernel against the plain version needs a card and is marked
``cuda``; it skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opal_tpu import constants as const
from opal_tpu.ops import fused as JF
from opal_tpu_torch.grid import HALO
from opal_tpu_torch.ops import fused as TF

pytestmark = pytest.mark.unit

NX = 40
N_SLAB = NX + 2 * HALO
N_ROWS = N_SLAB + 2 * TF.PAD
BS, NBLK = 128, 3
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
COLS = ("cell", "x", "y", "z", "ux", "uy", "uz", "gamma")


#: row orders of the inputs: cell-sorted, and three that break the CUDA
#: deposit's fast path (one tile row a warp): rows shuffled within each
#: block, every row of a block in one cell (the block's middle row's),
#: and two cells alternating row by row
ORDERS = ("sorted", "shuffled", "one_cell", "alternating")


def _order_rows(order, cell, block, rng):
    """The cells of ``order`` from sorted ``cell``, and the permutation
    to apply to every column once all are drawn (None but for
    ``shuffled``, which draws it from ``rng`` last, so the other orders'
    draws are the sorted inputs' draws)."""
    n = cell.shape[0]
    if order in ("one_cell", "alternating"):
        mid = np.repeat(cell[block // 2::block], block)
        step = np.arange(n) % 2 if order == "alternating" else 0
        return (mid + step).astype(np.int32), None
    if order == "shuffled":
        return cell, lambda: np.concatenate(
            [b * block + rng.permutation(block) for b in range(n // block)])
    return cell, None


def _inputs(seed=0, order="sorted"):
    """A cell-sorted f32 state of 3 blocks (or the rows of another of
    :data:`ORDERS`) with: dead tail rows, rows pushed out of their
    block's window (misses), rows past the deposit reach, and momenta
    that move some rows across cells; a non-zero E and B table."""
    rng = np.random.default_rng(seed)
    n = BS * NBLK
    cell = np.sort(rng.integers(0, NX, n)).astype(np.int32)
    cell, perm = _order_rows(order, cell, BS, rng)
    cell[5] = cell[5] + 25          # beyond any window of block 0
    cell[200] = -3                  # outside the deposit reach
    cell[201] = NX + HALO - 1
    u = rng.normal(0.0, 0.4, (3, n))
    weight = np.full(n, 1e7)
    weight[-20:] = 0.0              # dead rows
    f32 = lambda a: np.asarray(a, np.float32)
    st = dict(
        cell=cell, x=f32(rng.random(n)), y=f32(rng.normal(0, 1, n)),
        z=f32(rng.normal(0, 1, n)), ux=f32(u[0]), uy=f32(u[1]),
        uz=f32(u[2]), gamma=f32(np.sqrt(1.0 + (u ** 2).sum(0))),
        weight=f32(weight), work=f32(rng.normal(0.0, 1e-20, n)),
    )
    E = rng.normal(0.0, 100.0, (N_SLAB, 3))
    B = rng.normal(0.0, 1e-6, (N_SLAB, 3))
    if perm is not None:
        p = perm()
        st = {k: v[p] for k, v in st.items()}
    return st, E, B


#: the forms of the kernel: (pusher, work_inc, species charge and mass,
#: field scale).  The ion fields are 1000x the electron ones, so that
#: the Boris rotation turns a carbon ion's momentum as far as the Vay
#: push turns an electron's.
_ELECTRON = (const.ELECTRON_CHARGE, const.ELECTRON_MASS, 1.0)
_CARBON = (6.0 * const.ELEMENTARY_CHARGE, 12.0 * const.PROTON_MASS, 1e3)
#: the forms of the kernel: (pusher, work_inc, lite, dep_skip, species
#: charge and mass, field scale)
FORMS = {
    "vay": ("vay", False, True, False, *_ELECTRON),
    "vay_work_inc": ("vay", True, True, False, *_ELECTRON),
    "boris": ("boris", False, True, False, *_CARBON),
    "vay_dep_skip": ("vay", False, True, True, *_ELECTRON),
    "vay_full": ("vay", False, False, False, *_ELECTRON),
    "vay_full_work_inc_dep_skip": ("vay", True, False, True, *_ELECTRON),
    "boris_dep_skip": ("boris", False, True, True, *_CARBON),
}


def _specs(window, form):
    pusher, work_inc, lite, dep_skip, charge, mass, _ = FORMS[form]
    work_out = pusher == "vay"
    kw = dict(block=BS, window=window, n_rows=N_ROWS, dx=DX, dt=DT,
              charge=charge, mass=mass, pusher=pusher, row_off=HALO + TF.PAD,
              work_out=work_out, work_inc=work_inc, lite=lite,
              dep_skip=dep_skip)
    return JF.FusedSpec(**kw), TF.FusedSpec(**kw)


#: (window, form, order) cases; the Vay ids keep the (window, work_inc)
#: names they had before the Boris form was added, and the sorted cases
#: the names they had before the other row orders
CASES = [
    pytest.param(16, "vay_work_inc", "sorted", id="16-True"),
    pytest.param(40, "vay", "sorted", id="40-False"),
    pytest.param(24, "boris", "sorted", id="24-boris"),
    pytest.param(16, "vay_dep_skip", "sorted", id="16-vay-dep_skip"),
    pytest.param(16, "vay_full", "sorted", id="16-vay-full"),
    pytest.param(16, "vay_full_work_inc_dep_skip", "sorted",
                 id="16-vay-full-work_inc-dep_skip"),
    pytest.param(16, "boris_dep_skip", "sorted", id="16-boris-dep_skip"),
] + [pytest.param(40, "vay", order, id=f"40-False-{order}")
     for order in ORDERS[1:]]
FULL = ("prev_x", "gh", "chi")


def _work_name(spec):
    work = () if not spec.work_out else ("winc",) if spec.work_inc \
        else ("work",)
    return work + (() if spec.lite else FULL)


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


@pytest.mark.parametrize("window,form,order", CASES)
def test_kernel_matches_pallas(window, form, order):
    st, E, B = _inputs(order=order)
    E, B = E * FORMS[form][-1], B * FORMS[form][-1]
    jspec, tspec = _specs(window, form)
    eb_j = JF.make_eb_rows(jnp.asarray(E), jnp.asarray(B))
    eb_t = TF.make_eb_rows(_t(E), _t(B))
    np.testing.assert_array_equal(eb_t.numpy(), np.asarray(eb_j))
    anch_j = JF.block_anchors(jspec, jnp.asarray(st["cell"]))
    anch_t = TF.block_anchors(tspec, _t(st["cell"]))
    np.testing.assert_array_equal(anch_t.numpy(), np.asarray(anch_j))

    args = [st[c] for c in COLS] + [st["weight"]]
    work = st["work"] if "work" in _work_name(tspec) else None
    cj, mj, oj, aj = JF.fused_push_deposit(
        jspec, anch_j, *map(jnp.asarray, args),
        None if work is None else jnp.asarray(work), eb_j, interpret=True,
    )
    ct, mt, ot, at = TF.fused_push_deposit(
        tspec, anch_t, *map(_t, args), None if work is None else _t(work),
        eb_t,
    )
    mj = np.asarray(mj)
    assert mj.sum() > 0 and mj.sum() < mj.size / 2  # misses exercised
    np.testing.assert_array_equal(mt.numpy(), mj, err_msg="miss")
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj),
                                  err_msg="anchors_next")
    np.testing.assert_array_equal(ct["cell"].numpy(), np.asarray(cj["cell"]))
    assert (np.asarray(cj["cell"]) != st["cell"]).any()  # cells shift
    assert ct.keys() == cj.keys()
    for name in COLS[1:] + _work_name(tspec):
        want = np.asarray(cj[name])
        np.testing.assert_allclose(ct[name].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    if not tspec.lite:
        # rows not updated: gh 1 and chi 0, inert in the emission rate
        upd = (np.asarray(cj["cell"]) != st["cell"]) | (
            np.asarray(cj["x"]) != st["x"])
        assert (ct["chi"].numpy()[upd] > 0).all()
        assert (ct["chi"].numpy()[mj > 0] == 0).all()
        assert (ct["gh"].numpy()[mj > 0] == 1).all()
    oj = np.asarray(oj)
    if tspec.dep_skip:
        assert ot is None and not oj.any()
        return
    assert np.abs(oj).max() > 0
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-5 * np.abs(oj).max(), err_msg="out")

    # the fold of the tap slab into (J, rho): the same gather and sums
    Jj, rj = JF.fold_out_slab(jnp.asarray(oj))
    Jt, rt = TF.fold_out_slab(_t(oj))
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-6,
                               atol=1e-7 * np.abs(np.asarray(Jj)).max())
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6,
                               atol=1e-7 * np.abs(np.asarray(rj)).max())


def test_deposit_into_slab():
    """Fallback rows deposit into the tap slab; rows outside the deposit
    reach deposit nothing.  JAX contracts a one-hot matrix, the port
    scatter-adds: within 1e-5 of the slab's largest entry."""
    rng = np.random.default_rng(2)
    n = 64
    row = rng.integers(0, N_ROWS, n).astype(np.int32)
    x = rng.random(n)
    prev_x = x + rng.uniform(-0.9, 0.9, n)
    q = np.full(n, -1.6e-12)
    vel = rng.normal(0.0, 1e7, (n, 3))
    slab = rng.normal(0.0, 1.0, (N_ROWS, 16)).astype(np.float32)
    sj = JF.deposit_into_slab(
        jnp.asarray(slab), *(jnp.asarray(a, jnp.float32)
                             for a in (row, x, prev_x, q, vel)), DX, DT,
    )
    st = TF.deposit_into_slab(
        _t(slab), _t(row), *(_t(np.float32(a)) for a in (x, prev_x, q, vel)),
        DX, DT,
    )
    sj = np.asarray(sj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0,
                               atol=1e-5 * np.abs(sj).max())


@pytest.mark.parametrize("variant", [
    "threads=128", "segments=2", "threads=1024,segments=32", "minblocks=3",
    "nosum", "noother", "cheaptaps"])
def test_kernel_variant_edits_apply(variant):
    """``kernel_variants.py``'s edits still find what they change in the
    kernel source, each once; an unknown edit is refused."""
    import kernel_variants as KV

    src = (KV.ROOT / KV.SOURCE).read_text()
    out = KV.edit(src, variant)
    assert out != src
    for e in variant.split(","):
        name, _, value = e.partition("=")
        if name in KV.CONSTANTS:
            assert f"constexpr int {KV.CONSTANTS[name]} = {value};" in out
    with pytest.raises(ValueError):
        KV.edit(src, variant + ",unrolled")


@pytest.mark.parametrize("capacity", [4, 64])
def test_misfit_compact(capacity):
    """Index table and overflow count equal, with and without
    overflow."""
    rng = np.random.default_rng(4)
    miss = (rng.random(1024) < 0.01).astype(np.float32)
    tj, oj = JF.misfit_compact(jnp.asarray(miss), capacity)
    tt, ot = TF.misfit_compact(_t(miss), capacity)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert int(ot) == int(oj)
    assert (int(ot) > 0) == (capacity < miss.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("window,form,order", CASES)
def test_cuda_kernel_matches_plain(window, form, order):
    """On a card: the CUDA kernel (built without FMA contraction)
    reproduces the plain PyTorch version's push columns (with prev_x, gh
    and chi in the full forms), miss flags and anchors bit for bit; the
    slab within 1e-5 of its largest entry (float atomics add in no fixed
    order), and the forms without the deposit return none.  The block of
    128 rows leaves half of the CTA's threads without a row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st, E, B = _inputs(order=order)
    E, B = E * FORMS[form][-1], B * FORMS[form][-1]
    _, spec = _specs(window, form)
    dev = "cuda"
    eb = TF.make_eb_rows(_t(E, dev), _t(B, dev))
    cell = _t(st["cell"], dev)
    anch = TF.block_anchors(spec, cell)
    args = [_t(st[c], dev) for c in COLS[1:]] + [_t(st["weight"], dev)]
    work = _t(st["work"], dev) if "work" in _work_name(spec) else None
    before = dict(TF.fused_push_deposit.launches)
    ck, mk, ok, ak = TF.fused_push_deposit(spec, anch, cell, *args, work, eb)
    before[TF.form_name(spec)] += 1
    assert TF.fused_push_deposit.launches == before
    cr, mr, orf, ar = TF.fused_push_deposit_reference(
        spec, anch, cell, *args, work, eb
    )
    torch.cuda.synchronize()
    assert torch.equal(mk, mr) and torch.equal(ak, ar)
    for name in cr:
        assert torch.equal(ck[name], cr[name]), name
    if spec.dep_skip:
        assert ok is None and orf is None
        return
    scale = orf.abs().max().item()
    assert (ok - orf).abs().max().item() <= 1e-5 * scale
