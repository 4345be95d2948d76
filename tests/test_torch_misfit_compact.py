"""The misfit compaction (``ops.fused.misfit_compact``): its contract on
the plain version here, and the CUDA kernel against the plain version
on a card (the ``cuda`` tests skip without one).

The contract, for every n, capacity and flag pattern: an int64 table of
``capacity`` entries holding the first ``capacity`` flagged rows
(flag > 0.5) in ascending order, ``n`` in each unused entry, and the
overflow max(flagged - capacity, 0) as a 0-d int64.  The flags come as a
contiguous column or as an (nblk, block) view of the packed layout's aux
matrix, which must give the table of its contiguous copy.  Where a
counter is given, the tiles of ``COMPACT_TILE`` rows the kernel reads a
second time are added to it: those with a flag and fewer than
``capacity`` flags before them.  Each expectation is computed here with
numpy.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from opal_tpu_torch import constants as const
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.ops import fused as F
from opal_tpu_torch.sim import SimOptions, Simulation
from opal_tpu_torch.species import SpeciesSpec, initialize

T = F.COMPACT_TILE


def _random(n, k, seed):
    return np.random.default_rng(seed).choice(n, k, replace=False)


#: (n, capacity, flagged rows) of each case
CASES = {
    "no_flag": (3 * T, 64, []),
    "first_row": (3 * T, 64, [0]),
    "last_row": (3 * T, 64, [3 * T - 1]),
    "exactly_capacity": (3 * T, 64, _random(3 * T, 64, 1)),
    "capacity_plus_one": (3 * T, 64, _random(3 * T, 65, 2)),
    "every_row": (3 * T, 64, range(3 * T)),
    "every_row_full_capacity": (2 * T + 5, 2 * T + 5, range(2 * T + 5)),
    "not_a_multiple_of_the_tile": (
        2 * T + 37, 2048, [0, T - 1, T, 2 * T - 1, 2 * T, 2 * T + 36]),
    "capacity_larger_than_n": (100, 2048, [3, 50, 99]),
    "capacity_zero": (T, 0, [5, 6]),
}


def _flags(n, rows):
    miss = np.zeros(n, np.float32)
    miss[np.asarray(list(rows), np.int64)] = 1.0
    return miss


def _expected(miss, capacity, block=None):
    """The table, the overflow and the tiles read again, from numpy."""
    n = miss.size
    hit = np.flatnonzero(miss > 0.5)
    table = np.full(capacity, n, np.int64)
    table[:min(hit.size, capacity)] = hit[:capacity]
    block = n if block is None else block
    tiles = []
    for start in range(0, n, block):
        tiles += [miss[start + off:start + min(off + T, block)]
                  for off in range(0, block, T)]
    c = np.array([(t > 0.5).sum() for t in tiles])
    before = np.cumsum(c) - c
    return table, max(hit.size - capacity, 0), int(((c > 0) &
                                                    (before < capacity)).sum())


def _aux_view(miss, block, dev="cpu"):
    """The flags as the packed layout holds them: column 3 of an (nblk,
    4, block) matrix, an (nblk, block) view with rows 4 * block apart."""
    nblk = miss.size // block
    aux = torch.full((nblk, 4, block), 7.0, device=dev)
    aux[:, 3] = torch.from_numpy(miss.reshape(nblk, block)).to(dev)
    return aux[:, 3]


def _check(got, miss, capacity, block=None):
    table, overflow, counts = got
    want, over, tiles = _expected(miss, capacity, block)
    assert table.dtype == torch.int64 and table.shape == (capacity,)
    assert overflow.dtype == torch.int64 and overflow.dim() == 0
    np.testing.assert_array_equal(table.cpu().numpy(), want)
    assert int(overflow) == over
    assert counts.tolist() == [tiles]


def _compact(fn, miss, capacity):
    counts = torch.zeros(1, dtype=torch.int64, device=miss.device)
    table, overflow = fn(miss, capacity, counts)
    return table, overflow, counts


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_keeps_the_contract(case):
    n, capacity, rows = CASES[case]
    miss = _flags(n, rows)
    _check(_compact(F.misfit_compact, torch.from_numpy(miss), capacity),
           miss, capacity)


@pytest.mark.parametrize("block", [128, T, 2 * T, 3 * T // 2 + 4])
def test_strided_view_gives_its_contiguous_copys_table(block):
    """Blocks shorter than a tile, a tile, two, and one and a half with a
    partial tile a row; flags at each row's ends and at random."""
    nblk = 5
    n = nblk * block
    rows = [0, n - 1, block - 1, block, *_random(n, n // 50, 3)]
    miss = _flags(n, rows)
    view = _aux_view(miss, block)
    assert view.stride(0) == 4 * block
    for capacity in (16, n):
        got = _compact(F.misfit_compact, view, capacity)
        copy = F.misfit_compact(view.contiguous().reshape(-1), capacity)
        assert torch.equal(got[0], copy[0])
        assert torch.equal(got[1], copy[1])
        _check(got, miss, capacity, block)


# ----------------------------------------------------------------------
# On a card
# ----------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(miss_t, capacity):
    """The kernel's result and the plain version's on the same CUDA
    tensor, each with its tile counter."""
    k = _compact(F.misfit_compact, miss_t, capacity)
    p = _compact(F.misfit_compact_reference, miss_t, capacity)
    torch.cuda.synchronize()
    return k, p


def _equal(k, p):
    for a, b in zip(k, p):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(case, dev):
    n, capacity, rows = CASES[case]
    miss = _flags(n, rows)
    before = F.misfit_compact.launches
    k, p = _both(torch.from_numpy(miss).to(dev), capacity)
    assert F.misfit_compact.launches == before + 1
    _equal(k, p)
    _check(k, miss, capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, T, 2 * T, 3 * T // 2 + 4])
def test_kernel_on_strided_view(block, dev):
    nblk = 5
    n = nblk * block
    miss = _flags(n, [0, n - 1, block - 1, block, *_random(n, n // 50, 3)])
    view = _aux_view(miss, block, dev)
    for capacity in (16, n):
        k, p = _both(view, capacity)
        _equal(k, p)
        _check(k, miss, capacity, block)


#: the callers' flag counts: the colliding_beams crossing's electrons,
#: ``bench --qed``'s and the two_stream_128m cell's capacity
SIZES = (75_776, 2_621_440, 147_644_416)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 1e-7, 0.01, 0.5])
@pytest.mark.parametrize("n", SIZES)
def test_kernel_equals_plain_at_random_densities(n, density, dev):
    """Random flags at the callers' sizes, at the fallback's capacity of
    2048 and at the QED callers' capacity, every flagged row."""
    g = torch.Generator(device=dev).manual_seed(n + int(density * 1e7))
    miss = (torch.rand(n, generator=g, device=dev) < density).float()
    total = int((miss > 0.5).sum())
    for capacity in (2048, total):
        k, p = _both(miss, capacity)
        _equal(k, p)
        assert int(k[1]) == max(total - capacity, 0)
    del miss, k, p
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_runs_no_library_op(dev):
    """A call is the kernel's three launches and nothing of the plain
    chain (no compare, cast, cub scan or searchsorted)."""
    miss = torch.from_numpy(_flags(3 * T, [1, 2, T + 5])).to(dev)
    F.misfit_compact(miss, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.misfit_compact(miss, 64)
        torch.cuda.synchronize()
    launched = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]
    assert len(launched) == 3, launched
    for name, want in zip(launched, ("misfit_count", "misfit_scan",
                                     "misfit_scatter")):
        assert want in name, launched


def _deck(dev, packed):
    dx = 500.0
    dt = 0.95 * dx / const.SPEED_OF_LIGHT
    geom = GridGeometry(nx=64, dx=dx, xmin=0.0, n_devices=1)
    sim = Simulation(
        geom, SimOptions(dt=dt, fused_pusher=True, fused_block=128,
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
        dt=dt, capacity_per_device=1536, seed=3, dtype=np.float32,
        work_dtype=np.float32, device=dev)
    return sim, st


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["column", "packed"])
def test_replay_launches_once_a_step_and_reads_nothing(packed, dev):
    """A small fused deck: one compaction a step, and no read of the
    device inside ``Simulation.run`` (after a first run, which makes
    what is made once a device)."""
    sim, st = _deck(dev, packed)
    steps = 24

    def inputs():
        E, B, J, rho = sim.init_fields()
        B[:, 2] = 1e-7  # a gyrating orbit: rows leave their windows
        return (E, B, J, rho, {"electron": st}, 0.0, sim.zero_counters(),
                steps)

    sim.run(*inputs())
    args = inputs()
    torch.cuda.synchronize()
    before = F.misfit_compact.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sim.run(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert F.misfit_compact.launches == before + steps
    assert int(out[6]["electron"]) == 0
