"""The maintenance sort and the edge migration at one periodic device:
opal_tpu's (inside a one-device ``shard_map``, where the ring exchange
is a send to itself) against the port's, at f64 (so the JAX packed
state matrix rounds nothing).

``lax.sort`` is not stable, so sorted states are compared as multisets:
both are lexsorted by (cell, x, ux) before comparing, and each must be
ordered by its sort key.  The edge migration is deterministic on a
given input, so it is compared row by row.  Overflow counts must be
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from opal_tpu import constants as const
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.parallel import migrate as JM
from opal_tpu.species import ParticleState as JState
from opal_tpu_torch.convert import state_from_numpy, to_numpy
from opal_tpu_torch.grid import GridGeometry
from opal_tpu_torch.parallel import migrate as TM
from opal_tpu_torch.species import SpeciesSpec, initialize

pytestmark = pytest.mark.unit

NX, NPC, CAP = 32, 8, 512
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT


def _host_state(seed=0):
    geom = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    st = initialize(
        SpeciesSpec.electron(), geom, NPC,
        density=lambda x: np.full_like(np.asarray(x, float), 20.0),
        ux=lambda x, u, nr: 0.2 * np.sign(u - 0.5) + 0.05 * nr,
        uy=lambda x, u, nr: 0.05 * nr,
        uz=lambda x, u, nr: 0.01 * nr,
        dt=DT, capacity_per_device=CAP, seed=seed, device="cpu",
    )
    return to_numpy(st)


def _jax_state(cols):
    fields = {f.name: None for f in dataclasses.fields(JState)}
    fields.update({k: jnp.asarray(v) for k, v in cols.items()})
    return JState(**fields)


def _one_device(fn, *args):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(),) * len(args), out_specs=P(),
        check_vma=False,
    ))(*args)


def _lexsorted(cols):
    a = cols["alive"]
    order = np.lexsort((cols["ux"][a], cols["x"][a], cols["cell"][a]))
    return {k: v[a][order] for k, v in cols.items()}


def _skey(cols):
    return np.where(cols["alive"], 2 * cols["cell"] + (cols["ux"] > 0), 2**30)


def test_sort_state():
    cols = _host_state()
    rng = np.random.default_rng(1)
    # scramble the rows, as the push and the migration leave them
    perm = rng.permutation(CAP)
    cols = {k: v[perm] for k, v in cols.items()}
    js = jax.jit(lambda s: JM.sort_state(s, NX))(_jax_state(cols))
    ts = TM.sort_state(state_from_numpy(cols, device="cpu"), NX)
    jc = {k: np.asarray(getattr(js, k)) for k in cols}
    tc = to_numpy(ts)
    for c in (jc, tc):
        assert (np.diff(_skey(c)) >= 0).all()
        assert c["alive"][: int(c["alive"].sum())].all()
        np.testing.assert_array_equal(c["cell"][~c["alive"]], NX - 1)
        np.testing.assert_array_equal(c["prev_x"], c["x"])
        np.testing.assert_array_equal(c["chi"], 0.0)
    js, ts = _lexsorted(jc), _lexsorted(tc)
    for k in cols:
        if k in ("gamma",):
            # rebuilt as sqrt(1 + |u|^2): the same f64 formula
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-15, err_msg=k)
        else:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


@pytest.mark.parametrize("send_capacity", [64, 4])
def test_migrate_edges(send_capacity):
    """Leavers on both sides of a sorted state (cells -1 and NX, as a
    push leaves them) re-enter on the other side; with a send capacity
    of 4 some are lost and counted."""
    cols = to_numpy(TM.sort_state(
        state_from_numpy(_host_state(2), device="cpu"), NX))
    alive = cols["alive"]
    left = np.flatnonzero(alive & (cols["cell"] == 0))[:6]
    right = np.flatnonzero(alive & (cols["cell"] == NX - 1))[-5:]
    cols["cell"][left] = -1
    cols["cell"][right] = NX
    jg = JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    tg = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    window = 128

    def dev(st):
        return JM.migrate_edges(st, jg, "x", 0, send_capacity, window)

    js, jovf = _one_device(dev, _jax_state(cols))
    ts, tovf = TM.migrate_edges(state_from_numpy(cols, device="cpu"), tg,
                                send_capacity, window)
    tc = to_numpy(ts)
    assert int(tovf) == int(jovf)
    assert (int(tovf) > 0) == (send_capacity < 6)
    for k in cols:
        np.testing.assert_array_equal(tc[k], np.asarray(getattr(js, k)),
                                      err_msg=k)
    if not int(tovf):
        assert ((tc["cell"] >= 0) & (tc["cell"] < NX))[tc["alive"]].all()
        assert tc["alive"].sum() == alive.sum()
