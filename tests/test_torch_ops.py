"""The port's unfused ops against opal_tpu's, at f64.

The same numpy inputs (seeded) go through the JAX op and its PyTorch
counterpart.  Both evaluate the same formulas in f64, so floats agree
to rtol 1e-13; every comparison also allows an absolute 1e-14 of the
array's largest magnitude, for entries that cancel toward zero.
Integer columns must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from opal_tpu import constants as const
from opal_tpu.grid import GridGeometry as JGeom
from opal_tpu.ops import deposit as jdep
from opal_tpu.ops import interp as jinterp
from opal_tpu.ops import maxwell as jmax
from opal_tpu.ops import pusher as jpush
from opal_tpu.parallel import halo as jhalo
from opal_tpu_torch.grid import HALO, GridGeometry
from opal_tpu_torch.ops import deposit as tdep
from opal_tpu_torch.ops import interp as tinterp
from opal_tpu_torch.ops import maxwell as tmax
from opal_tpu_torch.ops import pusher as tpush
from opal_tpu_torch.parallel import halo as thalo

pytestmark = pytest.mark.unit

NX, N = 64, 4096
DX = 500.0
DT = 0.95 * DX / const.SPEED_OF_LIGHT
RTOL = 1e-13


def close(got, want, rtol=RTOL, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=1e-14 * scale, err_msg=err_msg
    )


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def inputs():
    """Particles inside a halo-extended slab of NX + 2 HALO cells with
    fields strong enough to bend the orbits over a step: E ~ 100 V/m
    gives du ~ 0.05, B ~ 1e-6 T a rotation of ~0.1 rad."""
    rng = np.random.default_rng(7)
    n_slab = NX + 2 * HALO
    return dict(
        E=rng.normal(0.0, 100.0, (n_slab, 3)),
        B=rng.normal(0.0, 1e-6, (n_slab, 3)),
        J=rng.normal(0.0, 1e-3, (n_slab, 3)),
        cell=rng.integers(0, NX, N).astype(np.int32),
        x=rng.random(N),
        prev_x=rng.random(N) + rng.uniform(-0.9, 0.9, N),
        u=rng.normal(0.0, 0.4, (N, 3)),
        y=rng.normal(0.0, 1.0, N),
        z=rng.normal(0.0, 1.0, N),
        work=rng.normal(0.0, 1e-20, N),
        q=np.where(rng.random(N) < 0.9, -1.6e-19 * 1e7, 0.0),
    )


def test_weight_and_flux(inputs):
    rng = np.random.default_rng(1)
    xi = rng.uniform(-3.0, 3.0, 4096)
    xf = xi + rng.uniform(-1.0, 1.0, 4096)
    xi[:4] = [0.0, -0.0, 1.0, -1.0]
    xf[:4] = [-0.0, 0.0, 0.5, -1.5]
    close(tinterp.weight(t(xi)), jinterp.weight(jnp.asarray(xi)))
    close(tinterp.flux(t(xi), t(xf)), jinterp.flux(jnp.asarray(xi),
                                                   jnp.asarray(xf)))


def test_fields_at(inputs):
    d = inputs
    idx = d["cell"] + HALO
    Ej, Bj = jinterp.fields_at(jnp.asarray(d["E"]), jnp.asarray(d["B"]),
                               jnp.asarray(idx), jnp.asarray(d["x"]))
    Et, Bt = tinterp.fields_at(t(d["E"]), t(d["B"]), t(idx), t(d["x"]))
    close(Et, Ej, err_msg="E")
    close(Bt, Bj, err_msg="B")


def test_vay_push(inputs):
    """tau is skipped by the port (QED rate not ported): the JAX push
    gets tau = inf, for which its decrement is a no-op."""
    d = inputs
    idx = d["cell"] + HALO
    Ej, Bj = jinterp.fields_at(jnp.asarray(d["E"]), jnp.asarray(d["B"]),
                               jnp.asarray(idx), jnp.asarray(d["x"]))
    gamma = np.sqrt(1.0 + np.sum(d["u"] ** 2, axis=1))
    rj = jpush.vay_push(
        jnp.asarray(d["cell"]), jnp.asarray(d["x"]), jnp.asarray(d["y"]),
        jnp.asarray(d["z"]), jnp.asarray(d["u"]), jnp.asarray(gamma),
        jnp.full(N, jnp.inf), jnp.asarray(d["work"]), Ej, Bj, DX, DT,
    )
    rt = tpush.vay_push(
        t(d["cell"]), t(d["x"]), t(d["y"]), t(d["z"]), t(d["u"]), t(gamma),
        None, t(d["work"]), t(np.asarray(Ej)), t(np.asarray(Bj)), DX, DT,
    )
    np.testing.assert_array_equal(rt.cell.numpy(), np.asarray(rj.cell))
    assert (np.asarray(rj.cell) != d["cell"]).any()  # some rows cross
    for name in ("x", "prev_x", "y", "z", "u", "gamma", "chi", "work"):
        close(getattr(rt, name), getattr(rj, name), err_msg=name)
    assert rt.tau is None
    chi_t = tpush.electron_chi(
        rt.u[:, 0], rt.u[:, 1], rt.u[:, 2], rt.gamma,
        t(np.asarray(Ej)), t(np.asarray(Bj)),
    )
    chi_j = jpush.electron_chi(
        rj.u[:, 0], rj.u[:, 1], rj.u[:, 2], rj.gamma, Ej, Bj
    )
    close(chi_t, chi_j, err_msg="electron_chi")


@pytest.mark.parametrize(
    "reference", ["deposit", "deposit_sorted", "deposit_onehot"]
)
def test_deposit(inputs, reference):
    """Scatter order differs from JAX's scatter, from the sorted
    segmented sums and from the one-hot contraction: J and rho agree
    within 1e-12 of their maxima.  Against the scatter, cells reach 3
    past each slab edge so the drop guard of out-of-slab taps is
    exercised; the other two drop whole out-of-slab particles instead,
    so there cells stay inside."""
    d = inputs
    rng = np.random.default_rng(3)
    reach = 3 if reference == "deposit" else 0
    idx = rng.integers(-reach, NX + 2 * HALO + reach, N).astype(np.int32)
    vel = const.SPEED_OF_LIGHT * d["u"] / np.sqrt(
        1.0 + np.sum(d["u"] ** 2, axis=1)
    )[:, None]
    J0 = np.zeros((NX + 2 * HALO, 3))
    rho0 = np.zeros(NX + 2 * HALO)
    fn = getattr(jdep, reference)
    Jj, rj = fn(jnp.asarray(J0), jnp.asarray(rho0), jnp.asarray(idx),
                jnp.asarray(d["x"]), jnp.asarray(d["prev_x"]),
                jnp.asarray(d["q"]), jnp.asarray(vel), DX, DT)
    Jt, rt = tdep.deposit(t(J0), t(rho0), t(idx), t(d["x"]), t(d["prev_x"]),
                          t(d["q"]), t(vel), DX, DT)
    Jj, rj = np.asarray(Jj), np.asarray(rj)
    np.testing.assert_allclose(Jt.numpy(), Jj, rtol=0,
                               atol=1e-12 * np.abs(Jj).max())
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0,
                               atol=1e-12 * np.abs(rj).max())


def test_maxwell_advance(inputs):
    d = inputs
    n_slab = NX + 2 * HALO
    mask = np.arange(n_slab) == 0
    Ej, Bj = jmax.advance(jnp.asarray(d["E"]), jnp.asarray(d["B"]),
                          jnp.asarray(d["J"]), DT, DX, jnp.asarray(mask))
    Et, Bt = tmax.advance(t(d["E"]), t(d["B"]), t(d["J"]), DT, DX, t(mask))
    close(Et, Ej, err_msg="E")
    close(Bt, Bj, err_msg="B")


def test_halo_one_device(inputs):
    """The ring exchange/fold at one device (ppermute to itself) is a
    local wrap/fold: equal bit for bit."""
    d = inputs
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    jg = JGeom(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    tg = GridGeometry(nx=NX, dx=DX, xmin=0.0, n_devices=1)
    E, B = d["E"][:NX], d["B"][:NX]
    rho = d["J"][:, 0]

    def dev(E, B, J, rho):
        Es, Bs = jhalo.exchange_fields(E, B, jg, "x", 0)
        Jf, rf = jhalo.fold_currents(J, rho, jg, "x", 0)
        return Es, Bs, Jf, rf

    out = jax.jit(jax.shard_map(
        dev, mesh=mesh, in_specs=(P(),) * 4, out_specs=(P(),) * 4,
        check_vma=False,
    ))(jnp.asarray(E), jnp.asarray(B), jnp.asarray(d["J"]), jnp.asarray(rho))
    Es, Bs = thalo.exchange_fields(t(E), t(B), tg)
    Jf, rf = thalo.fold_currents(t(d["J"]), t(rho), tg)
    for got, want, name in zip((Es, Bs, Jf, rf), out, "EBJr"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
