"""Quantum synchrotron emission (nonlinear Compton scattering).

The port of ``opal_tpu/qed/emission.py``: the emission rate and the
inverse-CDF sampling of the photon spectrum of ``e -> e + gamma`` in a
strong field (reference ``src/qed/photon_emission.rs``), vectorized
over a batch of emitters with every data-dependent branch written as a
masked select.  As in opal_tpu, CDF inversion is a fixed-count
bisection (:mod:`.pwmci`), and chi above the tables is clamped to their
last entry instead of aborting (``photon_emission.rs:144``).

The arithmetic follows opal_tpu's operation by operation in both
dtypes: the f32 rate uses its relu-kink expansion of the log-log table
in the same summation order, the f64 rate the indexed interpolation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const
from . import pwmci
from . import tables_data as T

_SQRT3 = math.sqrt(3.0)
_TINY = 1.0e-300
#: the f64 guard underflows to 0.0 in f32, defeating the log(0) and
#: divide-by-zero guards
_TINY32 = 1.0e-37


def _tiny(dtype) -> float:
    return _TINY32 if dtype == torch.float32 else _TINY


_VECTORS: dict = {}


def _pick(vec, tidx, dtype):
    """Per-query entry of a small module-level host (T,) table, rounded
    once to ``dtype`` (kept on the device per table, dtype and
    device)."""
    key = (id(vec), dtype, str(tidx.device))
    t = _VECTORS.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(vec), dtype=dtype, device=tidx.device)
        _VECTORS[key] = t
    return t[tidx]


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


_H_LN_CHI = np.ascontiguousarray(T.LN_H_CHI_TABLE[:, 0])
_H_LN_H = np.ascontiguousarray(T.LN_H_CHI_TABLE[:, 1])

_QUANTUM_PREP = pwmci.prepare(T.QUANTUM_CDF_TABLE)
_Q_COEFF = np.ascontiguousarray(T.QUANTUM_CDF_COEFF)
_Q_POWER = np.ascontiguousarray(T.QUANTUM_CDF_POWER)
_Q_FIRST_F = np.ascontiguousarray(_QUANTUM_PREP.f[:, 0])
_Q_LAST_X = np.ascontiguousarray(_QUANTUM_PREP.x[:, -1])

_Y_PREP = pwmci.prepare(T.Y_CDF_TABLE)
_Y_COEFF = np.ascontiguousarray(T.Y_CDF_COEFF)
_Y_POWER = np.ascontiguousarray(T.Y_CDF_POWER)

_Y_INF_PREP = pwmci.prepare(T.Y_INF_TABLE[None])
_CLASSICAL_PREP = pwmci.prepare(T.CLASSICAL_SPECTRUM_TABLE[None])
#: each linear-CDF table's first abscissa and ordinate, per table
_FIRST = {
    id(p): (np.ascontiguousarray(p.x[:, 0]), np.ascontiguousarray(p.f[:, 0]))
    for p in (_Y_PREP, _Y_INF_PREP)
}


def rate(chi, gamma):
    """Quantum synchrotron emission rate per unit (lab) time, 1/s
    (``photon_emission.rs:59-79``): h(chi) analytic below chi = 0.01,
    log-log table interpolation up to 100, a rational fit beyond."""
    chi_safe = torch.clamp(chi, min=_tiny(chi.dtype))

    h_small = (5.0 * math.pi / 3.0) * (1.0 - 8.0 * chi / (5.0 * _SQRT3))

    big = torch.clamp(chi, min=100.0)
    cbrt = torch.pow(big, 1.0 / 3.0)
    cbrt2 = cbrt ** 2
    h_large = -1019.4661473121777 + 1786.716527650374 * cbrt2
    h_large = 1750.6263395722715 + cbrt2 * h_large
    h_large = -2260.1819695887225 + cbrt * h_large
    h_large = 0.00296527643253334 * h_large / big ** 2

    index = (torch.log(chi_safe) - float(_H_LN_CHI[0])) / T.DELTA_LN_CHI
    index = torch.clamp(index, 0.0, _H_LN_CHI.shape[0] - 1.0 - 1e-12)
    if chi.dtype == torch.float32:
        # linear interpolation on uniform knots as a relu-kink sum,
        # f(x) = H0 + s0 x + sum_k (s_k - s_{k-1}) relu(x - k), added in
        # opal_tpu's order with its f32 coefficients
        ln_h = float(np.float32(_H_LN_H[0])) + float(
            np.float32(_H_LN_H[1] - _H_LN_H[0])) * index
        slopes = np.diff(_H_LN_H)
        for k, dk in enumerate(np.diff(slopes), start=1):
            ln_h = ln_h + float(np.float32(dk)) * torch.clamp(
                index - float(k), min=0.0)
    else:
        lo = torch.clamp(torch.floor(index).long(), 0, _H_LN_CHI.shape[0] - 2)
        w = index - lo
        ln_h = ((1.0 - w) * _pick(_H_LN_H, lo, chi.dtype)
                + w * _pick(_H_LN_H, lo + 1, chi.dtype))
    h_mid = torch.exp(ln_h)

    h = torch.where(chi < 0.01, h_small,
                    torch.where(chi >= 100.0, h_large, h_mid))
    return (_SQRT3 * const.ALPHA_FINE * chi * h
            / (2.0 * math.pi * gamma * const.COMPTON_TIME))


def classical_rate(chi, gamma):
    """Classical synchrotron rate, 1/s (``photon_emission.rs:82-85``)."""
    h = 5.0 * math.pi / 3.0
    return (_SQRT3 * const.ALPHA_FINE * chi * h
            / (2.0 * math.pi * gamma * const.COMPTON_TIME))


def _quantum_cdf_problem(tidx, ln_r):
    return (_QUANTUM_PREP, tidx, ln_r)


def _quantum_cdf_finish(tidx, ln_r, inv, ok):
    """ln(u) with cdf(ln u; chi_tidx) = ln_r: the power-law continuation
    below the table and the clip above (``photon_emission.rs:149-164``),
    around the inversion ``(inv, ok)``."""
    dt_ = ln_r.dtype
    coeff = _pick(_Q_COEFF, tidx, dt_)
    power = _pick(_Q_POWER, tidx, dt_)
    powerlaw = (ln_r - torch.log(coeff)) / power
    return torch.where(ln_r <= _pick(_Q_FIRST_F, tidx, dt_), powerlaw,
                       torch.where(ok, inv, _pick(_Q_LAST_X, tidx, dt_)))


def _linear_cdf_setup(global_zero, local_zero, rand, prep, tidx, coeff,
                      power):
    """The part of sampling y > local_zero from a CDF tabulated on
    global_zero < y < inf (``photon_emission.rs:87-121``) that comes
    before its inversion.  Returns (the inversion problem, the state
    :func:`_linear_cdf_finish` needs)."""
    dt_ = local_zero.dtype
    first_x, first_f = (_pick(v, tidx, dt_) for v in _FIRST[id(prep)])
    diff = torch.clamp(local_zero - global_zero, min=0.0)
    r_zero_pl = coeff * diff ** power
    ev, ev_ok = pwmci.evaluate(prep, tidx, local_zero)
    below = local_zero < first_x
    r_zero = torch.where(below, r_zero_pl, ev)
    # local_zero beyond the table's end: return local_zero unchanged
    early_out = torch.logical_and(~below, ~ev_ok)
    r = r_zero + (1.0 - r_zero) * rand
    y_pl = torch.exp(
        (torch.log(torch.clamp(r, min=_tiny(dt_))) - _log(coeff)) / power
    ) + global_zero
    return (prep, tidx, r), (local_zero, first_f, early_out, r, y_pl)


def _linear_cdf_finish(state, inv, inv_ok):
    local_zero, first_f, early_out, r, y_pl = state
    y = torch.where(r <= first_f, y_pl,
                    torch.where(inv_ok, inv, local_zero))
    return torch.where(early_out, local_zero, y)


def _angle_from_z(z, gamma):
    """Polar emission angle from the scaled variable z
    (``photon_emission.rs:198-199``), cos(theta) = NaN read as 1."""
    denom = torch.sqrt(torch.clamp(gamma ** 2 - 1.0, min=_tiny(gamma.dtype)))
    cos_theta = (gamma - z ** (2.0 / 3.0) / (2.0 * gamma)) / denom
    cos_theta = torch.where(torch.isnan(cos_theta), 1.0, cos_theta)
    return torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))


def _classical_setup(rand1, rand2):
    """The classical sampler before its inversion: (the inversion
    problem, the state :func:`_classical_finish` needs)."""
    tiny = _tiny(rand1.dtype)
    arg = (-9.0 + 50.0 * rand2 - 25.0 * rand2 ** 2) / 16.0
    delta = torch.arccos(torch.clamp(arg, -1.0, 1.0))
    denom = torch.clamp(5.0 * (1.0 - rand2), min=tiny)
    z = ((2.0 + 4.0 * torch.cos(delta / 3.0)) / denom) ** 3
    ln_rand = torch.log(torch.clamp(rand1, min=tiny))
    x_small = 1.020377255 * rand1 ** 0.6
    tidx = torch.zeros_like(ln_rand, dtype=torch.long)
    return (_CLASSICAL_PREP, tidx, ln_rand), (z, ln_rand, x_small)


def _classical_finish(chi, gamma, state, inv, ok):
    z, ln_rand, x_small = state
    last_ln_x = float(_CLASSICAL_PREP.x[0, -1])
    x = torch.where(ln_rand < float(_CLASSICAL_PREP.f[0, 0]), x_small,
                    torch.exp(torch.where(ok, inv, last_ln_x)))
    u = 3.0 * chi * x / (2.0 * torch.clamp(z, min=_tiny(chi.dtype)))
    return u * gamma, _angle_from_z(z, gamma)


def classical_sample(chi, gamma, rand1, rand2, rand3):
    """Sample the classical synchrotron spectrum
    (``photon_emission.rs:264-292``).  Returns ``(omega_mc2, theta,
    cphi)``; the classical photon energy is not bounded by the
    electron's."""
    problem, state = _classical_setup(rand1, rand2)
    inv, ok = pwmci.invert(*problem)
    omega, theta = _classical_finish(chi, gamma, state, inv, ok)
    return omega, theta, 2.0 * math.pi * rand3


def sample(chi, gamma, rand1, rand2, rand3):
    """Sample the angularly resolved quantum synchrotron spectrum
    (``photon_emission.rs:129-203``).  Returns ``(omega_mc2, theta,
    cphi)``: the photon energy in m_e c^2, the polar angle about the
    electron momentum and the azimuth.  chi below the tables takes the
    classical sampler with the QED energy correction.

    The six CDF inversions run as two stacked bisections: the photon
    energy's (two chi tables) with the classical fallback's, then the
    angle's (two delta tables and the asymptotic one), which need the
    energy."""
    tiny = _tiny(chi.dtype)
    chi_safe = torch.clamp(chi, min=tiny)
    ln_chi = torch.log(chi_safe)

    # ---- energy: u from r1 = cdf(u; chi), and the classical sampler --
    index = (ln_chi - T.LN_CHI_MIN) / T.LN_CHI_STEP
    n_chi = _Q_COEFF.shape[0]
    idx = torch.clamp(torch.floor(index).long(), 0, n_chi - 2)
    w = torch.clamp(index - idx, 0.0, 1.0)
    ln_r1 = torch.log(torch.clamp(rand1, min=tiny))
    cl_problem, cl_state = _classical_setup(rand1, rand2)
    (q_lo, ok_lo), (q_hi, ok_hi), (cl_inv, cl_ok) = pwmci.invert_many([
        _quantum_cdf_problem(idx, ln_r1),
        _quantum_cdf_problem(idx + 1, ln_r1),
        cl_problem,
    ])
    ln_u_lower = _quantum_cdf_finish(idx, ln_r1, q_lo, ok_lo)
    ln_u_upper = _quantum_cdf_finish(idx + 1, ln_r1, q_hi, ok_hi)
    u = torch.exp((1.0 - w) * ln_u_lower + w * ln_u_upper)

    # ---- angle: y from r2 = cdf(z | u; chi) --------------------------
    beta = 2.0 * u / (3.0 * chi_safe)
    delta = (1.0 + (1.0 + u) ** 2) * beta ** (-2.0 / 3.0) / (1.0 + u)
    didx_f = (torch.log(delta) - T.LN_DELTA_MIN) / T.LN_DELTA_STEP
    n_delta = _Y_COEFF.shape[0]
    # saturate before the integer cast, as XLA's conversion does
    di = torch.nan_to_num(torch.floor(didx_f), nan=0.0).clamp(
        -1.0, float(n_delta)).long()
    inf_mask = di >= n_delta - 1
    di_c = torch.clamp(di, 0, n_delta - 2)
    dw = torch.clamp(didx_f - di_c, 0.0, 1.0)
    gz = delta ** (-1.5)
    dt_ = chi.dtype
    setups = [
        _linear_cdf_setup(gz, beta, rand2, _Y_PREP, di_c,
                          _pick(_Y_COEFF, di_c, dt_),
                          _pick(_Y_POWER, di_c, dt_)),
        _linear_cdf_setup(gz, beta, rand2, _Y_PREP, di_c + 1,
                          _pick(_Y_COEFF, di_c + 1, dt_),
                          _pick(_Y_POWER, di_c + 1, dt_)),
        _linear_cdf_setup(0.0, beta, rand2, _Y_INF_PREP,
                          torch.zeros_like(di_c), T.Y_INF_COEFF,
                          T.Y_INF_POWER),
    ]
    solved = pwmci.invert_many([p for p, _ in setups])
    y_lower, y_upper, y_inf = (
        _linear_cdf_finish(s, inv, ok)
        for (_, s), (inv, ok) in zip(setups, solved)
    )
    y_tab = (1.0 - dw) * y_lower + dw * y_upper
    y = torch.where(inf_mask, y_inf, y_tab)

    z = torch.clamp(y / torch.clamp(beta, min=tiny), min=1.0)
    theta_q = _angle_from_z(z, gamma)
    omega_q = gamma * u / (1.0 + u)

    # ---- classical fallback for chi below the table ------------------
    omega_c, theta_c = _classical_finish(chi, gamma, cl_state, cl_inv, cl_ok)
    omega_c = omega_c * gamma / (gamma + omega_c)  # QED energy correction

    classical = ln_chi <= T.LN_CHI_MIN
    omega = torch.where(classical, omega_c, omega_q)
    theta = torch.where(classical, theta_c, theta_q)
    return omega, theta, 2.0 * math.pi * rand3
