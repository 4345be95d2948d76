"""Binary-interaction cross sections: one-photon absorption
(gamma + e -> e) and stimulated emission (gamma + e -> e + 2 gamma) in
a background field (``opal_tpu/qed/cross_sections.py``; reference
``src/qed/photon_absorption.rs:17-35``,
``src/qed/stimulated_emission.rs:18-38``).

Each returns ``(sigma, valid)``; ``valid`` replaces the reference's
``Option``: invalid pairs (non-positive chi, kinematically forbidden
stimulated emission, Airy argument out of range) give sigma = 0.  They
compute in the inputs' dtype (f64 in the parity tests and the f64
decks).
"""

from __future__ import annotations

import math

import torch

from .. import constants as const
from .airy import airy_ai


def _tiny(dtype) -> float:
    """Divide guard by dtype: 1e-300 underflows to 0.0 in f32."""
    return 1.0e-37 if dtype == torch.float32 else 1.0e-300


_PREF = (2.0 * math.pi * const.CLASSICAL_ELECTRON_RADIUS) ** 2 / const.ALPHA_FINE


def _as(k, *xs):
    """``xs`` as tensors of ``k``'s dtype and device (numbers too)."""
    return (torch.as_tensor(x, dtype=k.dtype, device=k.device) for x in xs)


def _scaled_cross_section(k, p, chi_gamma, chi_e, sign):
    """The common form; ``sign`` is +1 for absorption, -1 for stimulated
    emission (which replaces chi_e + chi_gamma by chi_e - chi_gamma)."""
    p, chi_gamma, chi_e = _as(k, p, chi_gamma, chi_e)
    k0, kx, ky, kz = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    p0, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    tiny = _tiny(k0.dtype)

    chi_sum = chi_e + sign * chi_gamma
    denom = torch.clamp(chi_e * chi_sum, min=tiny)
    g = 0.5 + 0.25 * chi_gamma**2 / denom
    z = (torch.clamp(chi_gamma, min=tiny) / denom) ** (2.0 / 3.0)
    k_p = k0 * p0 - kx * px - ky * py - kz * pz
    zbar = 2.0 * z * chi_e * k_p / torch.clamp(chi_gamma, min=tiny)
    # the k0 p0 form keeps it positive (photon_absorption.rs:26)
    zbar_z = 2.0 * p0 * k_p / torch.clamp(k0, min=tiny)

    ai, ai_valid = airy_ai(zbar)
    sigma = (
        _PREF * chi_e * z * (4.0 * g * zbar_z - 1.0) * ai
        / torch.clamp(chi_gamma * k0 * p0, min=tiny)
    )
    valid = (chi_e > 0.0) & (chi_gamma > 0.0) & ai_valid
    if sign < 0:
        # an electron cannot emit a photon with more energy than itself
        # (stimulated_emission.rs:20)
        valid = valid & (chi_gamma < chi_e) & (k0 < p0)
    return torch.where(valid, sigma, torch.zeros_like(sigma)), valid


def photon_absorption(k, p, chi_gamma, chi_e):
    """Scaled absorption cross section sigma k.p / (k0 p0); ``k``/``p``
    are normalized four-momenta of shape (..., 4).  The absorption
    probability is ``w_e (c dt / dx) sigma``."""
    return _scaled_cross_section(k, p, chi_gamma, chi_e, +1)


def stimulated_emission(k, p, chi_gamma, chi_e):
    """Scaled stimulated-emission cross section, same convention."""
    return _scaled_cross_section(k, p, chi_gamma, chi_e, -1)


def pair_cross_sections(k, p, chi_gamma, chi_e):
    """Both scaled cross sections of one pair, sharing the kinematic
    invariants (k.p, the k0 p0 form and the guards): the absorption walk
    evaluates both on every (photon, candidate) pair.  Returns
    ``(sigma_abs, sigma_st)``, each 0 where its branch is invalid."""
    p, chi_gamma, chi_e = _as(k, p, chi_gamma, chi_e)
    k0, kx, ky, kz = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    p0, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    tiny = _tiny(k0.dtype)
    k_p = k0 * p0 - kx * px - ky * py - kz * pz
    zbar_z = 2.0 * p0 * k_p / torch.clamp(k0, min=tiny)
    chig_safe = torch.clamp(chi_gamma, min=tiny)
    twoz_chi = 2.0 * chi_e * k_p / chig_safe  # zbar = z * this
    inv_k0p0 = _PREF * chi_e / torch.clamp(chi_gamma * k0 * p0, min=tiny)

    out = []
    for sign in (1.0, -1.0):
        chi_sum = chi_e + sign * chi_gamma
        denom = torch.clamp(chi_e * chi_sum, min=tiny)
        g = 0.5 + 0.25 * chi_gamma**2 / denom
        z = (chig_safe / denom) ** (2.0 / 3.0)
        ai, ai_valid = airy_ai(z * twoz_chi)
        sigma = z * (4.0 * g * zbar_z - 1.0) * ai * inv_k0p0
        valid = (chi_e > 0.0) & (chi_gamma > 0.0) & ai_valid
        if sign < 0:
            valid = valid & (chi_gamma < chi_e) & (k0 < p0)
        out.append(torch.where(valid, sigma, torch.zeros_like(sigma)))
    return out[0], out[1]
