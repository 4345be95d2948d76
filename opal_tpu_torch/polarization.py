"""Photon polarization state and observables (``opal_tpu/polarization.py``;
reference ``src/particle/photon.rs:24-25, 277-302``).

``pol`` is an (N, 4) real tensor ``[re a1, im a1, re a2, im a2]``, the
complex Jones vector over the two transverse basis vectors of ``basis``,
an (N, 6) tensor ``[e1 | e2]``.  A stimulated-emission copy inherits
both from its seed photon (``interactions.absorb``).
"""

from __future__ import annotations

import dataclasses

import torch

from .species import ParticleState

_TINY = 1.0e-300


def _normalize(v):
    n = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                               min=_TINY))
    return v / n


def _require_pol(state: ParticleState, basis=True):
    if state.pol is None or (basis and state.basis is None):
        raise ValueError("species does not carry polarization state")


def with_polarization_along(state: ParticleState, direction) -> ParticleState:
    """Linearly polarize every photon along ``direction`` (a (3,) or
    (N, 3) array, not necessarily normalized; ``photon.rs:277-286``):
    ``basis[0] = dir / |dir|``, ``basis[1] = (k x basis[0]) / |.|`` so
    that (k, e1, e2) is right-handed; Jones vector (1, 0)."""
    _require_pol(state)
    n = state.pol.shape[0]
    dtype, dev = state.pol.dtype, state.pol.device
    e1 = _normalize(torch.as_tensor(direction, dtype=dtype, device=dev))
    e1 = torch.broadcast_to(e1, (n, 3))
    e2 = _normalize(torch.linalg.cross(state.u.to(dtype), e1))
    basis = torch.cat([e1, e2], dim=1)
    pol = torch.zeros((n, 4), dtype=dtype, device=dev)
    pol[:, 0] = 1.0
    return dataclasses.replace(state, pol=pol, basis=basis)


def linear_polarization_along(state: ParticleState, direction):
    """|polarization component along ``direction``|^2 per photon
    (``photon.rs:290-294``); ``direction`` is normalized first."""
    _require_pol(state)
    d = _normalize(torch.as_tensor(direction, dtype=state.pol.dtype,
                                   device=state.pol.device))
    d1 = torch.sum(d * state.basis[:, 0:3], dim=-1)
    d2 = torch.sum(d * state.basis[:, 3:6], dim=-1)
    re = state.pol[:, 0] * d1 + state.pol[:, 2] * d2
    im = state.pol[:, 1] * d1 + state.pol[:, 3] * d2
    return re * re + im * im


def helicity(state: ParticleState):
    """|a+|^2 with a+ = (a1 - i a2)/sqrt(2) (``photon.rs:299-302``), the
    photon's ``spin_state`` (``photon.rs:141-147``)."""
    _require_pol(state, basis=False)
    re1, im1, re2, im2 = (state.pol[:, i] for i in range(4))
    # a1 - i a2 = (re1 + im2) + i (im1 - re2)
    re = re1 + im2
    im = im1 - re2
    return 0.5 * (re * re + im * im)
